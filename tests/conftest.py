"""Test configuration.

Tests run on the CPU with a virtual 8-device mesh, so the multi-device
sharding code paths (jax.sharding.Mesh + shard_map) are exercised without
an accelerator. f64 is enabled so parity tests against the reference's f64
semantics are meaningful; float32 device behavior is tested explicitly with
tolerances.

Tests that need the GPU carry the ``gpu`` marker and skip elsewhere. Run
them on a machine with the card, where JAX keeps its default platform:

    CHALKYDRI_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
"""

import os
import sys

_platform = os.environ.get("CHALKYDRI_TEST_PLATFORM", "cpu")
if _platform == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if _platform == "cpu":
    # Also covers a JAX imported before this file (e.g. by a plugin).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX has none")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none (decided
    when the test runs, never at import or collection)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with CHALKYDRI_TEST_PLATFORM=gpu "
                    "on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def reference_field_json():
    """Path to a WPILib-schema 2026 field layout: the reference's own
    ``field.json`` when the read-only mount is present, else the in-tree
    example layout (examples/field_2026.json — same schema and dimensions,
    so the suite is self-contained without the reference mounted)."""
    path = os.path.join(REFERENCE_DIR, "field.json")
    if not os.path.exists(path):
        path = os.path.join(
            os.path.dirname(__file__), "..", "examples", "field_2026.json"
        )
    return os.path.abspath(path)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
