"""Device mesh + sharding helpers.

The reference is single-node with per-camera task parallelism (SURVEY.md
section 2.4); the device design maps:

- cameras/frames -> the ``data`` mesh axis (pure data parallelism: frames are
  independent),
- image rows -> the ``space`` mesh axis for the stencil-heavy early stages
  (threshold, CCL) of frames too large for one device's memory budget —
  the sequence-parallel analogue called for in SURVEY.md section 5.7, with
  halo exchange over the device interconnect (jax.lax.ppermute) instead of the reference's
  shared-memory rayon chunks.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, space: int = 1) -> Mesh:
    """Build a ('data', 'space') mesh over the first n devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    assert n_devices <= len(devs), f"need {n_devices} devices, have {len(devs)}"
    assert n_devices % space == 0
    grid = np.array(devs[:n_devices]).reshape(n_devices // space, space)
    return Mesh(grid, ("data", "space"))


def frame_sharding(mesh: Mesh, spatial: bool = False) -> NamedSharding:
    """[B, H, W] frames: batch over 'data'; rows over 'space' if requested."""
    return NamedSharding(mesh, P("data", "space" if spatial else None, None))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[B, ...] per-frame tensors: batch over 'data', rest replicated."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
