"""Tests that need an NVIDIA GPU (``gpu`` marker; they skip elsewhere).

Run on the card:  CHALKYDRI_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
This module imports nothing beyond the package, numpy and chip_smoke's
numpy renderer, so it runs where OpenCV is absent.
"""

import importlib

import jax
import numpy as np
import pytest


@pytest.mark.gpu
class TestOnGpu:
    def test_fused_step_matches_cpu_and_truth(self, gpu_device):
        """The fused step compiled for the GPU finds the rendered tags
        within the corner gate, and gives the CPU's ids, valid flags and
        tag counts with corners and poses within float32 noise."""
        import jax.numpy as jnp

        from chalkydri_tpu.geometry.field_layout import load_field_layout
        from chalkydri_tpu.pipeline import (
            build_rig_from_config,
            make_vision_pipeline,
        )

        cs = importlib.import_module("chip_smoke")
        tags = cs.load_tags()
        batch, h, w, fx = 1, 800, 1280, 900.0  # chip_smoke's first geometry
        frames, truth = cs.render_field_frames(tags, batch, h, w, fx)
        gyro = np.array([t["yaw"] for t in truth], np.float32)
        outs = []
        for dev in (gpu_device, jax.devices("cpu")[0]):
            with jax.default_device(dev):
                layout = load_field_layout(cs.FIELD_JSON, dtype=jnp.float32)
                params, rc = build_rig_from_config(
                    cs.rig_cameras(batch, h, w, fx), layout)
                step = make_vision_pipeline(layout, params, rc)
                outs.append(cs.host(step(jax.device_put(frames, dev),
                                         jax.device_put(gyro, dev))))
        g, c = outs
        truth_err = cs.compare_to_truth(g, truth)
        assert truth_err["corner_px"] < cs.TOL["corner_vs_truth_px"][0]
        gap = cs.compare_outputs(g, c)
        assert gap["corner_px"] < cs.TOL["corner_gpu_vs_cpu_px"][0]
        assert gap["xy_m"] < cs.TOL["pose_xy_gpu_vs_cpu_m"][0]
        assert gap["yaw_rad"] < cs.TOL["pose_yaw_gpu_vs_cpu_rad"][0]
