"""Matmul-precision control.

A float32 matmul without an explicit precision may run at reduced
precision: on the GPU, XLA may lower it to TF32 tensor-core math (10-bit
mantissa), and other backends default to bf16. Geometry/solver math (3x3
rotations, camera models, 9x9/15x15 solver systems) needs full f32 — with
reduced-precision products the solved robot pose degrades from ~2e-5 m to
decimetres (tests/test_detector.py forces bf16 matmuls on the CPU to pin
the homography path). Every geometry/solver entry point is
wrapped with ``highest_precision``; the cost is negligible because those
matrices are tiny.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Force HIGHEST (full f32) matmul precision while tracing ``fn``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
