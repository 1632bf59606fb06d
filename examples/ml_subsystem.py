"""Example ML-subsystem model: on-device game-piece (bright disk) finder.

The reference reserved a Coral Edge TPU + TFLite slot for exactly this kind
of auxiliary inference (``MlSubsys {}`` config slot,
``chalkydri_core/src/config.rs:101-102``); here the "ML accelerator" is the
same device the vision pipeline runs on, and a model is just a jitted callable
(subsystems/ml.py). This example is a non-learned but genuinely useful
model: multi-scale normalized template matching for a circular game piece
(FRC balls/disks), built on ``lax.conv`` so the heavy work lands on the matrix units.

Use it from a graph node:

    (id: "ml", type: "MlSubsys", config: {"model": "examples.ml_subsystem:model"})

or run this file directly for a self-contained demo:

    python examples/ml_subsystem.py
"""

from __future__ import annotations

import numpy as np

RADII = (12, 20, 32)  # template radii in pixels (multi-scale)


def _disk_kernel(radius: int):
    """Zero-mean disk template: +1 inside the disk, ring-normalized."""
    import jax.numpy as jnp

    side = 2 * radius + 1
    y, x = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disk = (x * x + y * y <= radius * radius).astype(np.float32)
    disk -= disk.mean()  # zero-mean: responds to contrast, not brightness
    disk /= np.sqrt((disk * disk).sum()) + 1e-6
    return jnp.asarray(disk.reshape(1, 1, side, side))


def model(frame):
    """frame [H, W] u8 (or [B, H, W]) -> {"x", "y", "radius", "score"}.

    Multi-scale zero-mean disk correlation; returns the best match per
    frame. All arrays; host code pulls scalars.
    """
    import jax
    import jax.numpy as jnp

    squeeze = frame.ndim == 2
    if squeeze:
        frame = frame[None]
    x = frame.astype(jnp.float32)[:, None]  # NCHW

    best_score = None
    best = None
    for r in RADII:
        k = _disk_kernel(r)
        resp = jax.lax.conv_general_dilated(
            x, k, window_strides=(1, 1), padding="SAME"
        )[:, 0]  # [B, H, W]
        flat = resp.reshape(resp.shape[0], -1)
        idx = jnp.argmax(flat, axis=-1)
        score = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]
        yy = idx // resp.shape[-1]
        xx = idx % resp.shape[-1]
        cand = (xx.astype(jnp.float32), yy.astype(jnp.float32),
                jnp.full_like(score, float(r)), score)
        if best is None:
            best, best_score = cand, score
        else:
            take = score > best_score
            best = tuple(jnp.where(take, c, b) for c, b in zip(cand, best))
            best_score = jnp.maximum(score, best_score)

    out = {"x": best[0], "y": best[1], "radius": best[2], "score": best[3]}
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out


def main():
    import jax

    # synthetic scene: noisy background + one bright disk
    rng = np.random.default_rng(7)
    frame = rng.normal(120, 12, (480, 640)).astype(np.float32)
    yy, xx = np.mgrid[:480, :640]
    cx, cy, r = 417, 203, 21
    frame[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = 230
    frame = np.clip(frame, 0, 255).astype(np.uint8)

    fn = jax.jit(model)
    out = fn(frame)
    print(
        f"true disk: ({cx}, {cy}) r={r}; "
        f"found: ({float(out['x']):.0f}, {float(out['y']):.0f}) "
        f"r={float(out['radius']):.0f} score={float(out['score']):.1f}"
    )


if __name__ == "__main__":
    main()
