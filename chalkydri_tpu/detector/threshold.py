"""Stage 1: adaptive (tile-local min/max) thresholding.

Batched equivalent of libapriltag's ``threshold()`` (consumed by the
reference via apriltag-sys, SURVEY.md section 2.3) and of the custom
detector's windowed adaptive threshold
(``/root/reference/crates/chalkydri-apriltags/src/lib.rs:191-259``):

- split the image into 4x4 tiles; compute per-tile min and max,
- dilate/erode the tile extrema over a 3x3 tile neighborhood (so the
  threshold varies smoothly and tags straddling tiles survive),
- classify every pixel into {0 (black), 255 (white), 127 (skip)} — a pixel is
  'skip' when its tile's local contrast max-min is below
  ``min_white_black_diff`` (the ternary {Black, White, Other} classification
  of ``chalkydri-apriltags``'s threshold, lib.rs:319-334).

The whole stage is elementwise + small stencils: XLA fuses it into a couple of
dense passes over the frame.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

TILE = 4
MIN_WHITE_BLACK_DIFF = 5  # libapriltag default min contrast per tile


def _tile_minmax(gray: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-4x4-tile min/max. gray: [B, H, W] uint8 (H, W multiples of TILE)."""
    b, h, w = gray.shape
    t = gray.reshape(b, h // TILE, TILE, w // TILE, TILE)
    return t.min(axis=(2, 4)), t.max(axis=(2, 4))


def _neighborhood3(x: jax.Array, op: str) -> jax.Array:
    """3x3 min/max over the tile grid [B, th, tw] with edge clamping."""
    if op == "min":
        init, fn = jnp.iinfo(jnp.uint8).max, jax.lax.min
    else:
        init, fn = 0, jax.lax.max
    return jax.lax.reduce_window(
        x,
        jnp.asarray(init, x.dtype),
        fn,
        window_dimensions=(1, 3, 3),
        window_strides=(1, 1, 1),
        padding=((0, 0), (1, 1), (1, 1)),
    )


@partial(jax.jit, static_argnames=("min_diff",))
def adaptive_threshold(gray: jax.Array, min_diff: int = MIN_WHITE_BLACK_DIFF):
    """Ternary-threshold a batch of grayscale frames.

    Args:
      gray: [B, H, W] uint8, H and W multiples of 4 (the runtime pads frames
        to tile multiples before staging them on device).
      min_diff: minimum tile contrast to classify (else 'skip').

    Returns:
      tern: [B, H, W] uint8 in {0, 127, 255}.
    """
    assert gray.ndim == 3, "expected [B, H, W]"
    b, h, w = gray.shape
    assert h % TILE == 0 and w % TILE == 0, "pad frames to 4-pixel multiples"

    tmin, tmax = _tile_minmax(gray)
    tmin = _neighborhood3(tmin, "min")
    tmax = _neighborhood3(tmax, "max")

    # Upsample tile stats back to pixel resolution.
    pmin = jnp.repeat(jnp.repeat(tmin, TILE, axis=1), TILE, axis=2)
    pmax = jnp.repeat(jnp.repeat(tmax, TILE, axis=1), TILE, axis=2)

    contrast = pmax - pmin
    # thresh = min + (max - min) / 2, computed in uint16 to avoid overflow.
    thresh = pmin.astype(jnp.uint16) + contrast.astype(jnp.uint16) // 2

    is_white = gray.astype(jnp.uint16) > thresh
    tern = jnp.where(is_white, jnp.uint8(255), jnp.uint8(0))
    tern = jnp.where(contrast < min_diff, jnp.uint8(127), tern)
    return tern
