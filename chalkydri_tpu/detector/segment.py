"""Stage 2: connected-component labeling (CCL) by scan-based label
propagation.

The reference's detectors both use pointer-chasing union-find for
segmentation: libapriltag's unionfind (via apriltag-sys) and the custom
detector's raw-pointer ``UnionFind``
(``/root/reference/crates/chalkydri-apriltags/src/lib.rs:42-113,501-549``).
Pointer-chasing is serial. This module's data-parallel formulation
avoids pointer *jumping* as well (it needs frame-sized random gathers) and
uses only shifts and scans, which XLA fuses into dense passes. So the
propagation here is gather-free:

- every non-'skip' pixel starts with its own flat index as label,
- each round: (a) min label over connected neighbors (same binary value;
  8-connectivity for white pixels, 4-connectivity for black, mirroring
  libapriltag's merge rule) — pure shifts, (b) segmented min-SCANS along
  rows and columns (associative scans that reset at run boundaries), which
  move labels across an entire straight run in one pass.

Convergence: each round propagates labels around at least one "corner" of a
blob, and scans cover unlimited straight distance, so rounds needed ~ the
blob's turn count. Tag borders (rings: 4-8 turns) and natural backgrounds
converge in <= 8 rounds; validated against scipy.ndimage in
tests/test_detector.py with a convergence-check helper.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Label value for 'skip' (127) pixels: larger than any flat index.
INVALID = jnp.iinfo(jnp.int32).max

DEFAULT_ITERS = 8


def _shift2d(x: jax.Array, dy: int, dx: int, fill) -> jax.Array:
    """Shift a [B, H, W] array by (dy, dx), filling vacated cells."""
    out = x
    if dy:
        out = jnp.roll(out, dy, axis=1)
        if dy > 0:
            out = out.at[:, :dy, :].set(fill)
        else:
            out = out.at[:, dy:, :].set(fill)
    if dx:
        out = jnp.roll(out, dx, axis=2)
        if dx > 0:
            out = out.at[:, :, :dx].set(fill)
        else:
            out = out.at[:, :, dx:].set(fill)
    return out


# Neighbor offsets: 4-connectivity for all pixels; diagonals only merge white
# pixels (mirrors libapriltag's do_unionfind_line2: v==255 also connects
# up-left / up-right).
_OFFSETS_ALL = ((0, 1), (0, -1), (1, 0), (-1, 0))
_OFFSETS_WHITE = ((1, 1), (1, -1), (-1, 1), (-1, -1))

# NOTE (round-4 revert): an attempt to drop the 4-conn offsets from the
# per-round neighbor-min on the argument that the row/col segmented scans
# subsume them was WRONG — the scans reset at value-run boundaries, so a
# same-value 4-conn neighbor across a 1-pixel jog is NOT guaranteed to be
# reached within the same iteration budget, and label propagation slows
# enough to miss convergence on real scenes (aruco corpus fell 84/84 ->
# 72/84 matches and the full-res clean-tag scene dropped 133 candidates).
# The neighbor-min must keep all 8 offsets.


def _segmented_min_scan(labels: jax.Array, val: jax.Array, axis: int) -> jax.Array:
    """Min-scan labels along ``axis``, resetting where the binary value
    changes (runs of equal value share their minimum). Bidirectional."""

    def combine(a, b):
        av, ab = a
        bv, bb = b
        v = jnp.where(bb, bv, jnp.minimum(av, bv))
        return v, ab | bb

    def boundary_mask(shift_dir: int):
        # True where a new run starts, scanning in the given direction.
        boundary = jnp.ones_like(val, dtype=bool)
        same = val == jnp.roll(val, shift_dir, axis=axis)
        idx = [slice(None)] * val.ndim
        idx[axis] = slice(1, None) if shift_dir > 0 else slice(None, -1)
        boundary = boundary.at[tuple(idx)].set(~same[tuple(idx)])
        return boundary

    fwd, _ = jax.lax.associative_scan(
        combine, (labels, boundary_mask(1)), axis=axis
    )
    bwd, _ = jax.lax.associative_scan(
        combine, (labels, boundary_mask(-1)), axis=axis, reverse=True
    )
    return jnp.minimum(fwd, bwd)


def _connectivity_masks(val: jax.Array, valid: jax.Array):
    """Per-offset same-value connectivity masks. These are invariant across
    propagation rounds — computing them once (instead of re-shifting and
    comparing the value image every round) cuts the round cost materially."""
    masks = []
    is_white = val == 255
    for dy, dx in _OFFSETS_ALL:
        nv = _shift2d(val, dy, dx, jnp.uint8(127))
        masks.append(((dy, dx), (nv == val) & valid))
    for dy, dx in _OFFSETS_WHITE:
        nv = _shift2d(val, dy, dx, jnp.uint8(127))
        masks.append(((dy, dx), (nv == val) & valid & is_white))
    return masks


def _neighbor_min(labels: jax.Array, masks) -> jax.Array:
    m = labels
    for (dy, dx), same in masks:
        nl = _shift2d(labels, dy, dx, INVALID)
        m = jnp.minimum(m, jnp.where(same, nl, INVALID))
    return m


@partial(jax.jit, static_argnames=("iters",))
def label_components(tern: jax.Array, iters: int = DEFAULT_ITERS) -> jax.Array:
    """Label connected components of the ternary image.

    Args:
      tern: [B, H, W] uint8 in {0, 127, 255} from ``adaptive_threshold``.
      iters: propagation rounds (each: neighbor-min + row scan + col scan).

    Returns:
      labels: [B, H, W] int32 — flat-index labels, INVALID on skip pixels.
      Two pixels share a label iff they're in the same blob (once converged).
    """
    b, h, w = tern.shape
    flat_idx = jnp.arange(h * w, dtype=jnp.int32).reshape(1, h, w)
    valid = tern != 127
    labels = jnp.where(valid, flat_idx, INVALID)
    val = tern
    masks = _connectivity_masks(val, valid)

    def body(_, lab):
        lab = _neighbor_min(lab, masks)
        lab = _segmented_min_scan(lab, val, axis=2)
        lab = _segmented_min_scan(lab, val, axis=1)
        return jnp.where(valid, lab, INVALID)

    labels = jax.lax.fori_loop(0, iters, body, labels)
    return labels


def label_components_step(tern: jax.Array, labels: jax.Array) -> jax.Array:
    """One propagation round (for convergence checking in tests)."""
    valid = tern != 127
    lab = _neighbor_min(labels, _connectivity_masks(tern, valid))
    lab = _segmented_min_scan(lab, tern, axis=2)
    lab = _segmented_min_scan(lab, tern, axis=1)
    return jnp.where(valid, lab, INVALID)


def labels_converged(tern, labels) -> bool:
    """Test helper: true if one more round would not change any label."""
    after = label_components_step(tern, labels)
    return bool(jnp.all(after == labels))
