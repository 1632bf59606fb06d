"""Spatially-sharded detector stages with explicit halo exchange.

Device mapping of the reference's intra-frame parallelism (rayon over pixel
columns + sketched chunked-row cluster merging,
``/root/reference/crates/chalkydri-apriltags/src/lib.rs:301-308,555-613``,
SURVEY.md sections 2.4 item 2 and 5.7): frame ROWS are sharded across the
``space`` mesh axis; local-stencil stages (adaptive threshold) compute on
their row block plus a halo of neighbor rows fetched with
``jax.lax.ppermute`` — the ring-neighbor-exchange structure of sequence
parallelism, applied to the image dimension.

Used for frames too large to stage per-chip (e.g. megapixel multi-camera
stacks); validated against the unsharded stage on a virtual CPU mesh in
tests/test_sharding.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from chalkydri_tpu.detector.threshold import MIN_WHITE_BLACK_DIFF, TILE, _tile_minmax

# Halo needed by the threshold stage: the 3x3 tile neighborhood reaches one
# 4-pixel tile into each neighbor's rows.
HALO_ROWS = TILE


def _exchange_halo(block: jax.Array, axis_name: str) -> jax.Array:
    """Concatenate neighbors' boundary rows around the local row block.

    block: [B, Hl, W] (local rows). Returns [B, Hl + 2*HALO, W] with edge
    clamping at the global top/bottom.
    """
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)

    top_rows = block[:, :HALO_ROWS, :]  # my top rows -> neighbor above wants them? no:
    bot_rows = block[:, -HALO_ROWS:, :]

    # Receive the block above's BOTTOM rows (shift downward: src i -> dst i+1)
    from_above = jax.lax.ppermute(
        bot_rows, axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    # Receive the block below's TOP rows (shift upward: src i -> dst i-1)
    from_below = jax.lax.ppermute(
        top_rows, axis_name, [(i, (i - 1) % n) for i in range(n)]
    )

    # Edge clamping: shard 0 has no above-neighbor; clamp with its own top
    # row replicated (matches the unsharded reduce_window edge padding).
    clamp_top = jnp.broadcast_to(block[:, :1, :], from_above.shape)
    clamp_bot = jnp.broadcast_to(block[:, -1:, :], from_below.shape)
    from_above = jnp.where(idx == 0, clamp_top, from_above)
    from_below = jnp.where(idx == n - 1, clamp_bot, from_below)

    return jnp.concatenate([from_above, block, from_below], axis=1)


def _threshold_block(gray_ext: jax.Array, min_diff: int) -> jax.Array:
    """Threshold the extended block, returning only the core rows."""
    tmin, tmax = _tile_minmax(gray_ext)

    def nbhd(x, op):
        init = jnp.iinfo(jnp.uint8).max if op == "min" else 0
        fn = jax.lax.min if op == "min" else jax.lax.max
        return jax.lax.reduce_window(
            x, jnp.asarray(init, x.dtype), fn,
            window_dimensions=(1, 3, 3), window_strides=(1, 1, 1),
            padding=((0, 0), (1, 1), (1, 1)),
        )

    tmin = nbhd(tmin, "min")
    tmax = nbhd(tmax, "max")
    pmin = jnp.repeat(jnp.repeat(tmin, TILE, axis=1), TILE, axis=2)
    pmax = jnp.repeat(jnp.repeat(tmax, TILE, axis=1), TILE, axis=2)
    contrast = pmax - pmin
    thresh = pmin.astype(jnp.uint16) + contrast.astype(jnp.uint16) // 2
    is_white = gray_ext.astype(jnp.uint16) > thresh
    tern = jnp.where(is_white, jnp.uint8(255), jnp.uint8(0))
    tern = jnp.where(contrast < min_diff, jnp.uint8(127), tern)
    return tern[:, HALO_ROWS:-HALO_ROWS, :]


def _seam_row_min(row_lab, row_val, n_lab, n_val):
    """Neighbor-min of one boundary label row against the FACING
    neighbor row: 4-conn for any same ternary value, diagonals white
    only — THE seam connectivity rule of ``label_components_block``.
    Rows are [B, 1, W]; invalid (127)
    pixels never merge (their labels are INVALID on both sides anyway).
    """
    from chalkydri_tpu.detector.segment import INVALID

    m = row_lab
    valid = row_val != 127
    white = row_val == 255
    for dx in (0, 1, -1):
        nl = jnp.roll(n_lab, dx, axis=2) if dx else n_lab
        nv = jnp.roll(n_val, dx, axis=2) if dx else n_val
        if dx == 1:
            nl = nl.at[:, :, :1].set(INVALID)
            nv = nv.at[:, :, :1].set(jnp.uint8(127))
        elif dx == -1:
            nl = nl.at[:, :, -1:].set(INVALID)
            nv = nv.at[:, :, -1:].set(jnp.uint8(127))
        same = (nv == row_val) & valid
        if dx != 0:
            same = same & white
        m = jnp.minimum(m, jnp.where(same, nl, INVALID))
    return m


def label_components_block(block: jax.Array, hl: int, w: int,
                           iters: int, axis_name: str = "space") -> jax.Array:
    """CCL over one shard's row block [B, hl, w] with per-round seam
    exchange over ``axis_name`` — the reusable body of
    ``sharded_label_components``, also inlined by the fused spatial
    pipeline (parallel/pipeline.py)."""
    from chalkydri_tpu.detector.segment import (
        INVALID,
        _connectivity_masks,
        _neighbor_min,
        _segmented_min_scan,
    )

    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    row0 = idx * hl  # global row offset of this shard

    valid = block != 127
    local_rows = jax.lax.broadcasted_iota(jnp.int32, (1, hl, w), 1)
    local_cols = jax.lax.broadcasted_iota(jnp.int32, (1, hl, w), 2)
    flat = (local_rows + row0) * w + local_cols
    labels = jnp.where(valid, flat, INVALID)

    masks = _connectivity_masks(block, valid)

    # Value halos are round-invariant: fetch neighbors' boundary value
    # rows once.
    def fetch(rows, direction):
        # direction +1: receive from the shard ABOVE (their bottom row).
        perm = [(i, (i + direction) % n) for i in range(n)]
        return jax.lax.ppermute(rows, axis_name, perm)

    val_above = fetch(block[:, -1:, :], +1)  # row h-1 of shard idx-1
    val_below = fetch(block[:, :1, :], -1)  # row 0 of shard idx+1
    # Edge shards have no neighbor: poison with 'skip' so no merge.
    val_above = jnp.where(idx == 0, jnp.uint8(127), val_above)
    val_below = jnp.where(idx == n - 1, jnp.uint8(127), val_below)

    top_val = block[:, :1, :]
    bot_val = block[:, -1:, :]

    def seam_min(lab):
        """Min labels across the shard seams (4-conn + white diagonals —
        the shared _seam_row_min rule)."""
        lab_above = fetch(lab[:, -1:, :], +1)
        lab_below = fetch(lab[:, :1, :], -1)
        lab_above = jnp.where(idx == 0, INVALID, lab_above)
        lab_below = jnp.where(idx == n - 1, INVALID, lab_below)
        top = _seam_row_min(lab[:, :1, :], top_val, lab_above, val_above)
        bot = _seam_row_min(lab[:, -1:, :], bot_val, lab_below, val_below)
        return jnp.concatenate([top, lab[:, 1:-1, :], bot], axis=1)

    def body(_, lab):
        lab = seam_min(lab)
        lab = _neighbor_min(lab, masks)
        lab = _segmented_min_scan(lab, block, axis=2)
        lab = _segmented_min_scan(lab, block, axis=1)
        return jnp.where(valid, lab, INVALID)

    return jax.lax.fori_loop(0, iters, body, labels)


def sharded_label_components(
    tern: jax.Array, mesh: Mesh, iters: int = 16
) -> jax.Array:
    """Connected-component labeling with frame ROWS sharded over 'space'.

    The inter-tile merge structure SURVEY.md section 5.7 calls for: each
    round, shards exchange their boundary label rows with both neighbors
    (ppermute — the ring-neighbor-exchange of sequence parallelism), take
    the neighbor-min across the seam, then propagate locally (row scans
    are exact — rows are complete within a shard; column information crosses
    one shard boundary per round). With enough rounds the result equals the
    single-device labeling bit for bit (asserted in tests/test_sharding.py).

    Labels stay globally meaningful: each shard offsets its flat indices by
    its global row offset.
    """
    n_space = mesh.shape["space"]
    b, h, w = tern.shape
    hl = h // n_space
    spec = P("data", "space", None)

    @partial(jax.shard_map, mesh=mesh, in_specs=spec, out_specs=spec)
    def run(block):
        return label_components_block(block, hl, w, iters)

    return run(tern)


def sharded_adaptive_threshold(
    gray: jax.Array, mesh: Mesh, min_diff: int = MIN_WHITE_BLACK_DIFF
) -> jax.Array:
    """Adaptive threshold with rows sharded over the 'space' mesh axis and
    batch over 'data'; halo rows ride ppermute. Semantically identical to
    ``detector.threshold.adaptive_threshold``."""
    n_space = mesh.shape["space"]
    assert gray.shape[1] % (n_space * TILE) == 0, "rows must split into tiles"

    spec = P("data", "space", None)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=spec,
        out_specs=spec,
    )
    def run(block):
        ext = _exchange_halo(block, "space")
        return _threshold_block(ext, min_diff)

    return run(gray)
