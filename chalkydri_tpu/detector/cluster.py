"""Stage 3: gradient clustering — black/white boundary points grouped by
(black blob, white blob) pair.

Mirrors libapriltag's gradient_clusters() (consumed by the reference via
apriltag-sys, SURVEY.md section 2.3): every edge between a black pixel and a
white pixel contributes a boundary point at the doubled-coordinate edge
midpoint with a gradient direction; points are grouped by the *pair* of
component labels on either side, so each tag border yields one cluster.

Accelerator re-design (fixed shapes, and no large scatters/gathers: a
sort over the compacted candidates does the grouping that libapriltag's
hash map does one point at a time):

- candidate edges are enumerated densely (4 directions x H x W masks),
- each candidate's position+direction is PACKED into one int32 payload,
- a BLOCK-SPARSE compaction keeps only the 128-candidate blocks that actually
  contain boundary candidates (edges are spatially sparse: a few thousand
  points in a 512k-candidate grid), shrinking the sort input ~8x — per-block
  popcounts + top-k block selection + one small gather, no scatters,
- one lexicographic 2-key ``lax.sort`` orders the surviving candidates by
  (black label, white label), with invalid candidates keyed to INT32_MAX so
  they sink to the tail — sorting IS the grouping,
- the sorted array is run-length segmented with scans, and the top-K
  segments by population become the cluster set,
- a stencil "speckle gate" (both sides of an edge must have >= 2
  same-valued 8-neighbors) replaces libapriltag's union-find blob-size gate:
  same purpose (keep noise blobs from crowding the capacity), no
  scatter-add.

Capacities (MAX_CLUSTERS, MAX_CLUSTER_POINTS, MAX_EDGE_POINTS) are static;
overflow drops points from the largest-label clusters first.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

MAX_EDGE_POINTS = 1 << 16  # per frame, after sorting/compaction
# (halving to 2^15 drops the noisy-corpus tag at 640x480 — capacity is a
# robustness parameter, not a speed dial)
MAX_CLUSTERS = 64  # candidate quads per frame
MAX_CLUSTER_POINTS = 128  # boundary points kept per cluster (stride-subsampled)
MIN_CLUSTER_POINTS = 24  # smaller clusters can't be a tag border
MIN_SAME_NEIGHBORS = 2  # speckle gate (see module docstring)
# Compaction keeps COMPACT_SLACK * max_points/128 ranked blocks per frame
# (split over the two directions); the kept rows are what the cluster
# sort pays for, so this is the sort-width / robustness dial. See
# compact_candidates for the measured history. Round-4 note: a 2 -> 1.5
# cut was tried and REVERTED — it drops 133 candidates on the full-res
# (1304x1600, quad_decimate=1) clean-tag scene the capacity test pins
# (tests/test_detector.py::TestAdversarialCapacity), i.e. the zero-drop
# margin is gone even with orientation-aligned blocking. 2x stays.
COMPACT_SLACK = 2

_INT_MAX = jnp.iinfo(jnp.int32).max


class Clusters(NamedTuple):
    # Per cluster, per point: x, y in pixel coords; gx, gy gradient.
    # CHANNEL-FIRST layout [4, K, P] = (x, y, gx, gy): each channel is a
    # contiguous [K, P] plane, so no size-4 minor axis is materialized.
    points: jax.Array  # [4, K, P] float32 (x, y, gx, gy)
    mask: jax.Array  # [K, P] bool
    count: jax.Array  # [K] int32 (true population, may exceed P)
    valid: jax.Array  # [K] bool (count >= MIN_CLUSTER_POINTS)
    dropped: jax.Array  # [] int32 — boundary candidates lost to capacity
    #   compaction this frame (0 in benign scenes; nonzero = the capacity
    #   degradation mode is ACTIVE and visible to soak/telemetry)


# Edge directions (dy, dx). libapriltag walks four (incl. diagonals); we
# enumerate right+down only: every black/white boundary also meets those two
# axes (diagonal-only contacts sit at staircase corners whose faces already
# contribute), and halving the candidate count halves the dominant sort cost.
_DIRS = ((0, 1), (1, 0))


def _shift(x, dy, dx, fill):
    out = x
    if dy:
        out = jnp.roll(out, -dy, axis=0)
        out = out.at[-dy:, :].set(fill) if dy > 0 else out.at[:-dy, :].set(fill)
    if dx:
        out = jnp.roll(out, -dx, axis=1)
        out = out.at[:, -dx:].set(fill) if dx > 0 else out.at[:, :-dx].set(fill)
    return out


def _same_neighbor_count(tern: jax.Array) -> jax.Array:
    """For each pixel, how many of its 8 neighbors share its ternary value."""
    count = jnp.zeros(tern.shape, jnp.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nv = _shift(tern, dy, dx, jnp.uint8(127))
            count = count + (nv == tern)
    return count


def _pack_payload(x2, y2, dir_idx, p_is_white):
    """Pack (x2: 13 bits, y2: 13 bits, dir: 1 bit, side: 1 bit) into int32."""
    return (
        (x2 & 0x1FFF)
        | ((y2 & 0x1FFF) << 13)
        | ((dir_idx & 0x3) << 26)
        | (jnp.where(p_is_white, 1, 0) << 28)
    ).astype(jnp.int32)


def _unpack_payload(p):
    x2 = p & 0x1FFF
    y2 = (p >> 13) & 0x1FFF
    dir_idx = (p >> 26) & 0x3
    p_white = (p >> 28) & 0x1
    return x2, y2, dir_idx, p_white


def extract_boundary_points(
    tern: jax.Array,
    labels: jax.Array,
    halo_top: int = 0,
    halo_bottom: int = 0,
    y_offset: int | jax.Array = 0,
):
    """Dense boundary-point enumeration for ONE frame (or one row shard).

    Returns (black_lab, white_lab, payload) each [2*H*W] int32; invalid
    candidates have black_lab == white_lab == INT32_MAX.

    For the row-sharded multi-chip path, ``tern``/``labels`` are a shard's
    core rows EXTENDED with ``halo_top`` neighbor rows above and
    ``halo_bottom`` below (the solidity stencil reaches 1 row, and a core
    last-row down-edge needs the below-neighbor's solidity, i.e. 2 rows
    down): candidates are emitted ONLY for core pixels, with ``y_offset``
    (the shard's global core row origin) making packed y coordinates and
    the emitted candidate set globally identical to an unsharded run.
    """
    h, w = tern.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    core = (ys >= halo_top) & (ys < h - halo_bottom)
    ys_global = ys - halo_top + y_offset
    solid = _same_neighbor_count(tern) >= MIN_SAME_NEIGHBORS

    blacks, whites, payloads = [], [], []
    for di, (dy, dx) in enumerate(_DIRS):
        nv = _shift(tern, dy, dx, jnp.uint8(127))
        nl = _shift(labels, dy, dx, jnp.int32(0))
        nsolid = _shift(solid, dy, dx, False)
        pair_sum = tern.astype(jnp.int32) + nv.astype(jnp.int32)
        is_edge = (pair_sum == 255) & solid & nsolid & core
        p_is_white = tern == 255
        black_lab = jnp.where(p_is_white, nl, labels)
        white_lab = jnp.where(p_is_white, labels, nl)
        black_lab = jnp.where(is_edge, black_lab, _INT_MAX)
        white_lab = jnp.where(is_edge, white_lab, _INT_MAX)
        payload = _pack_payload(2 * xs + dx, 2 * ys_global + dy, di, p_is_white)
        blacks.append(black_lab.reshape(-1))
        whites.append(white_lab.reshape(-1))
        payloads.append(payload.reshape(-1))
    cat = jnp.concatenate
    return cat(blacks), cat(whites), cat(payloads)


BOOST_DILATE = 2  # rows/cols of both-direction adjacency tolerance
BOOST_SCORE = 256  # > max per-block count (128): boosted beats any density


def _dilate_vec(v: jax.Array, d: int = BOOST_DILATE) -> jax.Array:
    """OR a boolean [..., n] vector with its +-d shifts (edge fill False)."""
    out = v
    zeros = jnp.zeros_like(v[..., :1])
    for k in range(1, d + 1):
        z = jnp.concatenate([zeros] * k, axis=-1) if k > 1 else zeros
        out = (out
               | jnp.concatenate([v[..., k:], z], axis=-1)
               | jnp.concatenate([z, v[..., :-k]], axis=-1))
    return out


def direction_boosts(has0: jax.Array, has1: jax.Array):
    """Both-direction adjacency tests for the block ranking, per axis.

    ``has0``/``has1``: dense [..., H, W] bools — a boundary candidate is
    present at this pixel in dir 0 (right pair / vertical edge) / dir 1
    (down pair / horizontal edge). Returns (both_col [..., W],
    both_row [..., H]): this column/row is within BOOST_DILATE of
    candidates in BOTH directions.

    Tag borders and their data-cell interiors have edges in both
    directions within a couple of pixels; straight texture stripes do not
    (a horizontal stripe's boundary rows emit only down-edges, and its
    column span emits right-edges only at stripe ENDS). Blocks on a
    boosted row (dir-1 blocks are row-aligned) or column (dir-0 blocks
    are column-aligned) outrank any unboosted density, so a tag's edges
    survive a full-frame one-directional flood — the round-2 capacity
    cliff (VERDICT item 7, tests/test_detector.py TestAdversarialCapacity).
    """
    row0, row1 = has0.any(axis=-1), has1.any(axis=-1)
    col0, col1 = has0.any(axis=-2), has1.any(axis=-2)
    both_row = _dilate_vec(row0) & _dilate_vec(row1)
    both_col = _dilate_vec(col0) & _dilate_vec(col1)
    return both_col, both_row


def rank_blocks(counts: jax.Array, boost: jax.Array, cap: int) -> jax.Array:
    """Top (cap/128/n_dirs) block indices for ONE direction by
    count + boost score, ties broken by block index (lax.top_k semantics).
    Shared by the single-device compaction below and the spatially-sharded
    globally-consistent reconstruction in parallel/pipeline.py — the two
    must agree bit for bit.

    counts: [..., nb] per-block candidate counts; boost: [..., nb] bool.
    The boost applies only to OCCUPIED blocks — a boosted row/column also
    crosses empty blocks, and scoring those above occupied unboosted
    blocks evicts real candidates (measured: at 1x slack even a clean
    full-res 4-tag scene lost tags to empty boosted blocks).
    """
    k = max(1, min(cap // 128 // len(_DIRS), counts.shape[-1]))
    score = counts + jnp.where(boost & (counts > 0), BOOST_SCORE, 0)
    _, idx = jax.lax.top_k(score, k)
    return idx


def _ceil128(n: int) -> int:
    return -(-n // 128) * 128


def _compact_blocks(black, white, payload, cap, width):
    """Block-sparse compaction: keep the highest-ranked 128-candidate
    blocks per direction (most blocks carry no boundary candidates at all
    — tags cover a small fraction of the frame). Returns (black, white,
    payload, dropped), arrays of length ~cap and the count of valid
    candidates lost to the block drop (0 when occupied blocks fit).

    Blocking is ORIENTATION-ALIGNED per direction: dir 0 (right pairs —
    candidates lie along VERTICAL edges) blocks the TRANSPOSED page
    [W, ceil128(H)] so a vertical edge's ~H candidates pack into ~H/128
    column blocks instead of one sparse candidate per 128-block of a
    row-major layout; dir 1 (down pairs — horizontal edges) blocks the
    row-major page [H, ceil128(W)]. Row-major blocking for BOTH
    directions was the round-3 full-resolution capacity cliff: four clean
    140 px tags at 1600x1304 quad_decimate=1 occupied ~1100 right-dir
    blocks at 1-2 candidates each and real tag blocks fell off the
    2x-slack budget (a tag silently dropped with nothing else in the
    scene). Aligned blocking packs the same edges ~64x denser, so
    occupancy scales with candidate count rather than edge length.

    Each direction's page pads its minor axis to a 128 multiple so blocks
    never straddle rows/columns; pad slots carry INT_MAX labels (zero
    payload) and sink in the downstream sort exactly like dropped-block
    slots. The selected blocks move as whole 128-element rows (one
    row gather per block, not one gather per element). See
    ``rank_blocks`` / ``direction_boosts`` for the ranking rationale.
    """
    n = black.shape[0]
    n_dirs = len(_DIRS)
    seg = n // n_dirs  # per-direction candidate segment (h*w)
    w = width
    h = seg // w
    assert h * w == seg, "candidate segment must factor as height x width"
    hp, wp = _ceil128(h), _ceil128(w)

    def pages(x, fill):
        p0 = x[:seg].reshape(h, w)
        p1 = x[seg:].reshape(h, w)
        p0t = jnp.pad(p0.T, ((0, 0), (0, hp - h)), constant_values=fill)
        p1p = jnp.pad(p1, ((0, 0), (0, wp - w)), constant_values=fill)
        return p0t.reshape(-1, 128), p1p.reshape(-1, 128)

    b0, b1 = pages(black, _INT_MAX)
    w0, w1 = pages(white, _INT_MAX)
    p0, p1 = pages(payload, jnp.int32(0))

    has0 = black[:seg].reshape(h, w) != _INT_MAX
    has1 = black[seg:].reshape(h, w) != _INT_MAX
    both_col, both_row = direction_boosts(has0, has1)
    # dir-0 block (x, rb) sits on column x; dir-1 block (r, cb) on row r.
    boost0 = jnp.broadcast_to(both_col[:, None], (w, hp // 128)).reshape(-1)
    boost1 = jnp.broadcast_to(both_row[:, None], (h, wp // 128)).reshape(-1)

    counts0 = (b0 != _INT_MAX).sum(axis=1)
    counts1 = (b1 != _INT_MAX).sum(axis=1)
    idx0 = rank_blocks(counts0, boost0, cap)
    idx1 = rank_blocks(counts1, boost1, cap)
    dropped = (
        counts0.sum() + counts1.sum()
        - counts0[idx0].sum() - counts1[idx1].sum()
    )
    # Whole-block row gathers over [nb, 128].
    kept = tuple(
        jnp.concatenate([x0[idx0], x1[idx1]]).reshape(-1)
        for x0, x1 in ((b0, b1), (w0, w1), (p0, p1))
    )
    return (*kept, dropped.astype(jnp.int32))


def take_rows(tables: jax.Array, idx: jax.Array) -> jax.Array:
    """Per-row gather ``tables[b][idx[b]]``: tables [B, n], idx [B, ...]
    int32 in [0, n) (callers clip)."""
    return jax.vmap(lambda t, i: t[i])(tables, idx)


SEGMENT_CHUNK = 128  # run starts compete for the top-2 slots per chunk


def segment_stats(s_key: jax.Array, s_payload: jax.Array):
    """Run-length statistics of ONE frame's sorted candidate keys [n].

    Returns ``(t, cand_len, cand_pos)``: ``t`` is the inclusive cumsum of
    the direction-0 indicator over valid candidates [n]; ``cand_len`` /
    ``cand_pos`` [2 * ceil(n / SEGMENT_CHUNK)] are the per-chunk top-2
    runs by length (each run start scored with its run length; ties go to
    the first index), the first winners of every chunk before the second
    winners. Two winners per chunk guard against two large runs starting
    in one chunk without a top_k over all n rows.
    """
    n = s_key.shape[0]
    s_valid = s_key != _INT_MAX
    prev_key = jnp.concatenate([jnp.array([-1], jnp.int32), s_key[:-1]])
    new_seg = s_key != prev_key

    idx = jnp.arange(n, dtype=jnp.int32)
    # run start position for every element: forward cummax of starts
    start_pos = jax.lax.cummax(jnp.where(new_seg, idx, -1))
    # next run start AFTER every element: reverse cummin of starts
    nxt = jnp.where(new_seg, idx, _INT_MAX)
    next_start = jax.lax.cummin(nxt, reverse=True)
    next_start = jnp.concatenate([next_start[1:], jnp.array([n], jnp.int32)])
    next_start = jnp.minimum(next_start, n)
    run_len = next_start - start_pos
    score = jnp.where(new_seg & s_valid, run_len, 0)
    d0_all = ((((s_payload >> 26) & 0x3) == 0) & s_valid).astype(jnp.int32)
    t = jnp.cumsum(d0_all)

    chunk = SEGMENT_CHUNK
    pad = (-n) % chunk
    if pad:
        score = jnp.concatenate([score, jnp.zeros((pad,), score.dtype)])
    n_chunks = score.shape[0] // chunk
    grid = score.reshape(n_chunks, chunk)
    m1 = grid.max(axis=1)
    a1 = grid.argmax(axis=1).astype(jnp.int32)
    col = jax.lax.broadcasted_iota(jnp.int32, (n_chunks, chunk), 1)
    grid2 = jnp.where(col == a1[:, None], 0, grid)
    m2 = grid2.max(axis=1)
    a2 = grid2.argmax(axis=1).astype(jnp.int32)
    base = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    return (t, jnp.concatenate([m1, m2]),
            jnp.concatenate([base + a1, base + a2]))


# The (black, white) pair hash is HASH_BITS wide; the rest of a 32-bit
# fused sort key holds the frame index, so ONE lax.sort orders a whole
# batch instead of one sort per frame under vmap. 26 hash bits support
# batches up to 16 frames per fused sort with the prefix still a positive
# int32; larger batches chunk.
HASH_BITS = 26
_HASH_MASK = (1 << HASH_BITS) - 1  # doubles as the per-frame sentinel
_FUSED_BATCH_MAX = 16


def cluster_candidates_batched(
    black: jax.Array,
    white: jax.Array,
    payload: jax.Array,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
    dropped=None,
) -> Clusters:
    """Group (possibly compacted) boundary candidates into clusters for a
    BATCH of frames ([B, n] inputs, leading batch dim on every output):
    one fused sort -> per-frame run-length segment -> top-K -> window-gather
    tail. Shared by the single-device path (``gradient_clusters`` /
    make_detector) and the spatially-sharded path (parallel/pipeline.py),
    whose globally-consistent compaction hands it a bitwise-identical
    candidate array.

    The sort is CANONICAL — lexicographic (frame | hash, payload) with
    num_keys=2, and payload is unique per candidate — so each frame's
    sorted segment (and everything downstream) is a pure function of that
    frame's candidate SET, independent of batch size, batch position, or
    compaction block order. That is what keeps the sharded path (local
    batch = per-shard frames) bit-identical to the single-device path
    (local batch = all frames) in the integer detection fields."""
    b = black.shape[0]
    if b > _FUSED_BATCH_MAX:  # chunk oversized batches through the fused path
        parts = [
            cluster_candidates_batched(
                black[i:i + _FUSED_BATCH_MAX],
                white[i:i + _FUSED_BATCH_MAX],
                payload[i:i + _FUSED_BATCH_MAX],
                max_points=max_points, max_clusters=max_clusters,
                cluster_points=cluster_points, min_points=min_points,
                dropped=None if dropped is None
                else dropped[i:i + _FUSED_BATCH_MAX],
            )
            for i in range(0, b, _FUSED_BATCH_MAX)
        ]
        return jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *parts)

    # --- group by (black, white) via ONE fused 2-key sort over a 26-bit
    # multiply-xor hash of the pair, frame index in the high bits.
    # Grouping only needs a consistent order; the label values are never
    # used after grouping. Colliding pairs would merge two clusters; with
    # ~50 real pairs per frame and a 2^26 space that is ~2e-5 per frame
    # (libapriltag's u64 hashmap accepts the same class of risk,
    # apriltag.c gradient_clusters via zhash) ----------------------------
    invalid = black == _INT_MAX
    key = (
        black * jnp.int32(-1640531527)  # 0x9E3779B1 (wrapping)
    ) ^ (white * jnp.int32(-2048144789))  # 0x85EBCA6B
    key = key & _HASH_MASK
    # _HASH_MASK is reserved as the per-frame invalid sentinel (it must
    # sort to the frame's tail, INSIDE the frame's segment).
    key = jnp.where(key == _HASH_MASK, _HASH_MASK - 1, key)
    key = jnp.where(invalid, _HASH_MASK, key)
    fused = key | (jnp.arange(b, dtype=jnp.int32) << HASH_BITS)[:, None]
    sf_key, sf_payload = jax.lax.sort(
        (fused.reshape(-1), payload.reshape(-1)),
        dimension=0, is_stable=False, num_keys=2,
    )
    # Frame prefixes dominate the key, so each frame's rows land in its own
    # contiguous segment at a FIXED offset: reshape recovers the batch.
    s_key = sf_key.reshape(b, -1) & _HASH_MASK
    s_key = jnp.where(s_key == _HASH_MASK, _INT_MAX, s_key)
    s_payload = sf_payload.reshape(b, -1)
    # Invalid candidates carry the sentinel and sort to each frame's tail;
    # the head slice keeps every valid candidate whenever <= max_points
    # exist.
    if s_key.shape[1] > max_points:
        s_key = s_key[:, :max_points]
        s_payload = s_payload[:, :max_points]
    n = s_key.shape[1]

    # --- run-length segmentation + chunked top-2 pre-selection -------------
    t, cand_len, cand_pos = jax.vmap(segment_stats)(s_key, s_payload)

    # Final ranking of the winners is by DIRECTION DIVERSITY, then length:
    # a straight line (directional texture: stripes, fences, wood grain)
    # is a large run whose candidates share one edge direction; a tag
    # border is a closed quad with both represented. Ranking by raw
    # population let line runs starve the K cluster slots on textured
    # frames (round-2 capacity cliff, VERDICT item 7); the primary key
    # min(count_dir0, count_dir1) is ~perimeter/4 for a quad, ~0 for a
    # line. Computed for the winners only: ONE plain cumsum over the
    # dir-0 indicator plus a few hundred element gathers — the exact
    # per-run segmented sum costs nothing at this stage.
    p0 = jnp.clip(cand_pos, 0, n - 1)  # [B, nc]
    p1 = jnp.clip(cand_pos + cand_len - 1, 0, n - 1)
    # d0 at the run start, recomputed from the GATHERED payload/key (the
    # dense d0 array lives only inside segment_stats).
    pay_p0 = take_rows(s_payload, p0)
    key_p0 = take_rows(s_key, p0)
    d0_p0 = (
        (((pay_p0 >> 26) & 0x3) == 0) & (key_p0 != _INT_MAX)
    ).astype(jnp.int32)
    d0_run = take_rows(t, p1) - take_rows(t, p0) + d0_p0
    min_dir = jnp.minimum(d0_run, cand_len - d0_run)
    rank = jnp.where(
        cand_len > 0,
        jnp.clip(min_dir, 0, (1 << 14) - 1) * (1 << 15)
        + jnp.clip(cand_len, 0, (1 << 15) - 1),
        0,
    )
    top_rank, top_sel = jax.lax.top_k(rank, max_clusters)  # [B, K]
    top_start = jnp.take_along_axis(cand_pos, top_sel, axis=1)
    top_count = jnp.where(
        top_rank > 0, jnp.take_along_axis(cand_len, top_sel, axis=1), 0)

    # --- gather fixed-size point windows (small gathers: B x K x P) --------
    # Runs larger than the window are stride-subsampled across their whole
    # extent (a truncated window would cover only the top of a big tag's
    # boundary and starve the quad fitter's bottom edges).
    offs = jnp.arange(cluster_points, dtype=jnp.int32)[None, None, :]
    cnt = top_count[:, :, None]  # [B, K, 1]
    strided = top_start[:, :, None] + (offs * cnt) // cluster_points
    direct = top_start[:, :, None] + offs
    widx = jnp.where(cnt > cluster_points, strided, direct)  # [B, K, P]
    idx_c = jnp.clip(widx, 0, n - 1)
    in_seg = (offs < cnt) & (widx < n)

    x2, y2, dir_idx, p_white = _unpack_payload(take_rows(s_payload, idx_c))
    # dir 0 = (0, 1), dir 1 = (1, 0): a select beats a gather from a
    # 2-element table (tiny-constant gathers measured ~0.8 ms here).
    dx = jnp.where(dir_idx == 0, 1, 0)
    dy = jnp.where(dir_idx == 0, 0, 1)
    sign = jnp.where(p_white == 1, -1, 1)  # gradient black -> white

    px = x2.astype(jnp.float32) * jnp.float32(0.5)
    py = y2.astype(jnp.float32) * jnp.float32(0.5)
    pgx = (sign * dx).astype(jnp.float32)
    pgy = (sign * dy).astype(jnp.float32)
    # [B, 4, K, P] channel-first per frame (see Clusters docstring)
    points = jnp.stack([px, py, pgx, pgy], axis=1)
    points = jnp.where(in_seg[:, None], points, 0.0)

    valid = top_count >= min_points
    if dropped is None:
        dropped = jnp.zeros((b,), jnp.int32)
    return Clusters(points=points, mask=in_seg, count=top_count, valid=valid,
                    dropped=jnp.asarray(dropped, jnp.int32))


def cluster_candidates(
    black: jax.Array,
    white: jax.Array,
    payload: jax.Array,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
    dropped=None,
) -> Clusters:
    """Single-frame ([n] inputs) wrapper over ``cluster_candidates_batched``
    — identical results by construction (the fused sort is canonical, so a
    frame's clusters don't depend on batch size or position)."""
    out = cluster_candidates_batched(
        black[None], white[None], payload[None],
        max_points=max_points, max_clusters=max_clusters,
        cluster_points=cluster_points, min_points=min_points,
        dropped=None if dropped is None else jnp.asarray(dropped)[None],
    )
    return jax.tree_util.tree_map(lambda x: x[0], out)


def compact_candidates(black: jax.Array, white: jax.Array,
                       payload: jax.Array, width: int,
                       max_points: int = MAX_EDGE_POINTS):
    """Block-sparse compaction of a dense per-frame candidate array (the
    layout ``extract_boundary_points`` emits): ``(black, white, payload,
    dropped)``, each candidate array
    ~2x max_points long (or untouched when the frame is small enough).
    ``width`` is the frame width in pixels (sets the per-direction page
    geometry — see ``_compact_blocks``).

    The compaction rationale: the dominant cost of the cluster stage was a
    512k-row sort; compacting to the occupied blocks first cuts the sort
    (and every scan after it) toward max_points rows. Round 2 selected
    2x max_points of blocks as slack for sparse-but-real border blocks;
    shrinking it was measured NOT safe: 1.5x drops full-res clean-tag
    candidates (133 at 1304x1600) and noisy-scene corpus detections, and
    1x loses adversarial corner tags, so the 2x slack stays."""
    dropped = jnp.int32(0)
    if black.shape[0] > max_points:
        black, white, payload, dropped = _compact_blocks(
            black, white, payload, int(COMPACT_SLACK * max_points), width,
        )
    return black, white, payload, dropped


def extract_and_compact(tern: jax.Array, labels: jax.Array,
                        max_points: int = MAX_EDGE_POINTS):
    """Boundary extraction + block-sparse compaction for ONE frame (see
    ``compact_candidates`` for the compaction rationale)."""
    black, white, payload = extract_boundary_points(tern, labels)
    return compact_candidates(black, white, payload, tern.shape[1],
                              max_points=max_points)


def gradient_clusters_batched(
    tern: jax.Array,
    labels: jax.Array,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
) -> Clusters:
    """Cluster boundary points for a BATCH of frames ([B, H, W] inputs):
    per-frame extraction/compaction under vmap, then the fused batched
    sort + tail (``cluster_candidates_batched``)."""
    black, white, payload, dropped = jax.vmap(
        partial(extract_and_compact, max_points=max_points)
    )(tern, labels)
    return cluster_candidates_batched(
        black, white, payload,
        max_points=max_points, max_clusters=max_clusters,
        cluster_points=cluster_points, min_points=min_points,
        dropped=dropped,
    )


@partial(
    jax.jit,
    static_argnames=("max_points", "max_clusters", "cluster_points", "min_points"),
)
def gradient_clusters(
    tern: jax.Array,
    labels: jax.Array,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
) -> Clusters:
    """Cluster boundary points for ONE frame ([H, W] inputs). Prefer
    ``gradient_clusters_batched`` over vmapping this: the fused batch sort
    is ~1.8x faster than per-frame sorts (results identical either way)."""
    return jax.tree_util.tree_map(
        lambda x: x[0],
        gradient_clusters_batched(
            tern[None], labels[None],
            max_points=max_points, max_clusters=max_clusters,
            cluster_points=cluster_points, min_points=min_points,
        ),
    )
