"""The fused batched AprilTag detector: frames in, detections out.

This is the batched device replacement for the reference's per-camera C-library call
``self.detector.detect(&image)`` (``crates/apriltags/src/lib.rs:301``): one
jitted program runs threshold -> segmentation -> clustering -> quad fit ->
edge refine -> decode for a whole batch of frames (all cameras at once,
SURVEY.md section 2.4 mapping #1).

Output is fixed-shape (MAX_DETECTIONS per frame, matching the reference's
``AprilTagDetections`` CuArrayVec capacity, crates/apriltags/src/lib.rs:42):
ids, corners, decision margins and a validity mask, sorted by decision margin
with per-tag-id dedup (the outer and inner border boundaries can both fit the
same tag; the reference's C detector dedups inside libapriltag).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from chalkydri_tpu.detector.cluster import (
    MAX_CLUSTER_POINTS,
    MAX_CLUSTERS,
    cluster_candidates_batched,
    extract_and_compact,
)
from chalkydri_tpu.detector.decode import make_decoder
from chalkydri_tpu.detector.families import (
    DEFAULT_BITS_CORRECTED,
    DEFAULT_FAMILY,
    TagFamily,
    load_family,
)
from chalkydri_tpu.detector.homography import pack_neighborhood
from chalkydri_tpu.detector.quad import fit_quads
from chalkydri_tpu.detector.refine import refine_quads
from chalkydri_tpu.detector.segment import label_components
from chalkydri_tpu.detector.threshold import adaptive_threshold

MAX_DETECTIONS = 16  # crates/apriltags/src/lib.rs:42


class Detections(NamedTuple):
    """Fixed-capacity detections, the analogue of ``AprilTagDetections``
    (ids/poses/decision_margins triple, crates/apriltags/src/lib.rs:47-52) —
    with corners instead of C-library poses: the pose solve happens in the
    fused SQPnP stage."""

    ids: jax.Array  # [B, MAX_DETECTIONS] int32, -1 for empty slots
    corners: jax.Array  # [B, MAX_DETECTIONS, 4, 2] float32
    decision_margins: jax.Array  # [B, MAX_DETECTIONS] float32
    hammings: jax.Array  # [B, MAX_DETECTIONS] int32
    valid: jax.Array  # [B, MAX_DETECTIONS] bool
    dropped_points: jax.Array  # [B] int32 — candidates lost to capacity
    #   compaction (0 in benign scenes; nonzero makes the degradation mode
    #   VISIBLE in soak/telemetry instead of silently losing tags)

    def count(self):
        return jnp.sum(self.valid, axis=-1)

    def filtered_by_decision_margin(self, threshold: float):
        """Iterate (frame, id, corners, margin) for detections above the
        margin threshold — API parity with
        ``AprilTagDetections::filtered_by_decision_margin``
        (crates/apriltags/src/lib.rs:127-141). Host-side convenience (pulls
        the arrays once)."""
        import numpy as np

        ids = np.asarray(self.ids)
        corners = np.asarray(self.corners)
        margins = np.asarray(self.decision_margins)
        valid = np.asarray(self.valid)
        for b in range(ids.shape[0]):
            for i in range(ids.shape[1]):
                if valid[b, i] and margins[b, i] > threshold:
                    yield b, int(ids[b, i]), corners[b, i], float(margins[b, i])


def make_post_cluster(
    decode,
    refine: bool = True,
    quad_decimate: int = 2,
    max_detections: int = MAX_DETECTIONS,
    max_quad_candidates: int = 32,
):
    """Build the post-cluster tail ``finish(gray_batch, clusters) ->
    Detections`` (BATCHED: gray [B, H, W], cluster fields lead with B):
    quad fit -> candidate compaction -> refine -> decode -> margin rank ->
    per-id dedup. Shared by the single-device detector (``make_detector``)
    and the spatially-sharded multi-chip pipeline
    (parallel/pipeline.py), which reaches this point via per-shard boundary
    extraction + a candidate all-gather.

    Batch plumbing: the packed sampling image is ONE flat [B*H*W] uint32
    table shared across the per-frame vmap (``in_axes=None``) with
    per-frame ``base`` offsets folded into the sample indices, so the
    refine/decode bilinear samples (the dominant gathers of this stage)
    are plain gathers from one unbatched table."""

    def _tail(hw, packed_flat, base, corners, q_valid, dropped):
        """One frame's refine -> decode -> rank -> dedup (vmapped below;
        ``packed_flat`` rides unbatched through the vmap, ``hw`` is bound
        statically before the vmap)."""
        if refine:
            corners = refine_quads(packed_flat, corners, q_valid,
                                   hw=hw, base=base)
        dec = decode(packed_flat, corners, q_valid, hw=hw, base=base)

        # --- rank by decision margin, dedup by tag id ----------------------
        margin = jnp.where(dec.valid, dec.decision_margin, -1.0)
        order = jnp.argsort(-margin)  # best first
        ids_s = dec.tag_id[order]
        margins_s = margin[order]
        corners_s = dec.corners[order]
        ham_s = dec.hamming[order]
        valid_s = dec.valid[order]

        # Dedup: a detection is kept only if no earlier (better) slot has the
        # same tag id. K x K mask, K = MAX_CLUSTERS (static, small).
        k = ids_s.shape[0]
        same = ids_s[None, :] == ids_s[:, None]  # [k, k]
        earlier = jnp.tril(jnp.ones((k, k), bool), k=-1)
        dup = jnp.any(same & earlier & valid_s[None, :], axis=1)
        keep = valid_s & ~dup

        # Compact the kept detections to the front, truncate to capacity.
        pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
        slot = jnp.where(keep & (pos < max_detections), pos, max_detections)

        def compact(v, fill):
            buf = jnp.full((max_detections + 1, *v.shape[1:]), fill, v.dtype)
            return buf.at[slot].set(v, mode="drop")[:max_detections]

        return Detections(
            ids=compact(ids_s, jnp.int32(-1)),
            corners=compact(corners_s, jnp.float32(0)),
            decision_margins=compact(margins_s, jnp.float32(0)),
            hammings=compact(ham_s, jnp.int32(0)),
            valid=compact(keep, False),
            dropped_points=dropped,
        )

    def finish(gray, clusters):
        """gray [B, H, W] full-res frames; clusters fields lead with B."""
        b, h, w = gray.shape
        quads = jax.vmap(fit_quads)(
            clusters.points, clusters.mask, clusters.valid
        )

        # --- candidate compaction: refine + decode cost is dominated by
        # bilinear gathers proportional to K; keep only the best
        # max_quad_candidates quads (valid first, larger clusters first) ----
        kq = min(max_quad_candidates, quads.valid.shape[1])
        score = jnp.where(quads.valid, clusters.count, jnp.int32(-1))
        _, sel = jax.lax.top_k(score, kq)  # [B, kq]
        corners = jnp.take_along_axis(
            quads.corners, sel[..., None, None], axis=1
        )  # [B, kq, 4, 2]
        q_valid = jnp.take_along_axis(quads.valid, sel, axis=1)

        if quad_decimate == 2:
            # decimated pixel (i, j) is the mean of full pixels 2i..2i+1 x
            # 2j..2j+1, i.e. its center sits at full coord 2*c + 0.5.
            corners = corners * 2.0 + 0.5
        # Pack 2x2 neighborhoods once (one gather per bilinear sample,
        # homography.py); flatten the batch into ONE shared table.
        packed_flat = pack_neighborhood(gray).reshape(-1)
        base = jnp.arange(b, dtype=jnp.int32) * (h * w)
        return jax.vmap(
            partial(_tail, (h, w)), in_axes=(None, 0, 0, 0, 0)
        )(packed_flat, base, corners, q_valid, clusters.dropped)

    return finish


def make_detector(
    family: str | TagFamily = DEFAULT_FAMILY,
    bits_corrected: int = DEFAULT_BITS_CORRECTED,
    max_detections: int = MAX_DETECTIONS,
    ccl_iters: int = 12,
    refine: bool = True,
    quad_decimate: int = 2,
    max_edge_points: int | None = None,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    max_quad_candidates: int = 32,
    capacity_fallback: bool = False,
):
    """Build a jitted ``detect(gray_batch) -> Detections``.

    Mirrors ``DetectorBuilder::add_family_bits(family, bits_corrected)``
    (crates/apriltags/src/lib.rs:258-261). ``quad_decimate`` matches
    libapriltag's same-named default (2): quad SEARCH (threshold, CCL,
    clustering, quad fit) runs at half resolution — 4x less work in the
    dominant stages — while edge refinement and payload decode sample the
    full-resolution image, recovering sub-pixel corners. The capacity knobs
    trade peak memory/compile size for dense-scene capacity.

    ``max_quad_candidates``: only this many fitted quads (best clusters
    first) proceed to the bilinear-gather-heavy refine+decode stages. The
    default 32 covers the worst case exactly: MAX_DETECTIONS=16 tags x 2
    boundary clusters each (a tag border's black ring pairs with both the
    outside white region and the inner white cells).

    ``capacity_fallback``: texture-flooded frames (sensor noise on
    low-contrast background classifying to dense speckle) can exceed the
    candidate compaction budget; the block drop then lands on TAG blocks
    as much as noise blocks — under a uniform flood every ranking signal
    (count, both-direction boost) saturates, so the cut is effectively
    arbitrary at the cutoff ties and a real tag's cluster fragments
    (measured: the 84th golden-corpus detection, sigma-5 noise, 34.4k
    candidates vs the 65k budget's 512-blocks/dir cap — 3896 dropped, 82
    of the tag's 160 dir-0 blocks lost). With this flag the returned
    callable is a HOST-side two-program dispatcher: the standard-budget
    program runs every frame, and iff its per-frame ``dropped_points``
    reports an overflow the batch re-runs on a lazily-compiled 2x-budget
    program. Static shapes stay static (two fixed programs express a
    dynamic budget without recompiling); clean frames pay nothing — identical
    detections by value, since compaction keeps every occupied block when
    the cap doesn't bind. Default OFF: the hot fused pipeline
    (chalkydri_tpu.pipeline) reports dropped_points as a health metric
    instead (runtime/app.py dropped_points_total).
    """
    from chalkydri_tpu.detector.cluster import MAX_EDGE_POINTS

    fam = load_family(family) if isinstance(family, str) else family
    decode = make_decoder(fam, bits_corrected=bits_corrected)
    edge_cap = MAX_EDGE_POINTS if max_edge_points is None else max_edge_points
    assert quad_decimate in (1, 2), "quad_decimate must be 1 or 2"

    def candidates_fn(small):
        """[B, h, w] decimated frames -> batched compacted candidate arrays
        (black, white, payload, dropped)."""
        tern = adaptive_threshold(small)
        labels = label_components(tern, iters=ccl_iters)
        return jax.vmap(
            partial(extract_and_compact, max_points=edge_cap)
        )(tern, labels)

    def preprocess(gray_batch):
        """Batch-level 2x2 mean decimation (quad search resolution)."""
        if quad_decimate == 2:
            h2 = (gray_batch.shape[1] // 8) * 8
            w2 = (gray_batch.shape[2] // 8) * 8
            g = gray_batch[:, :h2, :w2]
            # 2x2 mean via reduce_window (bit-identical to a 5-D
            # reshape+sum, without a size-2 minor axis).
            s = jax.lax.reduce_window(
                g.astype(jnp.uint16), jnp.uint16(0), jax.lax.add,
                window_dimensions=(1, 2, 2), window_strides=(1, 2, 2),
                padding="VALID",
            )
            small = (s // 4).astype(jnp.uint8)
        else:
            small = gray_batch
        return small

    finish = make_post_cluster(
        decode, refine=refine, quad_decimate=quad_decimate,
        max_detections=max_detections,
        max_quad_candidates=max_quad_candidates,
    )

    @jax.jit
    def detect(gray_batch):
        """gray_batch: [B, H, W] uint8 -> Detections (leading dim B)."""
        small = preprocess(gray_batch)
        black, white, payload, dropped = candidates_fn(small)
        # Clustering runs BATCHED (one fused sort + batch-folded gathers
        # across all frames — ~1.8x over a vmapped per-frame sort);
        # extraction and the post-cluster tail stay per-frame under vmap.
        clusters = cluster_candidates_batched(
            black, white, payload,
            max_points=edge_cap,
            max_clusters=max_clusters,
            cluster_points=cluster_points,
            dropped=dropped,
        )
        return finish(gray_batch, clusters)

    if not capacity_fallback:
        return detect

    big = make_detector(
        family=fam, bits_corrected=bits_corrected,
        max_detections=max_detections, ccl_iters=ccl_iters, refine=refine,
        quad_decimate=quad_decimate, max_edge_points=2 * edge_cap,
        max_clusters=max_clusters, cluster_points=cluster_points,
        max_quad_candidates=max_quad_candidates,
    )

    def detect_with_fallback(gray_batch):
        out = detect(gray_batch)
        import numpy as _np

        if int(_np.max(jax.device_get(out.dropped_points))) > 0:
            return big(gray_batch)
        return out

    return detect_with_fallback
