"""Multi-chip vision pipeline: the fused detect->pose step over a device mesh.

Public packaging of the scaling recipe the driver dryrun exercises
(__graft_entry__.dryrun_multichip) and SURVEY.md section 2.4/5.7 call for:

- cameras/frames ride the ``data`` mesh axis (frames are independent — the
  reference's per-camera task parallelism becomes pure data parallelism),
- per-camera parameters (intrinsics, extrinsics) shard with their frames,
- the field layout replicates (every chip needs every tag pose),
- jit + committed input shardings let GSPMD partition the whole fused
  program; collectives ride the device interconnect.

With ``spatial=True`` the ``space`` mesh axis additionally row-shards each
frame END TO END through one program (the data-parallel re-architecture of the
reference's sketched chunked-row cluster merge,
``crates/chalkydri-apriltags/src/lib.rs:555-613``):

- decimation, adaptive threshold and CCL run on each chip's row block with
  ppermute halo/seam exchange over the interconnect (sharded_stages.py),
- boundary-candidate extraction runs per shard (1-row halo down),
  emitting exactly the global candidate set with globally-valid labels and
  coordinates,
- the shards reconstruct the single-device candidate compaction EXACTLY:
  per-block candidate counts ride a tiny all-gather, every chip ranks
  the same blocks (cluster.rank_blocks, tie-breaks included), and a masked psum
  assembles bitwise-identical compacted arrays — so the downstream
  cluster -> quad -> refine -> decode -> solve tail is bit-identical to
  the single-device program (asserted in tests/test_sharding.py),
- the tail runs replicated across 'space' (it is light: a few-hundred-KB
  sort + 16-64 quads), so its outputs are whole per data-shard.

Usage:

    mesh = make_mesh(8, space=2)
    step, place = make_sharded_vision_pipeline(layout, params, rc, mesh,
                                               spatial=True)
    out = step(*place(frames_np, gyro_np))   # out fields sharded over 'data'
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from chalkydri_tpu.geometry.field_layout import FieldLayout
from chalkydri_tpu.geometry.transforms import SE3
from chalkydri_tpu.parallel.mesh import batch_sharding, frame_sharding
from chalkydri_tpu.pipeline import make_frame_solver, make_vision_pipeline


def make_sharded_vision_pipeline(
    layout: FieldLayout,
    camera_params: jax.Array,  # [B, 9]
    robot_to_cam: SE3,  # batched [B, 3, 3] / [B, 3]
    mesh,
    spatial: bool = False,
    **pipeline_kwargs,
):
    """Build (step, place) for a camera rig sharded over mesh axis 'data'.

    ``step`` is the same fused program as ``make_vision_pipeline``'s; GSPMD
    partitions it from the input shardings ``place`` commits. The batch B
    (camera count, possibly x frames-in-flight) must be a MULTIPLE of the
    'data' axis size. ``place(frames, gyro)`` device_puts host arrays with
    the right shardings — call it once per iteration with fresh capture
    data.

    ``spatial=True``: frame rows additionally shard over the 'space' axis
    through the ENTIRE detect+solve program (see module docstring); frame
    height must divide into ``space * 8`` (``space * 4`` at
    quad_decimate=1) so each shard's decimated block tiles cleanly.
    """
    n_data = mesh.shape["data"]
    b = camera_params.shape[0]
    assert b % n_data == 0, (
        f"camera batch {b} must be a multiple of the data axis {n_data}"
    )

    # Per-camera parameters shard with their frames; the closed-over layout
    # tables replicate automatically (jit constants).
    bs = batch_sharding(mesh)
    camera_params = jax.device_put(camera_params, bs)
    robot_to_cam = SE3(
        jax.device_put(robot_to_cam.rotation, bs),
        jax.device_put(robot_to_cam.translation, bs),
    )

    if spatial:
        step = _make_spatial_step(
            layout, camera_params, robot_to_cam, mesh, **pipeline_kwargs
        )
    else:
        step = make_vision_pipeline(
            layout, camera_params, robot_to_cam, **pipeline_kwargs
        )

    fs = frame_sharding(mesh, spatial=spatial)

    def place(frames, gyro):
        return jax.device_put(frames, fs), jax.device_put(gyro, bs)

    return step, place


def _fetch_rows(x: jax.Array, axis_name: str, direction: int) -> jax.Array:
    """Ring-shift row slices over the mesh axis. direction +1: receive the
    payload from the shard ABOVE (they send downward)."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, (i + direction) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis_name, perm)


def _make_spatial_step(
    layout: FieldLayout,
    camera_params: jax.Array,  # [B, 9] (sharded over 'data')
    robot_to_cam: SE3,
    mesh,
    family: str | None = None,
    bits_corrected: int | None = None,
    tag_size: float | None = None,
    sign_flip: float | None = None,
    decision_margin_min: float = 0.0,
    refine: bool = True,
    detector_kwargs: dict | None = None,
):
    """The fused spatially-sharded step: one shard_map program spanning
    decimate -> threshold -> CCL -> boundary extract -> candidate
    all-gather -> cluster -> quad -> refine -> decode -> SQPnP."""
    from chalkydri_tpu.detector.cluster import (
        MAX_CLUSTER_POINTS,
        MAX_CLUSTERS,
        MAX_EDGE_POINTS,
        COMPACT_SLACK,
        MIN_CLUSTER_POINTS,
        cluster_candidates_batched,
        extract_boundary_points,
        rank_blocks,
        _dilate_vec,
    )
    from chalkydri_tpu.detector.cluster import take_rows
    from chalkydri_tpu.detector.decode import make_decoder
    from chalkydri_tpu.detector.families import (
        DEFAULT_BITS_CORRECTED,
        DEFAULT_FAMILY,
        load_family,
    )
    from chalkydri_tpu.detector.pipeline import make_post_cluster
    from chalkydri_tpu.detector.segment import INVALID
    from chalkydri_tpu.detector.threshold import MIN_WHITE_BLACK_DIFF, TILE
    from chalkydri_tpu.geometry.tags import TAG_SIZE
    from chalkydri_tpu.parallel.sharded_stages import (
        _exchange_halo,
        _threshold_block,
        label_components_block,
    )
    from chalkydri_tpu.pipeline import VisionOutput
    from chalkydri_tpu.geometry.transforms import matrix_to_yaw
    from chalkydri_tpu.solver.robot_pose import SIGN_FLIP_CONST

    dk = dict(detector_kwargs or {})
    qd = int(dk.get("quad_decimate", 2))
    ccl_iters = int(dk.get("ccl_iters", 12))
    edge_cap = int(dk.get("max_edge_points", MAX_EDGE_POINTS))
    max_clusters = int(dk.get("max_clusters", MAX_CLUSTERS))
    cluster_points = int(dk.get("cluster_points", MAX_CLUSTER_POINTS))
    max_quad_candidates = int(dk.get("max_quad_candidates", 32))
    max_detections = int(dk.get("max_detections", 16))
    assert qd in (1, 2)

    fam = load_family(family or DEFAULT_FAMILY)
    decode = make_decoder(
        fam,
        bits_corrected=(
            DEFAULT_BITS_CORRECTED if bits_corrected is None else bits_corrected
        ),
    )
    finish = make_post_cluster(
        decode, refine=refine, quad_decimate=qd,
        max_detections=max_detections,
        max_quad_candidates=max_quad_candidates,
    )
    solve_frame = make_frame_solver(
        layout,
        tag_size=TAG_SIZE if tag_size is None else tag_size,
        sign_flip=SIGN_FLIP_CONST if sign_flip is None else sign_flip,
        decision_margin_min=decision_margin_min,
    )

    n_space = mesh.shape["space"]

    cluster_fn = partial(
        cluster_candidates_batched,
        max_points=edge_cap, max_clusters=max_clusters,
        cluster_points=cluster_points, min_points=MIN_CLUSTER_POINTS,
    )

    def body(frames_blk, gyro_blk, params_blk, rc_rot_blk, rc_t_blk):
        bl, hl, w = frames_blk.shape
        idx = jax.lax.axis_index("space")
        last = n_space - 1

        # -- 1. decimation (local: hl is even by construction) -------------
        if qd == 2:
            s = jax.lax.reduce_window(
                frames_blk.astype(jnp.uint16), jnp.uint16(0), jax.lax.add,
                window_dimensions=(1, 2, 2), window_strides=(1, 2, 2),
                padding="VALID",
            )
            small = (s // 4).astype(jnp.uint8)
        else:
            small = frames_blk
        _, hl2, w2 = small.shape
        assert hl2 % TILE == 0, (
            f"per-shard decimated rows {hl2} must tile by {TILE}; pad frame "
            f"rows to a multiple of space*{TILE * qd}"
        )

        # -- 2. adaptive threshold with halo exchange -----------------------
        tern = _threshold_block(
            _exchange_halo(small, "space"), MIN_WHITE_BLACK_DIFF
        )

        # -- 3. CCL with per-round seam exchange (global flat labels, so
        # detections are bit-identical to the single-device program) ------
        labels = label_components_block(tern, hl2, w2, ccl_iters, "space")

        # -- 4. boundary extraction with a 1-up/2-down tern halo ------------
        # (solidity stencil reaches 1 row; a last-core-row down-edge needs
        # the below shard's solidity, which reaches 2 rows down)
        t_above = _fetch_rows(tern[:, -1:, :], "space", +1)
        t_below2 = _fetch_rows(tern[:, :2, :], "space", -1)
        t_above = jnp.where(idx == 0, jnp.uint8(127), t_above)
        t_below2 = jnp.where(idx == last, jnp.uint8(127), t_below2)
        tern_ext = jnp.concatenate([t_above, tern, t_below2], axis=1)

        l_below = _fetch_rows(labels[:, :1, :], "space", -1)
        l_below = jnp.where(idx == last, INVALID, l_below)
        l_pad = jnp.full((bl, 1, w2), INVALID, labels.dtype)
        labels_ext = jnp.concatenate([l_pad, labels, l_below, l_pad], axis=1)

        row0 = idx * hl2
        black, white, payload = jax.vmap(
            lambda t, l: extract_boundary_points(
                t, l, halo_top=1, halo_bottom=2, y_offset=row0
            )
        )(tern_ext, labels_ext)
        # Drop the (masked-invalid) halo rows' slots so the layout is the
        # per-shard slice of the single-device enumeration.
        hext = hl2 + 3

        def core_slice(x):
            return x.reshape(bl, 2, hext, w2)[:, :, 1:1 + hl2, :].reshape(
                bl, 2 * hl2 * w2
            )

        black, white, payload = map(core_slice, (black, white, payload))

        # -- 5. globally-consistent compaction ------------------------------
        # The single-device path keeps the top-ranked 2*max_points/128
        # candidate blocks per direction in ORIENTATION-ALIGNED layouts
        # (cluster._compact_blocks: dir 0 — right pairs / vertical edges —
        # blocks the transposed [W, ceil128(H)] page so column blocks pack
        # vertical edges densely; dir 1 the row-major [H, ceil128(W)]
        # page). To stay BIT-IDENTICAL even when that cap drops blocks,
        # the shards reconstruct the exact same selection: per-block
        # candidate COUNTS and the per-axis both-direction boost vectors
        # ride tiny collectives, every chip ranks the same blocks
        # (cluster.rank_blocks — tie-breaks included), then each shard
        # contributes its owned slice of every selected block into a psum
        # — every chip ends up holding the single-device compacted
        # arrays, bit for bit. Dir-1 blocks are row-aligned and wholly
        # shard-owned; dir-0 COLUMN blocks span shard row bands, so their
        # contribution is element-level (a gather over the local
        # transposed page, ownership-masked, psum-merged). Collective volume:
        # counts + boosts ~KBs, 3 x 2*max_points int32 (~1.5 MB).
        n_seg = hl2 * w2  # per-dir per-shard candidates
        assert n_seg % 128 == 0, "per-shard candidate segment must block-align"
        n_global = 2 * n_space * n_seg
        int_max = jnp.iinfo(jnp.int32).max

        def reorder_gather(x_local):
            """[Bl, 2*n] per-shard dir-major -> [Bl, 2*n_space*n] global
            dir-major (the single-device enumeration order)."""
            x = x_local.reshape(bl, 2, -1)
            x = jax.lax.all_gather(x, "space", axis=2, tiled=False)
            return x.reshape(bl, -1)

        if n_global <= edge_cap:
            # Single-device path would skip compaction: hand the tail the
            # full global candidate array in enumeration order.
            black = reorder_gather(black)
            white = reorder_gather(white)
            payload = reorder_gather(payload)
            dropped = jnp.zeros((bl,), jnp.int32)
        else:
            h2 = n_space * hl2
            hp = -(-h2 // 128) * 128
            wp = -(-w2 // 128) * 128
            n_rb, nbw = hp // 128, wp // 128
            cap = int(COMPACT_SLACK * edge_cap)

            has0 = (black[:, :n_seg] != int_max).reshape(bl, hl2, w2)
            has1 = (black[:, n_seg:] != int_max).reshape(bl, hl2, w2)

            # Boost vectors (cluster.direction_boosts semantics, assembled
            # from global row/column presence).
            row0 = jax.lax.all_gather(
                has0.any(axis=2), "space", axis=1, tiled=True)  # [Bl, h2]
            row1 = jax.lax.all_gather(
                has1.any(axis=2), "space", axis=1, tiled=True)
            col0 = jax.lax.psum(
                has0.any(axis=1).astype(jnp.int32), "space") > 0  # [Bl, w2]
            col1 = jax.lax.psum(
                has1.any(axis=1).astype(jnp.int32), "space") > 0
            both_row = _dilate_vec(row0) & _dilate_vec(row1)
            both_col = _dilate_vec(col0) & _dilate_vec(col1)
            boost0 = jnp.broadcast_to(
                both_col[..., None], (bl, w2, n_rb)).reshape(bl, -1)
            boost1 = jnp.broadcast_to(
                both_row[..., None], (bl, h2, nbw)).reshape(bl, -1)

            # Global per-block counts. Dir 1: row-aligned blocks, local
            # counts concatenate over shards into global row-major order.
            def pad_w(x, fill):
                return jnp.pad(x.reshape(bl, hl2, w2),
                               ((0, 0), (0, 0), (0, wp - w2)),
                               constant_values=fill)

            counts1_loc = (
                pad_w(black[:, n_seg:], int_max) != int_max
            ).reshape(bl, hl2 * nbw, 128).sum(axis=2)
            counts1 = jax.lax.all_gather(
                counts1_loc, "space", axis=1, tiled=True)  # [Bl, h2*nbw]
            # Dir 0: column blocks (x, rb) span shard bands; each shard
            # bins its rows into the global 128-row chunks and psums.
            r_glob = idx * hl2 + jnp.arange(hl2, dtype=jnp.int32)
            bins = (
                r_glob[:, None] // 128
                == jnp.arange(n_rb, dtype=jnp.int32)[None, :]
            )  # [hl2, n_rb]
            counts0 = jax.lax.psum(
                jnp.einsum("bhw,hr->bwr", has0.astype(jnp.int32),
                           bins.astype(jnp.int32)),
                "space",
            ).reshape(bl, w2 * n_rb)

            idx0 = rank_blocks(counts0, boost0, cap)  # [Bl, k0]
            idx1 = rank_blocks(counts1, boost1, cap)  # [Bl, k1]
            k0, k1 = idx0.shape[-1], idx1.shape[-1]
            dropped = (
                counts0.sum(axis=-1) + counts1.sum(axis=-1)
                - jnp.take_along_axis(counts0, idx0, axis=-1).sum(axis=-1)
                - jnp.take_along_axis(counts1, idx1, axis=-1).sum(axis=-1)
            ).astype(jnp.int32)

            # Dir-0 contribution: element-level ownership over column blocks.
            lanes = jnp.arange(128, dtype=jnp.int32)
            r_elem = (idx0 % n_rb)[..., None] * 128 + lanes  # [Bl, k0, 128]
            x_elem = (idx0 // n_rb)[..., None]
            valid_r = r_elem < h2
            mine0 = (r_elem // hl2 == idx) & valid_r
            loc0 = jnp.clip(
                x_elem * hl2 + (r_elem - idx * hl2), 0, n_seg - 1)

            def contribute0(x_local, fill):
                xt = x_local[:, :n_seg].reshape(bl, hl2, w2).transpose(
                    0, 2, 1).reshape(bl, n_seg)
                g = take_rows(xt, loc0)
                tot = jax.lax.psum(jnp.where(mine0, g, 0), "space")
                return jnp.where(valid_r, tot, fill)  # pad rows -> fill

            # Dir-1 contribution: whole blocks are shard-owned.
            r1 = idx1 // nbw
            mine1 = (r1 // hl2 == idx)[..., None]
            local_blk1 = ((r1 % hl2) * nbw + idx1 % nbw)[..., None]

            def contribute1(x_local, fill):
                xb = pad_w(x_local[:, n_seg:], fill).reshape(
                    bl, hl2 * nbw, 128)
                take = jnp.take_along_axis(xb, local_blk1, axis=1)
                return jax.lax.psum(jnp.where(mine1, take, 0), "space")

            def compacted(x_local, fill):
                c0 = contribute0(x_local, fill)
                c1 = contribute1(x_local, fill)
                return jnp.concatenate(
                    [c0.reshape(bl, k0 * 128), c1.reshape(bl, k1 * 128)],
                    axis=1,
                )

            black, white, payload = (
                compacted(black, int_max),
                compacted(white, int_max),
                compacted(payload, jnp.int32(0)),
            )

        # -- 6. cluster -> quad -> refine -> decode (replicated over
        # 'space'; the full-resolution frame is re-assembled by all-gather for
        # the sub-pixel sampling stages) ------------------------------------
        clusters = cluster_fn(black, white, payload, dropped=dropped)
        gray_full = jax.lax.all_gather(frames_blk, "space", axis=1, tiled=True)
        dets = finish(gray_full, clusters)

        # -- 7. SQPnP + gyro fusion per frame -------------------------------
        res, n_tags = jax.vmap(solve_frame)(
            dets, params_blk, rc_rot_blk, rc_t_blk, gyro_blk
        )
        yaw = matrix_to_yaw(res.rotation)
        return VisionOutput(
            pose_x=res.position[:, 0],
            pose_y=res.position[:, 1],
            pose_yaw=yaw,
            std_devs=res.std_devs,
            pose_valid=res.valid & (n_tags > 0),
            tag_count=n_tags,
            detections=dets,
        )

    sharded_body = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("data", "space", None),  # frames [B, H, W]
            P("data"),  # gyro
            P("data", None),  # camera params
            P("data", None, None),  # robot_to_cam rotation
            P("data", None),  # robot_to_cam translation
        ),
        out_specs=P("data"),
        # The tail past the all-gathers computes identical values on every
        # 'space' member; vma tracking can't see that through ppermute, so
        # the replication check is off.
        check_vma=False,
    )

    @jax.jit
    def step(frames, gyro):
        return sharded_body(
            frames, gyro, camera_params,
            robot_to_cam.rotation, robot_to_cam.translation,
        )

    return step
