"""Stage-level cost map of the fused pipeline on the GPU.

``python -m chalkydri_tpu.tools.perfprobe`` prints per-stage device
timings for the bench scene (BASELINE config #5 shape, 4x1280x800 at
quad_decimate=2): every detector stage individually (decimate,
threshold+CCL, boundary extract+compact, the cluster sort, segment stats,
the whole cluster stage, quad fit, refine, decode), the full detect, and
the full fused detect+pose step. ``--qd1`` maps the same stages at the
reference's full-resolution geometry (2x1304x1600, quad_decimate=1).
``--hetero`` characterizes a two-group mixed rig. One run after any
kernel change re-derives the cost map that drives optimization priorities.

Timing method (docs/performance.md): N iterations inside ONE ``lax.scan``
with an input perturbed per iteration so nothing is CSE'd, ended by a
forced host fetch of a scalar reduction; the best of a few repetitions,
divided by N. The memory-bound stages also report the bytes they must
move (``stage_bytes``) and that traffic's share of the card's peak HBM
bandwidth (``PEAK_HBM_BYTES_PER_S``).

Without a GPU the probe exits non-zero. ``--cpu`` instead runs a
2-iteration functional smoke on the CPU: it proves the probe paths
execute, and its numbers are CPU numbers, not device metrics.
"""

from __future__ import annotations

import json
import sys
import time


_N_ITERS = 200
_N_REPS = 3

# Published peak HBM bandwidth by JAX device_kind (NVIDIA H100 SXM5 data
# sheet). A device missing here is an error, not a default.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def stage_bytes(stage: str, batch: int, h: int, w: int, n_cand: int = 0,
                k: int = 64, p: int = 128) -> int:
    """Least HBM traffic of a stage: its inputs read once plus its outputs
    written once, from shapes alone (h, w: the stage's frame geometry —
    decimated for the quad-search stages).

    - ``threshold_ccl``: uint8 frame in; uint8 ternary + int32 labels out.
    - ``cluster_total``: three int32 candidate arrays of ``n_cand`` per
      frame in; the Clusters out (f32 points [4, K, P], bool mask [K, P],
      int32 count + bool valid [K], int32 dropped).
    """
    if stage == "threshold_ccl":
        return batch * h * w * (1 + 1 + 4)
    if stage == "cluster_total":
        return batch * (3 * 4 * n_cand + 4 * 4 * k * p + k * p + 5 * k + 4)
    raise ValueError(f"no byte model for stage {stage!r}")


def hbm_share(nbytes: int, ms: float, device_kind: str) -> float:
    """Achieved bytes/s over the card's peak HBM bandwidth."""
    if device_kind not in PEAK_HBM_BYTES_PER_S:
        raise KeyError(f"no peak bandwidth recorded for {device_kind!r}")
    return nbytes / (ms * 1e-3) / PEAK_HBM_BYTES_PER_S[device_kind]


def devtime(fn, args, n=None, reps=None, perturb_idx=0):
    """ms/iteration of device time for fn(*args): ``n`` iterations in one
    scan dispatch, completion forced by fetching the scan's reduction."""
    import jax
    import jax.numpy as jnp

    n = _N_ITERS if n is None else n
    reps = _N_REPS if reps is None else reps

    @jax.jit
    def many(*args):
        def body(c, i):
            a = list(args)
            x = a[perturb_idx]
            if jnp.issubdtype(x.dtype, jnp.floating):
                a[perturb_idx] = x + (i % 2).astype(x.dtype) * 1e-7
            else:
                a[perturb_idx] = x ^ (i % 2).astype(x.dtype)
            out = fn(*a)
            leaves = jax.tree_util.tree_leaves(out)
            s = sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)
            return c + s, None

        c, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(n))
        return c

    float(many(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(many(*args))
        best = min(best, (time.perf_counter() - t0) * 1000 / n)
    return best


def _rig(batch: int, h: int, w: int, detector_kwargs=None):
    """The bench rig's fused step at any geometry."""
    import jax.numpy as jnp

    from chalkydri_tpu.geometry.field_layout import parse_field_layout
    from chalkydri_tpu.pipeline import build_rig_from_config, make_vision_pipeline

    calib = {"fx": 1100.0, "fy": 1100.0, "cx": w / 2, "cy": h / 2,
             "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
             "width": w, "height": h}
    tags = [{"ID": t,
             "pose": {"translation": {"x": 10.0 + 0.5 * t, "y": 4.0, "z": 1.0},
                      "rotation": {"quaternion": {"W": 0.0, "X": 0.0,
                                                  "Y": 0.0, "Z": 1.0}}}}
            for t in (1, 5, 9, 13)]
    layout = parse_field_layout(
        {"tags": tags, "field": {"length": 16.5, "width": 8.0}},
        dtype=jnp.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps(
                 {"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": 1.0})}
            ] * batch
    params, rc = build_rig_from_config(cams, layout)
    return make_vision_pipeline(layout, params, rc,
                                detector_kwargs=detector_kwargs)


def _tiled_scene(batch: int, h: int, w: int):
    """The bench scene tiled/cropped to [batch, h, w]: stage costs need tags
    plus texture at the geometry, not a realistic view."""
    import numpy as np

    from bench import build_scene

    fr = build_scene()
    reps = (-(-h // fr.shape[0]), -(-w // fr.shape[1]))
    fr = np.tile(fr, reps)[:h, :w]
    return np.broadcast_to(fr, (batch, h, w)).copy()


def main() -> None:
    import os

    smoke = "--cpu" in sys.argv
    if smoke:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import numpy as np
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
        global _N_ITERS, _N_REPS
        _N_ITERS, _N_REPS = 2, 1

    import jax.numpy as jnp

    from chalkydri_tpu.utils.cache import enable_compile_cache
    from chalkydri_tpu.utils.device import (
        device_info,
        gpu_name_and_power_limit,
        require_gpu,
    )

    dev = device_info() if smoke else require_gpu()
    card = "cpu smoke (not a device measurement)" if smoke else \
        gpu_name_and_power_limit()
    print(f"device: {dev} card: {card}", flush=True)
    if not smoke:
        enable_compile_cache()

    # bench.py lives at the repo root (one level above the package), not
    # necessarily the cwd.
    import chalkydri_tpu as _pkg

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))
    )
    from bench import BATCH, H, W

    def _arg(name, default):
        if name in sys.argv:
            return int(sys.argv[sys.argv.index(name) + 1])
        return default

    from chalkydri_tpu.detector.cluster import (
        COMPACT_SLACK,
        HASH_BITS,
        MAX_CLUSTER_POINTS,
        MAX_CLUSTERS,
        MAX_EDGE_POINTS,
        _HASH_MASK,
        _INT_MAX,
        Clusters,
        cluster_candidates_batched,
        compact_candidates,
        extract_boundary_points,
        segment_stats,
    )
    from chalkydri_tpu.detector.pipeline import make_detector, make_post_cluster
    from chalkydri_tpu.detector.decode import make_decoder
    from chalkydri_tpu.detector.families import load_family
    from chalkydri_tpu.detector.homography import pack_neighborhood
    from chalkydri_tpu.detector.quad import fit_quads
    from chalkydri_tpu.detector.refine import refine_quads
    from chalkydri_tpu.detector.segment import label_components
    from chalkydri_tpu.detector.threshold import adaptive_threshold

    results: dict[str, float] = {}

    def probe(name, fn, args, **kw):
        try:
            t = devtime(fn, args, **kw)
            results[name] = t
            print(f"{name}: {t:.4f} ms", flush=True)
            return t
        except Exception as e:  # noqa: BLE001 - report, keep probing
            print(f"{name}: FAILED {type(e).__name__}: {e}", flush=True)
            return None

    def report(config):
        print(json.dumps({"perfprobe_ms": results, "config": config,
                          "device": dev, "card": card}), flush=True)

    if "--hetero" in sys.argv:
        # Heterogeneous-rig characterization: a mixed rig runs ONE fused
        # launch per group (runtime/app.py FusedGroup), dispatched back to
        # back in group build order each iteration, so the expected
        # per-iteration device cost is the SUM of the groups. This probe
        # measures each group's step alone and the pair dispatched together
        # (both bodies inside one scan harness) and reports pair/sum — ~1.0
        # means no cross-group interference, <1.0 means XLA overlapped work.
        def build_group(gw, gh, nb):
            return (_rig(nb, gh, gw), jnp.asarray(_tiled_scene(nb, gh, gw)),
                    jnp.zeros(nb, jnp.float32))

        # Geometry overrides let CI smoke-run the mode on CPU at small
        # sizes; the default is the deployed mixed rig.
        w1, h1 = _arg("--hetero-w1", 1600), _arg("--hetero-h1", 1304)
        w2, h2 = _arg("--hetero-w2", 1280), _arg("--hetero-h2", 800)
        step_a, f_a, g_a = build_group(w1, h1, 2)
        step_b, f_b, g_b = build_group(w2, h2, 2)
        t_a = probe(f"group_A_2x{w1}x{h1}", step_a, (f_a, g_a))
        t_b = probe(f"group_B_2x{w2}x{h2}", step_b, (f_b, g_b))
        t_ab = probe(
            "rig_pair_AB",
            lambda fa, ga, fb, gb: (step_a(fa, ga), step_b(fb, gb)),
            (f_a, g_a, f_b, g_b),
        )
        if t_a and t_b and t_ab:
            results["pair_vs_sum"] = t_ab / (t_a + t_b)
            print(f"pair/sum: {results['pair_vs_sum']:.3f}", flush=True)
        report({"hetero": [[2, h1, w1], [2, h2, w2]]})
        return

    # Default: the bench cell (4x1280x800 qd=2). --qd1: the reference's
    # deployed full-resolution geometry (2x1304x1600 qd=1). --batch /
    # --height / --width override either.
    qd = 1 if "--qd1" in sys.argv else 2
    b0, h0, w0 = (2, 1304, 1600) if qd == 1 else (BATCH, H, W)
    nb, gh, gw = _arg("--batch", b0), _arg("--height", h0), _arg("--width", w0)
    config = {"batch": nb, "height": gh, "width": gw, "quad_decimate": qd}
    frames = jnp.asarray(_tiled_scene(nb, gh, gw))
    print(f"shape: {frames.shape} quad_decimate={qd}", flush=True)

    det = make_detector(quad_decimate=qd)
    d = det(frames)
    ids = sorted(np.asarray(d.ids[0])[np.asarray(d.valid[0])].tolist())
    print(f"detect ids: {ids}", flush=True)
    t = probe("detect_full", det, (frames,))
    if t:
        results["fps_detect"] = nb / t * 1000

    # ---- stage 0: 2x2 mean decimation (qd=2 only) ------------------------
    h2, w2 = (gh // 8) * 8, (gw // 8) * 8

    def decimate(gray_batch):
        g = gray_batch[:, :h2, :w2]
        s = jax.lax.reduce_window(
            g.astype(jnp.uint16), jnp.uint16(0), jax.lax.add,
            window_dimensions=(1, 2, 2), window_strides=(1, 2, 2),
            padding="VALID",
        )
        return (s // 4).astype(jnp.uint8)

    if qd == 2:
        probe("decimate_2x2", decimate, (frames,))
        small = jax.jit(decimate)(frames)
    else:
        small = frames

    # ---- stage 1: threshold + CCL ----------------------------------------
    def threshold_label_fn(small):
        tern = adaptive_threshold(small)
        return tern, label_components(tern, iters=12)

    _, sh, sw = small.shape
    t = probe("threshold_ccl", threshold_label_fn, (small,))
    if t and not smoke:
        nbytes = stage_bytes("threshold_ccl", nb, sh, sw)
        results["threshold_ccl_bytes"] = nbytes
        results["threshold_ccl_hbm_share"] = hbm_share(nbytes, t, dev["kind"])
    tern, labels = jax.jit(threshold_label_fn)(small)

    # ---- stage 2: boundary extraction + block compaction -----------------
    def extract_compact(tern, labels):
        def one(tt, ll):
            black, white, payload = extract_boundary_points(tt, ll)
            return compact_candidates(black, white, payload, sw)

        return jax.vmap(one)(tern, labels)

    probe("extract_compact", extract_compact, (tern, labels))
    black, white, payload, dropped = jax.jit(extract_compact)(tern, labels)

    # ---- stage 3a: the hash + sort alone. Production fuses the whole batch
    # into ONE canonical 2-key sort with the frame index in the key's high
    # bits (cluster_candidates_batched); this probe mirrors it exactly ----
    def hash_sort(black, white, payload):
        bsz = black.shape[0]
        invalid = black == _INT_MAX
        key = (black * jnp.int32(-1640531527)) ^ (
            white * jnp.int32(-2048144789))
        key = key & _HASH_MASK
        key = jnp.where(key == _HASH_MASK, _HASH_MASK - 1, key)
        key = jnp.where(invalid, _HASH_MASK, key)
        fused = key | (jnp.arange(bsz, dtype=jnp.int32) << HASH_BITS)[:, None]
        sk, sp = jax.lax.sort(
            (fused.reshape(-1), payload.reshape(-1)),
            dimension=0, is_stable=False, num_keys=2)
        sk = sk.reshape(bsz, -1) & _HASH_MASK
        sk = jnp.where(sk == _HASH_MASK, _INT_MAX, sk)
        return sk, sp.reshape(bsz, -1)

    probe("cluster_sort", hash_sort, (black, white, payload))

    # ---- stage 3b: segment stats (post-sort) -----------------------------
    s_key, s_payload = jax.jit(hash_sort)(black, white, payload)
    s_key = s_key[:, :MAX_EDGE_POINTS]
    s_payload = s_payload[:, :MAX_EDGE_POINTS]
    probe("segment_stats", jax.vmap(segment_stats), (s_key, s_payload))

    # ---- stage 3: the whole cluster stage (production = the BATCHED fused
    # path) ------------------------------------------------------------------
    t = probe("cluster_total", cluster_candidates_batched,
              (black, white, payload))
    if t and not smoke:
        nbytes = stage_bytes("cluster_total", nb, sh, sw,
                             n_cand=int(black.shape[1]), k=MAX_CLUSTERS,
                             p=MAX_CLUSTER_POINTS)
        results["cluster_total_bytes"] = nbytes
        results["cluster_total_hbm_share"] = hbm_share(nbytes, t, dev["kind"])
    results["candidates_per_frame"] = int(black.shape[1])
    results["compact_slack"] = COMPACT_SLACK
    clusters = jax.jit(cluster_candidates_batched)(black, white, payload)

    # ---- stage 4: quad fit ------------------------------------------------
    def quads_fn(points, mask, valid):
        return jax.vmap(fit_quads)(points, mask, valid)

    probe("quad_fit", quads_fn, (clusters.points, clusters.mask,
                                 clusters.valid))
    quads = jax.jit(quads_fn)(clusters.points, clusters.mask, clusters.valid)

    # ---- stage 5/6: refine + decode on the compacted candidates ----------
    kq = 32
    score = jnp.where(quads.valid, clusters.count, jnp.int32(-1))
    _, sel = jax.lax.top_k(score, kq)
    q_corners = jnp.take_along_axis(quads.corners, sel[..., None, None], axis=1)
    if qd == 2:
        q_corners = q_corners * 2.0 + 0.5
    q_valid = jnp.take_along_axis(quads.valid, sel, axis=1)

    probe("pack_neighborhood", pack_neighborhood, (frames,))
    packed = jax.jit(pack_neighborhood)(frames)

    def refine_fn(packed, corners, valid):
        return jax.vmap(refine_quads)(packed, corners, valid)

    probe("refine", refine_fn, (packed, q_corners, q_valid), perturb_idx=1)
    r_corners = jax.jit(refine_fn)(packed, q_corners, q_valid)

    decode = make_decoder(load_family("tag36h11"), bits_corrected=3)

    def decode_fn(packed, corners, valid):
        return jax.vmap(decode)(packed, corners, valid)

    probe("decode", decode_fn, (packed, r_corners, q_valid), perturb_idx=1)

    # ---- post-cluster tail as one unit (quad->refine->decode->dedup) -----
    finish = make_post_cluster(decode, quad_decimate=qd)

    def finish_fn(gray, points, mask, count, valid, dropped):
        cl = Clusters(points=points, mask=mask, count=count, valid=valid,
                      dropped=dropped)
        return finish(gray, cl)

    probe("post_cluster_total", finish_fn,
          (frames, clusters.points, clusters.mask, clusters.count,
           clusters.valid, clusters.dropped), perturb_idx=1)

    # ---- full fused step (detect + solve); solve = step - detect ---------
    step = _rig(nb, gh, gw, detector_kwargs={"quad_decimate": qd})
    gyro = jnp.zeros(nb, jnp.float32)
    probe("full_step", lambda f, g: step(f, g), (frames, gyro))

    if "full_step" in results and "detect_full" in results:
        results["solve_est"] = results["full_step"] - results["detect_full"]
        print(f"solve (step - detect): {results['solve_est']:.4f} ms",
              flush=True)
    report(config)


if __name__ == "__main__":
    main()
