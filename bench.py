"""Benchmark: fused batched detect+pose throughput on one GPU.

Measures BASELINE config #5's shape: a 4-camera batch of 1280x800 grayscale
frames with real 36h11 tags through the full fused pipeline (threshold ->
CCL -> cluster -> quad -> refine -> decode -> unproject -> SQPnP), steady
state, on the GPU JAX provides. Without a GPU it exits non-zero: a CPU
number is never reported under this metric.

Prints ONE JSON line: {"metric", "value", "unit", "step_ms", "compile_s",
"device", "card"} — the device as JAX reports it and the card's name and
power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

H, W = 800, 1280
BATCH = 4
REPS = 3
# Steps inside ONE lax.scan dispatch: the per-call wall time is dispatch +
# ITERS * step, so the fixed dispatch cost shrinks to noise per step.
ITERS = 100


def build_scene():
    """Render a 1280x800 frame with several 36h11 tags at varied poses."""
    from chalkydri_tpu.detector import load_family
    from chalkydri_tpu.tools.scene import place_tag

    fam = load_family("tag36h11")
    canvas = np.full((H, W), 150, np.uint8)
    quads = {
        1: np.array([[150, 500], [330, 500], [330, 320], [150, 320]], np.float32),
        5: np.array([[520, 560], [700, 530], [690, 360], [530, 390]], np.float32),
        9: np.array([[880, 480], [1020, 480], [1020, 340], [880, 340]], np.float32),
        13: np.array([[1080, 700], [1220, 690], [1215, 560], [1085, 570]], np.float32),
    }
    for tid, q in quads.items():
        place_tag(canvas, fam, tid, q)
    return canvas


def bench_step(frames_np):
    """(fps, step_ms, compile_s, detections in frame 0) of the fused step."""
    import jax
    import jax.numpy as jnp

    from chalkydri_tpu.tools.perfprobe import _rig

    step = _rig(BATCH, H, W)
    frames = jnp.asarray(frames_np)
    gyro = jnp.zeros(BATCH, jnp.float32)

    out = step(frames, gyro)
    n_det = int(np.asarray(out.detections.valid[0]).sum())

    # ITERS steps inside ONE lax.scan dispatch with a per-iteration input
    # perturbation (LSB toggle) so nothing is hoisted; a host fetch of the
    # reduced result ends each timed call.
    @jax.jit
    def many(frames, gyro):
        def body(c, i):
            f = frames ^ (i % 2).astype(frames.dtype)
            o = step(f, gyro)
            leaves = jax.tree_util.tree_leaves(o)
            s = sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)
            return c + s, None
        c, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(ITERS))
        return c

    t0 = time.perf_counter()
    float(many(frames, gyro))  # compile + drain
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        float(many(frames, gyro))  # fetch forces completion
        best = min(best, (time.perf_counter() - t0) / ITERS)
    return BATCH / best, best * 1e3, compile_s, n_det


def main():
    from chalkydri_tpu.utils.cache import enable_compile_cache
    from chalkydri_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()
    card = gpu_name_and_power_limit()
    enable_compile_cache()
    frame = build_scene()
    frames = np.broadcast_to(frame, (BATCH, H, W)).copy()
    fps, step_ms, compile_s, n_det = bench_step(frames)
    print(
        json.dumps(
            {
                "metric": "fps_1280x800_batch4_detect_pose",
                "value": fps,
                "unit": "frames/sec",
                "step_ms": step_ms,
                "compile_s": compile_s,
                "device": dev,
                "card": card,
            }
        )
    )
    print(f"# detections_frame0={n_det}/4 batch={BATCH}", file=sys.stderr)


if __name__ == "__main__":
    main()
