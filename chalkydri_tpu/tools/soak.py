"""Soak test: run the production loop for a while and report health.

Competition matches are ~2:30 but the coprocessor runs all event long; this
tool drives the real App loop (synthetic cameras by default, real ones when
present) and reports sustained iteration rate, publish counts, latency
percentiles, memory stability (RSS drift), and span timings — the numbers
an operator checks before trusting a setup.

Run:  python -m chalkydri_tpu.tools.soak [--seconds 60] [--graph g.ron]
      [--cams N] [--width W] [--height H]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _malloc_trim() -> None:
    """Return free glibc arena pages to the OS (best-effort) so the RSS
    drift metric measures REACHABLE memory, not allocator slack: long
    multi-thread runs grow per-thread arenas whose free chunks glibc keeps,
    which reads as a multi-GB 'leak' that isn't one (verified by bisection:
    the loop's Python/JAX object graph is flat after warmup)."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:
        pass


def _measure_latency_spans(app, reps: int = 30) -> dict:
    """Decompose capture->publish latency into individually MEASURED spans
    (median of ``reps`` each): host capture, H2D put, device step, D2H
    fetch, host publish. Each device boundary ends in
    ``block_until_ready`` or a host fetch, so a span is the time the host
    waits for it."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from chalkydri_tpu.tools.perfprobe import devtime

    if not app.groups:
        return {}
    g = app.groups[0]
    frames = np.ascontiguousarray(g.frames_buf)
    gyro = np.zeros(frames.shape[0], np.float32)

    def p50(walls):
        return float(np.median(walls)) * 1000.0

    # Host capture: the real camera poll (synthetic: render-cache lookup).
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        app._poll_cameras()
        walls.append(time.perf_counter() - t0)
    capture_ms = p50(walls)

    # H2D put of the staged frame batch.
    walls = []
    for i in range(reps):
        frames[0, 0, 0] ^= 1  # defeat transfer caching
        t0 = time.perf_counter()
        jax.device_put(frames).block_until_ready()
        walls.append(time.perf_counter() - t0)
    h2d_ms = p50(walls)

    # Device step: the scan harness of tools/perfprobe.py.
    step_ms = devtime(g.step, (jnp.asarray(frames), jnp.asarray(gyro)), n=50)

    # D2H fetch: the production small-fields fetch on a resident output.
    out = g.step(jnp.asarray(frames), jnp.asarray(gyro))
    host_out = app._fetch_small(out)  # forces completion
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        host_out = app._fetch_small(out)
        walls.append(time.perf_counter() - t0)
    d2h_ms = p50(walls)

    # Host publish: packet build + UDP send for every chain — pointed at
    # a throwaway sink so these ~reps*len(chains) packets never land in
    # the soak's rio socket and pollute its packets_rx/latency counters
    # (the iteration loop is what those characterize).
    from chalkydri_tpu.io.whacknet import Comm

    null_comm = Comm(remote_addr="127.0.0.1", remote_port=1, gyro_port=0)
    real_comm, app._comm = app._comm, null_comm
    try:
        now = app.clock.now_us()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for b, ch in enumerate(g.chains):
                app._publish_with(ch, host_out, b, True, now)
            walls.append(time.perf_counter() - t0)
        publish_ms = p50(walls)
    finally:
        app._comm = real_comm
        null_comm.close()

    return {
        "host_capture_ms": capture_ms,
        "h2d_put_ms": h2d_ms,
        "h2d_bytes": int(frames.nbytes),
        "device_step_ms": step_ms,
        "d2h_fetch_ms": d2h_ms,
        "host_publish_ms": publish_ms,
    }


def _default_graph(n_cams: int, width: int, height: int):
    from chalkydri_tpu.runtime.graph import TaskGraph

    calib = {
        "fx": width * 0.86, "fy": width * 0.86,
        "cx": width / 2, "cy": height / 2,
        "k1": 0, "k2": 0, "p1": 0, "p2": 0, "k3": 0,
        "width": width, "height": height,
    }
    tasks, cnx = [], []
    for i in range(n_cams):
        tasks.append({"id": f"camera_{i}", "type": "CamPipeline",
                      "config": {"id": f"soak-missing-{i}", "name": f"cam{i}",
                                 "width": width, "height": height}})
        tasks.append({
            "id": f"apriltags_{i}", "type": "chalkydri_apriltags::AprilTags",
            "config": {
                "cam_id": i,
                "calib": json.dumps({"OpenCVModel5": calib}),
                "robot_to_cam": json.dumps(
                    {"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": 0.5}
                ),
            },
        })
        cnx.append({"src": f"camera_{i}", "dst": f"apriltags_{i}", "msg": "f"})
    return TaskGraph.from_dict(
        {"tasks": tasks, "cnx": cnx,
         "resources": [{"id": "comm", "provider": "whacknet::CommBundle"}]}
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chalkydri-soak", description=__doc__)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--graph", default=None, help="RON graph (default: synthetic)")
    p.add_argument("--cams", type=int, default=2)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--field", default=None)
    p.add_argument("--rate", type=float, default=None, help="Hz cap")
    p.add_argument("--json", action="store_true", help="one-line JSON report")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="App async-dispatch depth: 1 overlaps capture with "
                        "device compute (throughput mode), 0 publishes the "
                        "same iteration's frames (latency mode)")
    p.add_argument("--no-decompose", action="store_true",
                   help="skip the per-span latency decomposition pass")
    args = p.parse_args(argv)

    import socket

    import numpy as np

    from chalkydri_tpu.io.whacknet import Comm, decode_measurement
    from chalkydri_tpu.runtime.app import App
    from chalkydri_tpu.runtime.graph import TaskGraph
    from chalkydri_tpu.utils.cache import enable_compile_cache
    from chalkydri_tpu.utils.tracing import SPANS

    enable_compile_cache()

    # loopback robot endpoint so publish really exercises the wire path
    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.bind(("127.0.0.1", 0))
    rio.setblocking(False)
    port = rio.getsockname()[1]

    graph = (
        TaskGraph.load(args.graph) if args.graph
        else _default_graph(args.cams, args.width, args.height)
    )
    layout = None
    if args.field:
        import jax.numpy as jnp

        from chalkydri_tpu.geometry.field_layout import load_field_layout

        layout = load_field_layout(args.field, dtype=jnp.float32)
    else:
        import jax.numpy as jnp

        from chalkydri_tpu.geometry.field_layout import parse_field_layout

        tags = [{"ID": t, "pose": {
            "translation": {"x": 10, "y": 4, "z": 1},
            "rotation": {"quaternion": {"W": 0, "X": 0, "Y": 0, "Z": 1}}}}
            for t in (3, 4)]
        layout = parse_field_layout(
            {"tags": tags, "field": {"length": 16.5, "width": 8.0}},
            dtype=jnp.float32,
        )

    comm = Comm(remote_addr="127.0.0.1", remote_port=port, gyro_port=0,
                use_native=False)
    app = App(graph, field_layout=layout, comm=comm,
              pipeline_depth=args.pipeline_depth)
    app.start_all_tasks()

    iter_times = []
    rx_packets = 0
    rx_with_tags = 0
    rx_latency_us = []  # capture(tov) -> publish wall latency, from the
    #                     packet's own ts field (apriltags/src/lib.rs:351)
    rss0 = None
    t_end = None  # set after the first iteration: the soak window measures
    #               steady state, not the one-time jit compile
    period = 1.0 / args.rate if args.rate else 0.0
    print(f"soaking for {args.seconds:.0f}s ...", file=sys.stderr)
    try:
        while t_end is None or time.monotonic() < t_end:
            t0 = time.monotonic()
            app.run_one_iteration()
            iter_times.append(time.monotonic() - t0)
            if t_end is None:
                t_end = time.monotonic() + args.seconds
                rss0 = _rss_mb()  # baseline right after the compile iter
            if len(iter_times) == 10:
                _malloc_trim()  # symmetric with the end-of-run measurement
                rss0 = _rss_mb()  # refine after warmup when we get there
            while True:
                try:
                    data, _ = rio.recvfrom(64)
                except BlockingIOError:
                    break
                rx_packets += 1
                _, _, ts_us, _, n = decode_measurement(data)
                rx_with_tags += int(n > 0)
                # Every packet (pose or heartbeat) carries its frame's
                # tov->publish delta; synthetic soak scenes deliberately
                # don't match the field layout, so their packets are
                # heartbeats — still the true capture->wire latency when
                # the frame was fresh. Stale-camera heartbeats re-stamp an
                # old tov (latency >> 1 s); exclude those, keep warm ones.
                if len(iter_times) > 5 and ts_us < 1_000_000:
                    rx_latency_us.append(ts_us)
            if os.environ.get("CHALKYDRI_SOAK_DEBUG") and \
                    len(iter_times) % 100 == 0:
                import jax

                la = jax.live_arrays()
                print(
                    f"debug iter {len(iter_times)}: rss {_rss_mb():.0f} MB, "
                    f"live_arrays n={len(la)} "
                    f"mb={sum(a.nbytes for a in la) / 1e6:.1f}",
                    file=sys.stderr, flush=True,
                )
            if period:
                dt = time.monotonic() - t0
                if dt < period:
                    time.sleep(period - dt)
    except KeyboardInterrupt:
        # an interrupted long soak still reports on what it collected
        print("interrupted — reporting partial soak", file=sys.stderr)
    finally:
        latency_spans = {}
        if not args.no_decompose:
            try:
                latency_spans = _measure_latency_spans(app)
            except Exception as e:  # decomposition must never kill a soak
                latency_spans = {"error": str(e)[:200]}
        app.stop_all_tasks()
        comm.close()
        rio.close()

    # drop compile iterations when the run is long enough to have any left
    warm = iter_times[5:] if len(iter_times) > 5 else iter_times
    it = np.array(warm if warm else [float("nan")])
    rss_raw = _rss_mb()
    _malloc_trim()
    rss1 = _rss_mb()
    lat = np.array(rx_latency_us, np.float64) / 1000.0  # -> ms
    from chalkydri_tpu.utils.device import (
        device_info,
        gpu_name_and_power_limit,
    )

    report = {
        "device": device_info(),
        "card": gpu_name_and_power_limit(),
        "iterations": len(iter_times),
        "pipeline_depth": args.pipeline_depth,
        "sustained_hz": round(1.0 / max(float(np.median(it)), 1e-9), 1),
        "iter_ms_p50": round(float(np.median(it)) * 1000, 2),
        "iter_ms_p99": round(float(np.quantile(it, 0.99)) * 1000, 2),
        # End-to-end latency SLO: each packet carries its own capture(tov)
        # -> publish delta in its ts field (apriltags/src/lib.rs:351); over
        # loopback UDP this IS the capture -> robot-packet wall latency.
        "capture_to_udp_ms_p50": (
            round(float(np.median(lat)), 2) if lat.size else None
        ),
        "capture_to_udp_ms_p99": (
            round(float(np.quantile(lat, 0.99)), 2) if lat.size else None
        ),
        "capture_to_udp_ms_p999": (
            round(float(np.quantile(lat, 0.999)), 2) if lat.size else None
        ),
        "packets_rx": rx_packets,
        "packets_with_tags": rx_with_tags,
        # Detector capacity health: >0 means scenes exceeded the candidate
        # compaction budget and the degradation mode is active.
        "dropped_candidates": app.dropped_points_total,
        "rss_mb_start": round(rss0 or 0.0, 1),
        "rss_mb_end": round(rss1, 1),  # post-malloc_trim: reachable memory
        "rss_mb_end_untrimmed": round(rss_raw, 1),  # incl. allocator slack
        "rss_drift_mb": round(rss1 - (rss0 or rss1), 1),
        "spans": {
            k: {kk: round(vv, 2) for kk, vv in v.items()}
            for k, v in SPANS.summary().items()
        },
        # Individually measured capture/H2D/step/D2H/publish spans (see
        # _measure_latency_spans).
        "latency_spans": latency_spans,
    }
    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
