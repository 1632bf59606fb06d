"""Smoke test of the fused detect->pose path on one NVIDIA GPU.

    python chip_smoke.py

One process, four phases in order; any failed phase exits non-zero
without printing the success line:

(a) device: JAX's default device must be a GPU (prints it and the card's
    name and power limit from nvidia-smi).
(b) app: the path ``python -m chalkydri_tpu.main`` runs — ``App`` with the
    example graph (examples/chalkydri.ron: 2x1280x800 synthetic cameras)
    and the 2026 field layout — for ~50 iterations, its 64-byte packets
    sent to a loopback robot socket and decoded there.
(c) correctness: clean field scenes rendered in numpy at 4x1280x800 qd=2,
    2x1600x1304 qd=2 and 2x1600x1304 qd=1 through ``make_vision_pipeline``
    on the GPU, checked against ground truth, against the same program on
    the CPU in this process, and (solver) against the f64 reference
    SQPnP in tests/reference_impl/ref_sqpnp.py.
(d) step time and memory at 4x1280x800: compile time (set-up), steady
    step time, the compiled program's memory analysis and the device's
    peak bytes in use — reported, not checked.

Last line of stdout on success:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIELD_JSON = os.path.join(REPO, "examples", "field_2026.json")
GRAPH_RON = os.path.join(REPO, "examples", "chalkydri.ron")
CAM_HEIGHT = 1.0  # m; the field's tags hang at 1.22 m

# Tolerances, each with its reason (printed by phase c). Same program on
# GPU vs CPU: float32 reductions run in a different order (and
# default-precision matmuls may use TF32 on the GPU), so sub-pixel values
# agree to float32 noise, far inside the truth gate.
TOL = {
    "corner_vs_truth_px": (0.1, "README detector gate, clean scene"),
    "pose_xy_vs_truth_m": (0.02, "TestFusedPipeline bound"),
    "pose_yaw_vs_truth_rad": (0.01, "TestFusedPipeline bound"),
    "corner_gpu_vs_cpu_px": (0.02, "float32 order / TF32, << truth gate"),
    "pose_xy_gpu_vs_cpu_m": (2e-3, "float32 order / TF32"),
    "pose_yaw_gpu_vs_cpu_rad": (2e-3, "float32 order / TF32"),
    "pose_xy_vs_ref_sqpnp_m": (2e-3, "float32 device solve vs f64 reference"),
    "pose_yaw_vs_ref_sqpnp_rad": (2e-3, "float32 device solve vs f64 reference"),
}

# (name, batch, height, width, quad_decimate, fx)
GEOMETRIES = [
    ("4x1280x800_qd2", 4, 800, 1280, 2, 900.0),
    ("2x1600x1304_qd2", 2, 1304, 1600, 2, 1100.0),
    ("2x1600x1304_qd1", 2, 1304, 1600, 1, 1100.0),
]


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


# --------------------------------------------------------------------------
# numpy scene renderer (ground truth independent of the code under test)
# --------------------------------------------------------------------------

def quat_to_matrix(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def load_tags(path=FIELD_JSON):
    """{id: (R [3, 3], t [3])} world poses from a WPILib field layout."""
    with open(path) as f:
        d = json.load(f)
    tags = {}
    for t in d["tags"]:
        q = t["pose"]["rotation"]["quaternion"]
        tr = t["pose"]["translation"]
        tags[int(t["ID"])] = (quat_to_matrix(q["W"], q["X"], q["Y"], q["Z"]),
                              np.array([tr["x"], tr["y"], tr["z"]], float))
    return tags


def tag_corners_world(rot, t, size=0.1651):
    """Corners [4, 3]: tag frame YZ plane, +X the outward normal, order
    BL, BR, TR, TL as seen facing the tag."""
    s = size / 2.0
    offs = np.array([[0, -s, -s], [0, s, -s], [0, s, s], [0, -s, s]], float)
    return offs @ rot.T + t


def project(points_w, robot_xy, robot_yaw, calib):
    """World points [N, 3] -> pixels [N, 2] and depth [N] for a camera
    CAM_HEIGHT above the robot origin looking along the robot's +x
    (pinhole; the calibrations here carry no distortion)."""
    c, s = np.cos(robot_yaw), np.sin(robot_yaw)
    d = points_w - np.array([robot_xy[0], robot_xy[1], CAM_HEIGHT])
    fwd = c * d[:, 0] + s * d[:, 1]
    left = -s * d[:, 0] + c * d[:, 1]
    up = d[:, 2]
    u = calib["fx"] * (-left / fwd) + calib["cx"]
    v = calib["fy"] * (-up / fwd) + calib["cy"]
    return np.stack([u, v], axis=1), fwd


def wall_pairs(tags):
    """Pairs of same-facing tags, nearest neighbours first."""
    ids = sorted(tags)
    pairs = []
    for k, i in enumerate(ids):
        for j in ids[k + 1:]:
            if np.allclose(tags[i][0], tags[j][0], atol=1e-6):
                pairs.append((float(np.linalg.norm(tags[i][1] - tags[j][1])),
                              i, j))
    pairs.sort()
    return [(i, j) for _, i, j in pairs]


def view_pose(tags, pair, calib, spread, lateral=0.0):
    """Robot (x, y) and yaw facing the pair squarely along its normal, far
    enough back that the pair spans ``spread`` of the half field of view."""
    (ri, ti), (_, tj) = tags[pair[0]], tags[pair[1]]
    n = ri[:, 0].copy()
    n[2] = 0.0
    n /= np.linalg.norm(n)
    mid = (ti + tj) / 2.0
    half = np.linalg.norm((ti - tj)[:2]) / 2.0
    dist = max(1.2, half / (spread * calib["cx"] / calib["fx"]))
    side = np.array([-n[1], n[0], 0.0])
    xy = (mid + n * dist + side * lateral)[:2]
    return xy, float(np.arctan2(-n[1], -n[0]))


def render_field_frames(tags, batch, h, w, fx, cell_px=16):
    """[batch, h, w] clean uint8 frames, frame b viewing its own tag wall.

    Returns (frames, truth): truth[b] = {"xy", "yaw", "corners": {id: [4, 2]}}.
    """
    from chalkydri_tpu.detector import load_family
    from chalkydri_tpu.tools.scene import place_tag

    fam = load_family("tag36h11")
    calib = {"fx": fx, "fy": fx, "cx": w / 2.0, "cy": h / 2.0}
    pairs = wall_pairs(tags)
    frames = np.full((batch, h, w), 150, np.uint8)
    truth = []
    for b in range(batch):
        pair = pairs[b % len(pairs)]
        xy, yaw = view_pose(tags, pair, calib, spread=0.6 + 0.05 * b,
                            lateral=0.05 * (b % 3 - 1))
        corners = {}
        for tid in pair:
            pix, depth = project(tag_corners_world(*tags[tid]), xy, yaw, calib)
            if not (depth > 0).all():
                raise ValueError(f"tag {tid} behind the camera")
            corners[tid] = place_tag(frames[b], fam, tid, pix, cell_px)
        truth.append({"xy": xy, "yaw": yaw, "corners": corners})
    return frames, truth


def rig_cameras(batch, h, w, fx):
    calib = {"fx": fx, "fy": fx, "cx": w / 2.0, "cy": h / 2.0,
             "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
             "width": w, "height": h}
    r2c = {"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": CAM_HEIGHT}
    return [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps(r2c)}] * batch


# --------------------------------------------------------------------------
# comparators (host arrays in, worst errors out)
# --------------------------------------------------------------------------

def wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def host(out):
    """VisionOutput -> dict of numpy arrays."""
    d = out.detections
    return {"pose_x": np.asarray(out.pose_x), "pose_y": np.asarray(out.pose_y),
            "pose_yaw": np.asarray(out.pose_yaw),
            "pose_valid": np.asarray(out.pose_valid),
            "tag_count": np.asarray(out.tag_count),
            "ids": np.asarray(d.ids), "corners": np.asarray(d.corners),
            "valid": np.asarray(d.valid)}


def compare_to_truth(o, truth):
    """Worst corner / pose errors of one batch's output against the scene's
    ground truth; raises PhaseFailed on a wrong id set or invalid pose."""
    worst = {"corner_px": 0.0, "xy_m": 0.0, "yaw_rad": 0.0}
    for b, t in enumerate(truth):
        got = {int(i): o["corners"][b, k]
               for k, i in enumerate(o["ids"][b]) if o["valid"][b, k]}
        check(sorted(got) == sorted(t["corners"]),
              f"frame {b}: ids {sorted(got)} != truth {sorted(t['corners'])}")
        for tid, c in t["corners"].items():
            worst["corner_px"] = max(worst["corner_px"],
                                     float(np.abs(got[tid] - c).max()))
        check(bool(o["pose_valid"][b]), f"frame {b}: pose invalid")
        check(int(o["tag_count"][b]) == len(t["corners"]),
              f"frame {b}: tag_count {int(o['tag_count'][b])}")
        xy = np.array([o["pose_x"][b], o["pose_y"][b]])
        worst["xy_m"] = max(worst["xy_m"], float(np.abs(xy - t["xy"]).max()))
        worst["yaw_rad"] = max(worst["yaw_rad"],
                               abs(float(wrap(o["pose_yaw"][b] - t["yaw"]))))
    return worst


def compare_outputs(a, b):
    """Worst differences between two runs of the same program; raises
    PhaseFailed unless ids, valid and tag_count are identical."""
    for k in ("ids", "valid", "tag_count", "pose_valid"):
        check(np.array_equal(a[k], b[k]), f"{k} differ: {a[k]} vs {b[k]}")
    m = a["valid"]
    corner = float(np.abs(a["corners"] - b["corners"])[m].max()) if m.any() \
        else 0.0
    xy = float(max(np.abs(a["pose_x"] - b["pose_x"]).max(),
                   np.abs(a["pose_y"] - b["pose_y"]).max()))
    yaw = float(np.abs(wrap(a["pose_yaw"] - b["pose_yaw"])).max())
    return {"corner_px": corner, "xy_m": xy, "yaw_rad": yaw}


def compare_to_ref_sqpnp(o, tags, calib, truth):
    """The f64 reference SQPnP on the device's own detections (pinhole rays
    from its corners) vs the device's pose: worst xy / yaw differences."""
    import importlib.util

    from chalkydri_tpu.solver.robot_pose import SIGN_FLIP_CONST

    # Loaded by path: an installed package named ``tests`` would shadow
    # this repo's (namespace) tests package.
    spec = importlib.util.spec_from_file_location(
        "ref_sqpnp",
        os.path.join(REPO, "tests", "reference_impl", "ref_sqpnp.py"))
    ref_sqpnp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_sqpnp)

    rc = ref_sqpnp.create_solver_camera_transform(0, 0, CAM_HEIGHT, 0, 0, 0)
    worst = {"xy_m": 0.0, "yaw_rad": 0.0}
    for b, t in enumerate(truth):
        isos, rays = [], []
        for k, tid in enumerate(o["ids"][b]):
            if not o["valid"][b, k] or int(tid) not in tags:
                continue
            isos.append(tags[int(tid)])
            c = o["corners"][b, k].astype(np.float64)
            rays.extend(np.stack([(c[:, 0] - calib["cx"]) / calib["fx"],
                                  (c[:, 1] - calib["cy"]) / calib["fy"],
                                  np.ones(4)], axis=1))
        ref = ref_sqpnp.RefSqPnP().solve_robot_pose(isos, np.array(rays), rc, t["yaw"],
                                          SIGN_FLIP_CONST)
        check(ref is not None, f"frame {b}: reference SQPnP found no pose")
        rot, pos, _ = ref
        xy = np.array([o["pose_x"][b], o["pose_y"][b]])
        worst["xy_m"] = max(worst["xy_m"], float(np.abs(xy - pos[:2]).max()))
        yaw = np.arctan2(rot[1, 0], rot[0, 0])
        worst["yaw_rad"] = max(worst["yaw_rad"],
                               abs(float(wrap(o["pose_yaw"][b] - yaw))))
    return worst


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    from chalkydri_tpu.utils.device import (
        device_info,
        gpu_name_and_power_limit,
    )

    info = device_info()
    print(f"[a] device: {json.dumps(info)}", flush=True)
    print(f"[a] card: {gpu_name_and_power_limit()}", flush=True)
    check(info["platform"] == "gpu",
          f"JAX's default device is {info['platform']}, not a GPU")
    return info


def phase_app(graph=GRAPH_RON, iters=50):
    import socket

    import jax.numpy as jnp

    from chalkydri_tpu.geometry.field_layout import load_field_layout
    from chalkydri_tpu.io.whacknet import PACKET_SIZE, Comm, decode_measurement
    from chalkydri_tpu.runtime.app import App
    from chalkydri_tpu.runtime.graph import TaskGraph

    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.bind(("127.0.0.1", 0))
    rio.setblocking(False)
    comm = Comm(remote_addr="127.0.0.1", remote_port=rio.getsockname()[1],
                gyro_port=0, use_native=False)
    app = App(TaskGraph.load(graph),
              field_layout=load_field_layout(FIELD_JSON, dtype=jnp.float32),
              comm=comm)
    packets = with_tags = valid_poses = frames = published = 0

    def tick():
        nonlocal packets, with_tags, valid_poses, frames, published
        out = app.run_one_iteration()
        for o in (out if isinstance(out, list) else [out]):
            if o is not None:
                published += 1
                pv = np.asarray(o.pose_valid)
                frames += pv.size
                valid_poses += int(pv.sum())
        while True:
            try:
                data, _ = rio.recvfrom(256)
            except BlockingIOError:
                break
            check(len(data) == PACKET_SIZE, f"packet of {len(data)} bytes")
            _, _, _, _, n = decode_measurement(data)
            packets += 1
            with_tags += int(n > 0)

    try:
        # Set-up: start the tasks and run until the first published output
        # (the fused program compiles on its first dispatch).
        t0 = time.perf_counter()
        app.start_all_tasks()
        while published == 0 and time.perf_counter() - t0 < 600:
            tick()
        print(f"[b] set-up (start + compile + first output): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        # Steady: the synthetic cameras emit 30 frames/s, so the loop is
        # paced to that rate and each iteration has fresh frames.
        published = 0
        t0 = time.perf_counter()
        for i in range(iters):
            tick()
            lag = t0 + (i + 1) / 30.0 - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        dt = time.perf_counter() - t0
    finally:
        app.stop_all_tasks()
        comm.close()
        rio.close()
    print(f"[b] {iters} iterations in {dt:.3f} s = {iters / dt:.3f} it/s, "
          f"{published} published outputs; packets decoded {packets} "
          f"({with_tags} with tags); valid poses {valid_poses}/{frames} "
          f"frames", flush=True)
    check(packets > 0, "no packet reached the loopback robot socket")
    check(with_tags > 0, "no packet carried a tag")
    check(published >= iters // 2, f"only {published} published outputs")
    check(valid_poses > 0, "no valid pose")


def phase_correctness(tags, geometries=GEOMETRIES):
    import jax
    import jax.numpy as jnp

    from chalkydri_tpu.geometry.field_layout import load_field_layout
    from chalkydri_tpu.pipeline import build_rig_from_config, make_vision_pipeline

    for k, (v, why) in TOL.items():
        print(f"[c] tolerance {k} = {v} ({why})", flush=True)
    cpu = jax.devices("cpu")[0]
    for name, batch, h, w, qd, fx in geometries:
        frames, truth = render_field_frames(tags, batch, h, w, fx)
        gyro = np.array([t["yaw"] for t in truth], np.float32)
        cams = rig_cameras(batch, h, w, fx)
        dk = {"quad_decimate": qd}
        outs = []
        for dev in (jax.devices()[0], cpu):
            with jax.default_device(dev):
                layout = load_field_layout(FIELD_JSON, dtype=jnp.float32)
                params, rc = build_rig_from_config(cams, layout)
                step = make_vision_pipeline(layout, params, rc,
                                            detector_kwargs=dk)
                t0 = time.perf_counter()
                out = step(jax.device_put(frames, dev),
                           jax.device_put(gyro, dev))
                outs.append(host(out))
                print(f"[c] {name} on {dev.platform}: first call "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
        g = outs[0]
        truth_err = compare_to_truth(g, truth)
        cpu_err = compare_outputs(g, outs[1])
        calib = {"fx": fx, "fy": fx, "cx": w / 2.0, "cy": h / 2.0}
        ref_err = compare_to_ref_sqpnp(g, tags, calib, truth)
        print(f"[c] {name}: vs truth {json.dumps(truth_err)}; gpu vs cpu "
              f"{json.dumps(cpu_err)}; vs ref_sqpnp {json.dumps(ref_err)}",
              flush=True)
        for tol, err, key in (
                ("corner_vs_truth_px", truth_err, "corner_px"),
                ("pose_xy_vs_truth_m", truth_err, "xy_m"),
                ("pose_yaw_vs_truth_rad", truth_err, "yaw_rad"),
                ("corner_gpu_vs_cpu_px", cpu_err, "corner_px"),
                ("pose_xy_gpu_vs_cpu_m", cpu_err, "xy_m"),
                ("pose_yaw_gpu_vs_cpu_rad", cpu_err, "yaw_rad"),
                ("pose_xy_vs_ref_sqpnp_m", ref_err, "xy_m"),
                ("pose_yaw_vs_ref_sqpnp_rad", ref_err, "yaw_rad")):
            check(err[key] < TOL[tol][0], f"{name}: {tol} = {err[key]}")


def phase_step_time(tags, geometry=GEOMETRIES[0], n=50):
    import jax
    import jax.numpy as jnp

    from chalkydri_tpu.geometry.field_layout import load_field_layout
    from chalkydri_tpu.pipeline import build_rig_from_config, make_vision_pipeline

    name, batch, h, w, qd, fx = geometry
    frames, truth = render_field_frames(tags, batch, h, w, fx)
    layout = load_field_layout(FIELD_JSON, dtype=jnp.float32)
    params, rc = build_rig_from_config(rig_cameras(batch, h, w, fx), layout)
    step = make_vision_pipeline(layout, params, rc,
                                detector_kwargs={"quad_decimate": qd})
    f = jax.device_put(frames)
    g = jax.device_put(np.array([t["yaw"] for t in truth], np.float32))
    t0 = time.perf_counter()
    compiled = step.lower(f, g).compile()
    print(f"[d] {name}: compile {time.perf_counter() - t0:.3f} s (set-up)",
          flush=True)
    print(f"[d] memory_analysis: {compiled.memory_analysis()}", flush=True)
    jax.block_until_ready(compiled(f, g))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(f, g))
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(n):
        out = compiled(f, g)
    jax.block_until_ready(out)
    pipelined = (time.perf_counter() - t0) / n
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[d] {name}: step (dispatch to ready) median "
          f"{np.median(times) * 1e3:.4f} ms, min {min(times) * 1e3:.4f} ms; "
          f"back-to-back {pipelined * 1e3:.4f} ms/step = "
          f"{batch / pipelined:.1f} frames/s", flush=True)
    print(f"[d] peak_bytes_in_use: {stats.get('peak_bytes_in_use')}",
          flush=True)


def main() -> int:
    # Keep the CPU backend beside the GPU for phase (c)'s comparison; the
    # first listed platform stays JAX's default.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, REPO)

    from chalkydri_tpu.utils.cache import enable_compile_cache

    try:
        info = phase_device()
        enable_compile_cache()
        tags = load_tags()
        for label, fn in (("b", phase_app),
                          ("c", lambda: phase_correctness(tags)),
                          ("d", lambda: phase_step_time(tags))):
            t0 = time.perf_counter()
            fn()
            print(f"[{label}] passed in {time.perf_counter() - t0:.3f} s",
                  flush=True)
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
