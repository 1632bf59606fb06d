"""Camera intrinsics calibration from AprilTag grid board detections.

Replaces the reference's external ``camera-intrinsic-calibration`` +
``aprilgrid`` crates (``/root/reference/crates/configurator/src/
calibration.rs:4-11,110-142``): frames of a 6x6 aprilgrid board are detected
with the batched detector itself, accumulated as (board 3D, image 2D)
correspondences, and solved for an OpenCVModel5:

1. Zhang's method for the closed-form init (homographies per frame -> IAC ->
   K; extrinsics from K^-1 H),
2. batched Gauss-Newton refinement of [fx, fy, cx, cy, k1, k2, p1, p2, k3]
   and all per-frame poses jointly, as a jitted fixed-iteration JAX loop —
   the reprojection model IS the production camera model
   (geometry/camera.py), so calibration and runtime cannot drift apart.

Reference knobs kept: 6x6 board, MIN_CORNERS = 24 per frame
(``configurator/src/calibration.rs:33-35,76``), up to 5 solve attempts
(``calibration.rs:110-142``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MIN_CORNERS = 24  # configurator/src/calibration.rs:76
BOARD_ROWS = 6
BOARD_COLS = 6
MAX_ATTEMPTS = 5  # calibration.rs:110-142


@dataclass
class FrameFeature:
    """One calibration frame: matched board/image corner sets."""

    points_3d: np.ndarray  # [N, 3] board-frame (z = 0 plane)
    points_2d: np.ndarray  # [N, 2] pixels


def aprilgrid_board_corners(tag_size: float = 0.022, spacing_ratio: float = 0.3):
    """Board-frame corner positions for a 6x6 aprilgrid.

    Standard aprilgrid layout (tags in a ROWSxCOLS grid, separation =
    spacing_ratio * tag_size): returns {tag_id_on_board: [4, 3] corners},
    corner order matching the detector's canonical (BL, BR, TR, TL).
    """
    pitch = tag_size * (1.0 + spacing_ratio)
    out = {}
    for r in range(BOARD_ROWS):
        for c in range(BOARD_COLS):
            tid = r * BOARD_COLS + c
            x0, y0 = c * pitch, r * pitch
            out[tid] = np.array(
                [
                    [x0, y0, 0.0],
                    [x0 + tag_size, y0, 0.0],
                    [x0 + tag_size, y0 + tag_size, 0.0],
                    [x0, y0 + tag_size, 0.0],
                ]
            )
    return out


def feature_from_detections(ids, corners, board=None) -> Optional[FrameFeature]:
    """Build a FrameFeature from detector output for one frame.

    ids: [D] (>=0 valid), corners: [D, 4, 2]. Frames with fewer than
    MIN_CORNERS matched corners are rejected (calibration.rs:76).
    """
    board = board or aprilgrid_board_corners()
    p3, p2 = [], []
    for i, tid in enumerate(np.asarray(ids)):
        tid = int(tid)
        if tid < 0 or tid not in board:
            continue
        p3.append(board[tid])
        p2.append(np.asarray(corners[i]))
    if not p3:
        return None
    p3 = np.concatenate(p3)
    p2 = np.concatenate(p2)
    if len(p3) < MIN_CORNERS:
        return None
    return FrameFeature(points_3d=p3, points_2d=p2)


# ---------------------------------------------------------------------------
# Zhang closed-form initialization
# ---------------------------------------------------------------------------


def _homography(p3, p2) -> np.ndarray:
    """DLT homography board(x,y) -> pixels, normalized."""
    n = len(p3)
    a = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = p3[i, 0], p3[i, 1]
        u, v = p2[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y, -u]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y, -v]
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    return h / h[2, 2]


def _zhang_init(features: list[FrameFeature]) -> np.ndarray:
    """Closed-form K from the image of the absolute conic."""
    hs = [_homography(f.points_3d, f.points_2d) for f in features]

    def v_ij(h, i, j):
        return np.array(
            [
                h[0, i] * h[0, j],
                h[0, i] * h[1, j] + h[1, i] * h[0, j],
                h[1, i] * h[1, j],
                h[2, i] * h[0, j] + h[0, i] * h[2, j],
                h[2, i] * h[1, j] + h[1, i] * h[2, j],
                h[2, i] * h[2, j],
            ]
        )

    rows = []
    for h in hs:
        rows.append(v_ij(h, 0, 1))
        rows.append(v_ij(h, 0, 0) - v_ij(h, 1, 1))
    v = np.stack(rows)
    _, _, vt = np.linalg.svd(v)
    b11, b12, b22, b13, b23, b33 = vt[-1]

    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0, 0.0])


def _pose_from_homography(k: np.ndarray, h: np.ndarray):
    kinv = np.linalg.inv(k)
    h1, h2, h3 = h[:, 0], h[:, 1], h[:, 2]
    lam = 1.0 / np.linalg.norm(kinv @ h1)
    r1 = lam * (kinv @ h1)
    r2 = lam * (kinv @ h2)
    r3 = np.cross(r1, r2)
    t = lam * (kinv @ h3)
    r = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(r)
    r = u @ vt
    if np.linalg.det(r) < 0:
        r = -r
    if t[2] < 0:  # board must be in front of the camera
        r[:, 0:2] *= -1
        t = -t
    return r, t


# ---------------------------------------------------------------------------
# Gauss-Newton refinement (JAX)
# ---------------------------------------------------------------------------


def _rodrigues(rvec):
    import jax.numpy as jnp

    theta = jnp.linalg.norm(rvec) + 1e-12
    k = rvec / theta
    kx = jnp.array(
        [[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]]
    )
    return (
        jnp.eye(3)
        + jnp.sin(theta) * kx
        + (1.0 - jnp.cos(theta)) * (kx @ kx)
    )


def _rvec_from_matrix(r: np.ndarray) -> np.ndarray:
    import scipy.spatial.transform as sst

    return sst.Rotation.from_matrix(r).as_rotvec()


@dataclass
class CalibrationResult:
    params: np.ndarray  # [9] OpenCVModel5 ordering
    rms_px: float
    n_frames: int

    def to_model(self, width: int = 0, height: int = 0):
        import jax.numpy as jnp

        from chalkydri_tpu.geometry.camera import OpenCVModel5

        return OpenCVModel5(jnp.asarray(self.params, jnp.float64), width, height)


def calibrate_camera(
    features: list[FrameFeature],
    iters: int = 30,
    point_cap: int = 144,
) -> CalibrationResult:
    """Full intrinsics solve from accumulated frame features."""
    import jax
    import jax.numpy as jnp

    from chalkydri_tpu.geometry.camera import OpenCVModel5

    feats = [f for f in features if len(f.points_3d) >= MIN_CORNERS]
    if len(feats) < 3:
        raise ValueError("need at least 3 usable calibration frames")

    k0 = _zhang_init(feats)
    kmat = np.array(
        [[k0[0], 0, k0[2]], [0, k0[1], k0[3]], [0, 0, 1]]
    )

    # Pad every frame to point_cap correspondences with masks.
    f = len(feats)
    p3 = np.zeros((f, point_cap, 3))
    p2 = np.zeros((f, point_cap, 2))
    msk = np.zeros((f, point_cap), bool)
    rvecs = np.zeros((f, 3))
    tvecs = np.zeros((f, 3))
    for i, feat in enumerate(feats):
        n = min(len(feat.points_3d), point_cap)
        p3[i, :n] = feat.points_3d[:n]
        p2[i, :n] = feat.points_2d[:n]
        msk[i, :n] = True
        h = _homography(feat.points_3d, feat.points_2d)
        r, t = _pose_from_homography(kmat, h)
        rvecs[i] = _rvec_from_matrix(r)
        tvecs[i] = t

    p3j = jnp.asarray(p3)
    p2j = jnp.asarray(p2)
    mj = jnp.asarray(msk)

    def residuals(theta):
        cam = theta[:9]
        rv = theta[9 : 9 + 3 * f].reshape(f, 3)
        tv = theta[9 + 3 * f :].reshape(f, 3)

        def per_frame(rvec, tvec, pts3, pts2, m):
            r = _rodrigues(rvec)
            pc = pts3 @ r.T + tvec
            model = OpenCVModel5(cam)
            pix, valid = model.project(pc)
            res = (pix - pts2) * m[:, None]
            return res

        res = jax.vmap(per_frame)(jnp.asarray(rvecs) * 0 + rv, tv, p3j, p2j, mj)
        return res.reshape(-1)

    theta0 = jnp.concatenate(
        [jnp.asarray(k0), jnp.asarray(rvecs).reshape(-1), jnp.asarray(tvecs).reshape(-1)]
    )

    @jax.jit
    def gn_step(theta, lm):
        r = residuals(theta)
        jac = jax.jacfwd(residuals)(theta)
        jtj = jac.T @ jac
        jtr = jac.T @ r
        n = jtj.shape[0]
        step = jnp.linalg.solve(jtj + lm * jnp.eye(n), jtr)
        return theta - step, r

    theta = theta0
    lm = 1e-3
    prev_cost = np.inf
    for _ in range(iters):
        new_theta, r = gn_step(theta, lm)
        cost = float(jnp.sum(r * r))
        if not np.isfinite(cost):
            lm *= 10
            continue
        if cost > prev_cost:
            lm = min(lm * 10, 1e3)
        else:
            lm = max(lm / 3, 1e-9)
            theta = new_theta
            prev_cost = cost

    r = residuals(theta)
    n_pts = float(jnp.sum(mj))
    rms = float(jnp.sqrt(jnp.sum(r * r) / jnp.maximum(n_pts, 1.0)))
    return CalibrationResult(
        params=np.asarray(theta[:9]), rms_px=rms, n_frames=f
    )


class Calibrator:
    """Stateful driver mirroring the configurator's Calibrator
    (``configurator/src/calibration.rs:30-143``): feed frames, accumulate
    features, then solve with up to MAX_ATTEMPTS."""

    def __init__(self, detector=None, board=None, monitor=None):
        self.features: list[FrameFeature] = []
        self.board = board or aprilgrid_board_corners()
        self._detector = detector
        # Optional CalibrationMonitor (subsystems/calib_viz.py): per-frame
        # corner/coverage streaming — the reference's rerun point logging
        # (configurator/src/calibration.rs:91-98).
        self.monitor = monitor

    def _detect(self, frame: np.ndarray):
        import jax.numpy as jnp

        if self._detector is None:
            from chalkydri_tpu.detector import make_detector

            self._detector = make_detector()
        out = self._detector(jnp.asarray(frame)[None])
        ids = np.asarray(out.ids[0])
        corners = np.asarray(out.corners[0])
        valid = np.asarray(out.valid[0])
        return ids[valid], corners[valid]

    def process_frame(self, frame: np.ndarray) -> bool:
        """Detect the board in a frame; returns True if it contributed."""
        ids, corners = self._detect(frame)
        feat = feature_from_detections(ids, corners, self.board)
        accepted = feat is not None
        if self.monitor is not None:
            self.monitor.on_frame(frame, ids, corners, accepted)
        if not accepted:
            return False
        self.features.append(feat)
        return True

    def calibrate(self) -> CalibrationResult:
        last_err = None
        for attempt in range(MAX_ATTEMPTS):
            try:
                result = calibrate_camera(self.features)
                if self.monitor is not None:
                    self.monitor.on_result(result.rms_px, result.n_frames)
                return result
            except (ValueError, np.linalg.LinAlgError) as e:  # noqa: PERF203
                last_err = e
        raise RuntimeError(f"calibration failed after {MAX_ATTEMPTS} attempts: {last_err}")
