"""The fused multi-camera vision pipeline: frames -> robot poses.

This is the device program at the heart of the framework — the batched
accelerator re-architecture of the reference's per-camera chain
CamPipeline -> GstToCuImage -> AprilTags(detect -> unproject -> SQPnP ->
publish) (``/root/reference/chalkydri.ron:113-150``,
``crates/apriltags/src/lib.rs:293-379``): the per-camera chains collapse into
one leading batch axis and ONE jitted launch per iteration does

    grayscale frames [B, H, W]
      -> AprilTag detect (threshold/CCL/cluster/quad/refine/decode)
      -> field-layout pose gather per detected id
      -> lens unprojection of corners (per-camera intrinsics batch)
      -> batched SQPnP + gyro fusion
      -> poses, std-devs, validity, per-frame detections

Host code around it only moves bytes (capture in, UDP packets out).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from chalkydri_tpu.detector.families import DEFAULT_BITS_CORRECTED, DEFAULT_FAMILY
from chalkydri_tpu.detector.pipeline import Detections, make_detector
from chalkydri_tpu.geometry.camera import OpenCVModel5
from chalkydri_tpu.geometry.field_layout import FieldLayout
from chalkydri_tpu.geometry.tags import TAG_SIZE
from chalkydri_tpu.geometry.transforms import SE3, matrix_to_yaw
from chalkydri_tpu.solver.robot_pose import SIGN_FLIP_CONST, solve_robot_pose
from chalkydri_tpu.utils.precision import highest_precision


class VisionOutput(NamedTuple):
    """Everything the host needs to build wire packets
    (``VisionMeasurement`` fields, crates/whacknet/src/lib.rs:41-66)."""

    pose_x: jax.Array  # [B]
    pose_y: jax.Array  # [B]
    pose_yaw: jax.Array  # [B]
    std_devs: jax.Array  # [B, 3]
    pose_valid: jax.Array  # [B] bool
    tag_count: jax.Array  # [B] int32
    detections: Detections  # per-frame detections (ids/corners/margins)


def make_frame_solver(
    layout: FieldLayout,
    tag_size: float = TAG_SIZE,
    sign_flip: float = SIGN_FLIP_CONST,
    decision_margin_min: float = 0.0,
    dtype=None,
):
    """Build the per-frame ``solve_frame(dets, cam_params_row, rc_rot,
    rc_t, gyro) -> (RobotPoseResult, n_tags)`` closure over a field layout.
    Shared by the single-chip fused step (``make_vision_pipeline``) and the
    spatially-sharded multi-chip step (parallel/pipeline.py)."""
    dtype = dtype or jnp.float32
    tag_rot_table = layout.rotations.astype(dtype)
    tag_t_table = layout.translations.astype(dtype)
    tag_present = layout.present

    n_slots = tag_present.shape[0]
    rot_flat = tag_rot_table.reshape(n_slots, 9)

    @highest_precision
    def solve_frame(dets: Detections, cam_params_row, rc_rot, rc_t, gyro):
        """Per-frame: gather tag poses, unproject corners, solve."""
        ids = dets.ids  # [D]
        # Tiny-table lookups as one-hot contractions, not index gathers:
        # they fuse with the solve instead of issuing three tiny gathers.
        # A [D, T] one-hot matmul at HIGHEST precision is exact — each row
        # has exactly one unit weight, so the sum reproduces the table row
        # bitwise.
        idx = jnp.clip(ids, 0, n_slots - 1)
        onehot = idx[:, None] == jnp.arange(n_slots, dtype=ids.dtype)[None, :]
        known = jnp.any(onehot & tag_present[None, :], axis=1)
        known = known & (ids >= 0) & dets.valid
        if decision_margin_min > 0:
            known = known & (dets.decision_margins > decision_margin_min)

        hp = jax.lax.Precision.HIGHEST
        oh = onehot.astype(rot_flat.dtype)
        t_rot = jnp.matmul(oh, rot_flat, precision=hp).reshape(-1, 3, 3)
        t_t = jnp.matmul(oh, tag_t_table, precision=hp)  # [D, 3]

        model = OpenCVModel5(cam_params_row)
        rays, conv = model.unproject(dets.corners)  # [D, 4, 3], [D, 4]
        tag_ok = known & jnp.all(conv, axis=-1)  # drop tags with bad corners
        #                       (crates/apriltags/src/lib.rs:323-328)

        res = solve_robot_pose(
            t_rot, t_t, tag_ok, rays, SE3(rc_rot, rc_t), gyro,
            sign_change_error=sign_flip, tag_size=tag_size,
        )
        return res, jnp.sum(tag_ok).astype(jnp.int32)

    return solve_frame


def make_vision_pipeline(
    layout: FieldLayout,
    camera_params: jax.Array,  # [B, 9] per-camera OpenCVModel5 params
    robot_to_cam: SE3,  # batched [B, 3, 3] / [B, 3]
    family: str = DEFAULT_FAMILY,
    bits_corrected: int = DEFAULT_BITS_CORRECTED,
    tag_size: float = TAG_SIZE,
    sign_flip: float = SIGN_FLIP_CONST,
    decision_margin_min: float = 0.0,
    refine: bool = True,
    detector_kwargs: dict | None = None,
    input_format: str = "GREY",
):
    """Build the jitted fused step for a fixed camera rig.

    Static per-rig data (field layout, intrinsics, extrinsics) are closed
    over as device constants; per-iteration inputs are frames + gyro.
    """
    dk = dict(detector_kwargs or {})
    # capacity_fallback must not reach the jitted detector build: it is a
    # HOST-side two-program behavior (make_detector's wrapper calls
    # device_get, which cannot run inside this fused jit program; the App
    # implements the equivalent redispatch — runtime/app.py).
    if dk.pop("capacity_fallback", False):
        import logging

        logging.getLogger(__name__).warning(
            "capacity_fallback is not applicable inside the fused "
            "pipeline; use App(detector_kwargs={'capacity_fallback': "
            "True}) for the host-side redispatch"
        )
    detect = make_detector(
        family=family, bits_corrected=bits_corrected, refine=refine, **dk,
    )
    dtype = jnp.float32
    cam_models = OpenCVModel5(camera_params.astype(dtype))
    rc = SE3(robot_to_cam.rotation.astype(dtype), robot_to_cam.translation.astype(dtype))
    solve_frame = make_frame_solver(
        layout, tag_size=tag_size, sign_flip=sign_flip,
        decision_margin_min=decision_margin_min, dtype=dtype,
    )

    @jax.jit
    def step(frames: jax.Array, gyro: jax.Array) -> VisionOutput:
        """frames: [B, H, W] uint8 grayscale (or raw color per
        ``input_format`` — converted on device, BASELINE config #2);
        gyro: [B] (radians)."""
        if input_format.upper() not in ("GREY", "GRAY", "GRAY8", "Y800"):
            from chalkydri_tpu.detector.grayscale import to_gray_device

            frames = to_gray_device(frames, fourcc=input_format)
        dets = detect(frames)
        res, n_tags = jax.vmap(solve_frame)(
            dets, cam_models.params, rc.rotation, rc.translation, gyro
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

    return step


def build_rig_from_config(cameras, layout: FieldLayout):
    """Assemble per-camera parameter batches from config Camera entries.

    Accepts the reference's config surface: per-camera ``calib`` JSON
    (``chalkydri.ron:29``) and ``robot_to_cam`` offsets JSON or cam_offsets
    (``crates/apriltags/src/lib.rs:184-195``).
    """
    import json

    from chalkydri_tpu.geometry.transforms import robot_to_cam_from_offsets

    params = []
    rc_rots = []
    rc_ts = []
    for cam in cameras:
        calib = cam.get("calib") if isinstance(cam, dict) else cam.calib
        if calib:
            model = OpenCVModel5.from_json(calib, dtype=jnp.float32)
        else:
            model = OpenCVModel5.zeros(dtype=jnp.float32)
        params.append(model.params)

        if isinstance(cam, dict):
            rtc = cam.get("robot_to_cam")
        else:
            # TOML Camera dataclass: mount offsets live in cam_offsets
            # (translation meters, rotation degrees —
            # chalkydri_core/src/config.rs:79-87).
            offs = cam.cam_offsets
            rtc = {
                "x": offs.translation.x, "y": offs.translation.y,
                "z": offs.translation.z,
                "roll": offs.rotation.x, "pitch": offs.rotation.y,
                "yaw": offs.rotation.z,
            }
        if isinstance(rtc, str):
            rtc = json.loads(rtc)
        rtc = rtc or {}
        iso = robot_to_cam_from_offsets(
            rtc.get("x", 0.0), rtc.get("y", 0.0), rtc.get("z", 0.0),
            rtc.get("roll", 0.0), rtc.get("pitch", 0.0), rtc.get("yaw", 0.0),
            dtype=jnp.float32,
        )
        rc_rots.append(iso.rotation)
        rc_ts.append(iso.translation)

    return (
        jnp.stack(params),
        SE3(jnp.stack(rc_rots), jnp.stack(rc_ts)),
    )
