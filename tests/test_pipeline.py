"""End-to-end fused pipeline tests: rendered field scenes -> robot pose.

Covers BASELINE configs #3 (detect + SQPnP pose with intrinsics) and #4
(multi-tag field-relative fusion against field.json) on synthetic imagery
with exact ground truth.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chalkydri_tpu.geometry import SE3, parse_field_layout, robot_to_cam_from_offsets
from chalkydri_tpu.geometry.camera import OpenCVModel5
from chalkydri_tpu.geometry.tags import corners_world
from chalkydri_tpu.pipeline import build_rig_from_config, make_vision_pipeline
from chalkydri_tpu.detector import load_family
from tests.reference_impl.render import place_tag

FAM = load_family("tag36h11")

# Pinhole (zero distortion) so the homography warp renders the exact lens
# image of planar tags.
CALIB = {
    "fx": 900.0, "fy": 900.0, "cx": 320.0, "cy": 240.0,
    "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
    "width": 640, "height": 480,
}


def world_to_cam(robot_pos, robot_yaw, r2c):
    c, s = np.cos(robot_yaw), np.sin(robot_yaw)
    w2r_rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float64)
    w2r_t = -w2r_rot @ robot_pos
    return r2c.compose(SE3(jnp.asarray(w2r_rot, jnp.float32), jnp.asarray(w2r_t, jnp.float32)))


def render_field_view(layout, tag_ids, robot_pos, robot_yaw, r2c, size=(480, 640)):
    """Render the camera's view of the given field tags; returns the frame."""
    model = OpenCVModel5.from_dict(CALIB, dtype=jnp.float32)
    w2c = world_to_cam(robot_pos, robot_yaw, r2c)
    canvas = np.full(size, 150, np.uint8)
    for tid in tag_ids:
        pose = layout.tag_pose(jnp.asarray(tid))
        corners_w = corners_world(pose)  # [4, 3] canonical order
        pc = w2c.apply(corners_w)
        pix, vis = model.project(pc)
        assert bool(jnp.all(vis)), f"tag {tid} behind camera"
        place_tag(canvas, FAM, tid, np.asarray(pix, np.float32))
    return canvas


def wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def tag_pair(layout):
    """The two layout tags that face the same way with the smallest
    separation (lowest ids on ties): a tag wall the camera can frame."""
    present = np.where(np.asarray(layout.present))[0]
    rots = np.asarray(layout.rotations, np.float64)
    ts = np.asarray(layout.translations, np.float64)
    best = None
    for k, i in enumerate(present):
        for j in present[k + 1:]:
            if not np.allclose(rots[i], rots[j], atol=1e-6):
                continue
            d = float(np.linalg.norm(ts[i] - ts[j]))
            if best is None or d < best[0] - 1e-9:
                best = (d, int(i), int(j))
    assert best is not None, "layout has no two tags facing the same way"
    return [best[1], best[2]]


def view_of(layout, tag_ids, spread=0.75, lateral=0.0):
    """(robot_pos [3], robot_yaw) for a robot whose camera (1 m up, looking
    along the robot's +x) faces the tags squarely along their outward
    normal, far enough back that they span ``spread`` of the half field
    of view (at least 1.5 m), shifted ``lateral`` m sideways."""
    rots = np.asarray(layout.rotations, np.float64)[tag_ids]
    ts = np.asarray(layout.translations, np.float64)[tag_ids]
    normal = rots[0][:, 0].copy()  # tag frame +X is the outward normal
    normal[2] = 0.0
    normal /= np.linalg.norm(normal)
    mid = ts.mean(axis=0)
    half_sep = float(np.max(np.linalg.norm((ts - mid)[:, :2], axis=1)))
    tan_half = CALIB["cx"] / CALIB["fx"]
    dist = max(1.5, half_sep / (spread * tan_half))
    side = np.array([-normal[1], normal[0], 0.0])
    pos = mid + normal * dist + side * lateral
    pos[2] = 0.0
    return pos, float(np.arctan2(-normal[1], -normal[0]))


@pytest.fixture(scope="module")
def layout(reference_field_json):
    with open(reference_field_json) as f:
        return parse_field_layout(json.load(f), dtype=jnp.float32)


@pytest.fixture(scope="module")
def rig():
    cams = [{"calib": json.dumps({"OpenCVModel5": CALIB}),
             "robot_to_cam": json.dumps({"roll": 0, "pitch": 0, "yaw": 0,
                                         "x": 0, "y": 0, "z": 1.0})}] * 2
    return cams


class TestDetectorKwargsHygiene:
    """capacity_fallback belongs to the App's host-side redispatch;
    forwarded verbatim into the fused jit program it used to raise
    TracerArrayConversionError, so the fused build strips it."""

    def test_foreign_keys_are_stripped(self, layout, rig):
        from chalkydri_tpu.pipeline import (
            build_rig_from_config,
            make_vision_pipeline,
        )

        params, rc = build_rig_from_config(rig, layout)
        step = make_vision_pipeline(
            layout, params, rc,
            detector_kwargs=dict(max_edge_points=4096,
                                 capacity_fallback=True),
        )
        frames = jnp.full((2, 480, 640), 127, jnp.uint8)
        out = step(frames, jnp.zeros(2, jnp.float32))
        assert not bool(np.asarray(out.pose_valid).any())  # blank frames


class TestFusedPipeline:
    def test_multi_tag_field_pose(self, layout, rig):
        """Two cameras, each seeing a two-tag wall of the layout -> both
        recover the true robot pose from one fused launch (BASELINE
        config #4)."""
        r2c = robot_to_cam_from_offsets(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
        pair = tag_pair(layout)
        robot_pos, robot_yaw = view_of(layout, pair)
        frame = render_field_view(layout, pair, robot_pos, robot_yaw, r2c)

        params, rc = build_rig_from_config(rig, layout)
        step = make_vision_pipeline(layout, params, rc)
        frames = jnp.stack([jnp.asarray(frame)] * 2)
        out = step(frames, jnp.full(2, robot_yaw, jnp.float32))

        for b in range(2):
            assert bool(out.pose_valid[b])
            assert int(out.tag_count[b]) == 2
            assert abs(float(out.pose_x[b]) - robot_pos[0]) < 0.02
            assert abs(float(out.pose_y[b]) - robot_pos[1]) < 0.02
            assert abs(wrap(float(out.pose_yaw[b]) - robot_yaw)) < 0.01
            std = np.asarray(out.std_devs[b])
            assert std[0] <= 0.2 and std[2] <= 0.2

    def test_single_tag_pose(self, layout, rig):
        """One visible tag with a truthful gyro (BASELINE config #3)."""
        r2c = robot_to_cam_from_offsets(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
        tag = tag_pair(layout)[:1]
        robot_pos, robot_yaw = view_of(layout, tag, lateral=0.15)
        frame = render_field_view(layout, tag, robot_pos, robot_yaw, r2c)

        params, rc = build_rig_from_config(rig, layout)
        step = make_vision_pipeline(layout, params, rc)
        out = step(jnp.stack([jnp.asarray(frame)] * 2),
                   jnp.full(2, robot_yaw, jnp.float32))
        assert bool(out.pose_valid[0])
        assert int(out.tag_count[0]) == 1
        # Single-tag planar ambiguity: accept the looser envelope the
        # reference itself exhibits; heading is gyro-pivoted.
        assert abs(float(out.pose_x[0]) - robot_pos[0]) < 0.25
        assert abs(float(out.pose_y[0]) - robot_pos[1]) < 0.25

    def test_unknown_tag_ignored(self, layout, rig):
        """A detected id absent from the layout must not contribute
        (crates/apriltags/src/lib.rs:306-308: tags.get(id) else continue)."""
        r2c = robot_to_cam_from_offsets(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
        pair = tag_pair(layout)
        robot_pos, robot_yaw = view_of(layout, pair)
        frame = render_field_view(layout, pair, robot_pos, robot_yaw, r2c)
        # Paint an extra tag that is NOT in the field layout (id 50 > 32),
        # in the lower-left corner: the field tags sit above the image
        # center (they are mounted higher than the camera).
        from tests.reference_impl.render import axis_aligned_corners

        assert not bool(np.asarray(layout.present)[50:].any())
        place_tag(frame, FAM, 50, axis_aligned_corners(90, 390, 55))

        params, rc = build_rig_from_config(rig, layout)
        step = make_vision_pipeline(layout, params, rc)
        out = step(jnp.stack([jnp.asarray(frame)] * 2),
                   jnp.full(2, robot_yaw, jnp.float32))
        # id 50 is detected but not used for the solve
        ids = set(int(i) for i in np.asarray(out.detections.ids[0]) if i >= 0)
        assert 50 in ids
        assert int(out.tag_count[0]) == 2
        assert abs(float(out.pose_x[0]) - robot_pos[0]) < 0.02

    def test_planar_mirror_ambiguity_all_orderings(self, layout, rig):
        """A fronto-parallel tag WALL is the planar two-fold ambiguity's
        worst case: the mirror pose (robot ~2 m in the air behind the
        wall plane) TIES the true pose's reprojection energy at the
        corner-noise floor (measured: the mirror was 0.4% LOWER in f64).
        Round-3 regression: with 3-eigvec candidate seeding, some input
        orderings sent every Newton refinement into the mirror basin
        (f32 sum-order noise decides) and the pose flipped or went
        invalid. The 4-eigvec seed set (solve_candidates n_eigvecs=4)
        plus the ground-plane tiebreak must recover the true pose for
        EVERY detection ordering."""
        from chalkydri_tpu.geometry.tags import TAG_SIZE, corners_world
        from chalkydri_tpu.solver.robot_pose import solve_robot_pose

        r2c = robot_to_cam_from_offsets(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
        pair = tag_pair(layout)
        robot_pos, robot_yaw = view_of(layout, pair)
        frame = render_field_view(layout, pair, robot_pos, robot_yaw, r2c)
        params, rc = build_rig_from_config(rig, layout)

        from chalkydri_tpu.detector.pipeline import make_detector
        from chalkydri_tpu.geometry.camera import OpenCVModel5

        det = make_detector()
        out = det(jnp.asarray(frame)[None])
        ids = np.asarray(out.ids[0])
        present = np.asarray(layout.present)
        known = np.array(
            [0 <= i < len(present) and present[i] for i in ids]
        ) & np.asarray(out.valid[0])
        model = OpenCVModel5(params[0])
        rays, conv = model.unproject(out.corners[0])
        known &= np.asarray(jnp.all(conv, axis=-1))
        idx = np.clip(ids, 0, len(present) - 1)
        t_rot = np.asarray(layout.rotations)[idx]
        t_t = np.asarray(layout.translations)[idx]

        solve = jax.jit(solve_robot_pose)
        rng = np.random.default_rng(3)
        for trial in range(6):
            perm = rng.permutation(len(ids))
            res = solve(
                jnp.asarray(t_rot[perm], jnp.float32),
                jnp.asarray(t_t[perm], jnp.float32),
                jnp.asarray(known[perm]),
                jnp.asarray(np.asarray(rays)[perm], jnp.float32),
                SE3(rc.rotation[0], rc.translation[0]),
                jnp.float32(robot_yaw),
            )
            pos = np.asarray(res.position)
            assert bool(res.valid), trial
            assert np.abs(pos[:2] - robot_pos[:2]).max() < 0.02, (trial, pos)
            assert abs(pos[2]) < 0.05, (trial, pos)

    def test_no_tags_invalid(self, layout, rig):
        frame = np.full((480, 640), 150, np.uint8)
        params, rc = build_rig_from_config(rig, layout)
        step = make_vision_pipeline(layout, params, rc)
        out = step(jnp.stack([jnp.asarray(frame)] * 2), jnp.zeros(2, jnp.float32))
        assert not bool(out.pose_valid[0])
        assert int(out.tag_count[0]) == 0
