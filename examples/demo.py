"""Runnable demo: synthetic field view -> fused detect+pose -> printed poses.

No hardware needed (runs on the CPU or a GPU; ``JAX_PLATFORMS=cpu`` forces
the CPU):

    python examples/demo.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from chalkydri_tpu.detector import load_family
from chalkydri_tpu.detector.families import render_tag
from chalkydri_tpu.geometry import (
    SE3,
    corners_world,
    parse_field_layout,
    robot_to_cam_from_offsets,
)
from chalkydri_tpu.geometry.camera import OpenCVModel5
from chalkydri_tpu.pipeline import build_rig_from_config, make_vision_pipeline

CALIB = {
    "fx": 900.0, "fy": 900.0, "cx": 320.0, "cy": 240.0,
    "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
    "width": 640, "height": 480,
}


def place_tag(canvas, family, tag_id, corners):
    """Warp a rendered tag onto the canvas at the given BL,BR,TR,TL corners."""
    import cv2

    img = render_tag(family, tag_id, cell_px=16)
    side = img.shape[0]
    b = 16
    src = np.array(
        [[b, side - b], [side - b, side - b], [side - b, b], [b, b]], np.float32
    ) - 0.5
    h, _ = cv2.findHomography(src, np.asarray(corners, np.float32))
    cv2.warpPerspective(img, h, (canvas.shape[1], canvas.shape[0]), dst=canvas,
                        flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_TRANSPARENT)


def main():
    fam = load_family("tag36h11")

    # A tiny field: tags 3 and 4 on a wall at x ~ 11.3 m, facing -x.
    tags = [
        {"ID": t, "pose": {"translation": {"x": 11.3, "y": y, "z": 1.0},
                           "rotation": {"quaternion": {"W": 0, "X": 0, "Y": 0, "Z": 1}}}}
        for t, y in ((3, 4.38), (4, 4.02))
    ]
    layout = parse_field_layout(
        {"tags": tags, "field": {"length": 16.5, "width": 8.0}}, dtype=jnp.float32
    )

    # Ground truth: robot at (9.6, 4.2) facing +x, camera 1 m up.
    robot_pos = np.array([9.6, 4.2, 0.0])
    r2c = robot_to_cam_from_offsets(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
    w2c = r2c.compose(SE3(jnp.eye(3, dtype=jnp.float32),
                          jnp.asarray(-robot_pos, jnp.float32)))

    model = OpenCVModel5.from_dict(CALIB, dtype=jnp.float32)
    canvas = np.full((480, 640), 150, np.uint8)
    for t in (3, 4):
        pix, _ = model.project(w2c.apply(corners_world(layout.tag_pose(jnp.asarray(t)))))
        place_tag(canvas, fam, t, np.asarray(pix))

    cams = [{"calib": json.dumps({"OpenCVModel5": CALIB}),
             "robot_to_cam": json.dumps({"roll": 0, "pitch": 0, "yaw": 0,
                                         "x": 0, "y": 0, "z": 1.0})}]
    params, rc = build_rig_from_config(cams, layout)
    step = make_vision_pipeline(layout, params, rc)

    out = step(jnp.asarray(canvas)[None], jnp.zeros(1, jnp.float32))

    print(f"true robot pose:    x={robot_pos[0]:.3f} y={robot_pos[1]:.3f} yaw=0.000")
    print(f"solved robot pose:  x={float(out.pose_x[0]):.3f} "
          f"y={float(out.pose_y[0]):.3f} yaw={float(out.pose_yaw[0]):.3f} "
          f"(valid={bool(out.pose_valid[0])}, tags={int(out.tag_count[0])})")
    print("detections:")
    for b, tid, corners, margin in out.detections.filtered_by_decision_margin(10.0):
        print(f"  tag {tid}: margin {margin:.1f}, corners {corners.round(2).tolist()}")


if __name__ == "__main__":
    main()
