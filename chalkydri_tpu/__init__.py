"""chalkydri-tpu: a batched JAX/XLA rebuild of the Chalkydri FRC vision stack.

Chalkydri (the reference, /root/reference) is a Rust multi-camera AprilTag vision
coprocessor: it captures video, detects AprilTag fiducials, solves the robot's
field-relative pose with an SQPnP solver fused with gyro data, and streams
64-byte pose packets to the robot controller over UDP.

This package re-architects that stack for one accelerator program:

- every camera's frame becomes one element of a leading batch axis; the whole
  detect -> pose pipeline is one fused, jitted device program
  (``chalkydri_tpu.pipeline``),
- the AprilTag detector's stages (adaptive threshold, connected components,
  gradient clustering, quad fit, decode, edge refinement) are implemented as
  static-shape JAX stages (``chalkydri_tpu.detector``),
- the SQPnP solver is a batched, vmapped JAX program (``chalkydri_tpu.solver``),
- host-side runtime concerns (capture, UDP comm, dataflow graph, config) mirror
  the reference's Copper runtime surface (``chalkydri_tpu.runtime``,
  ``chalkydri_tpu.io``), with native C++ fast paths in
  ``chalkydri_tpu/native``.

Reference layer map: see SURVEY.md section 1.
"""

__version__ = "0.1.0"

from chalkydri_tpu.geometry import (  # noqa: F401
    SE3,
    OpenCVModel5,
    load_field_layout,
)
from chalkydri_tpu.solver import SqPnP, solve_robot_pose  # noqa: F401

__all__ = [
    "SE3",
    "OpenCVModel5",
    "load_field_layout",
    "SqPnP",
    "solve_robot_pose",
]
