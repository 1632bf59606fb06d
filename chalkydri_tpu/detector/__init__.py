"""Batched AprilTag detector (layer 3 of the build plan, SURVEY.md 7.1).

Replaces the reference's use of the umich C libapriltag (via apriltag-sys,
``/root/reference/crates/apriltags/``) and subsumes the custom from-scratch
detector (``crates/chalkydri-apriltags/``) with fixed-shape JAX stages:

  threshold  -> adaptive tile threshold      (threshold.py)
  segment    -> label-propagation CCL        (segment.py)
  cluster    -> gradient clustering          (cluster.py)
  quad       -> iterative 4-line quad fit    (quad.py)
  refine     -> sub-pixel edge refinement    (refine.py)
  decode     -> homography + codebook match  (homography.py, decode.py)
  pipeline   -> fused batched detect()       (pipeline.py)
"""

from chalkydri_tpu.detector.families import (  # noqa: F401
    DEFAULT_BITS_CORRECTED,
    DEFAULT_FAMILY,
    TagFamily,
    load_family,
    render_tag,
)
from chalkydri_tpu.detector.pipeline import (  # noqa: F401
    MAX_DETECTIONS,
    Detections,
    make_detector,
)
from chalkydri_tpu.detector.threshold import adaptive_threshold  # noqa: F401
from chalkydri_tpu.detector.segment import label_components  # noqa: F401
from chalkydri_tpu.detector.cluster import gradient_clusters  # noqa: F401
from chalkydri_tpu.detector.quad import fit_quads  # noqa: F401
from chalkydri_tpu.detector.refine import refine_quads  # noqa: F401
