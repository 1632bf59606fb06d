"""Multi-device parallelism: mesh construction and spatially-sharded stages
(SURVEY.md sections 2.4, 5.7, 5.8 device mappings)."""

from chalkydri_tpu.parallel.mesh import (  # noqa: F401
    batch_sharding,
    frame_sharding,
    make_mesh,
    replicated,
)
from chalkydri_tpu.parallel.pipeline import make_sharded_vision_pipeline  # noqa: F401
from chalkydri_tpu.parallel.sharded_stages import sharded_adaptive_threshold  # noqa: F401
