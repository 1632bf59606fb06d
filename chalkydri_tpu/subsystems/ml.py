"""MlSubsys: the ML inference hook.

The reference reserved a Coral Edge TPU + TFLite slot (``MlSubsys {}`` config,
``chalkydri_core/src/config.rs:101-102``; build infra
``build/build-ml.sh:12-160``; the TFLedge subsystem itself was removed,
``book/src/maintenance/subprojects.md:12-14``). Here the slot
becomes a jitted JAX model hook (SURVEY.md section 2.3): any callable
``params, frame -> outputs`` or a flax module apply can be attached and runs
batched next to the vision pipeline.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from chalkydri_tpu.runtime.clock import RobotClock, Stamped
from chalkydri_tpu.runtime.tasks import SinkTask, register_task


@register_task("MlSubsys")
class MlSubsys(SinkTask):
    """config: {model: import path "pkg.mod:fn" or None}. The resolved
    callable is jitted once and applied per frame batch."""

    def __init__(self, config=None, resources=None):
        super().__init__(config, resources)
        self._fn = None
        self.last_output = None
        spec = self.config.get("model")
        if spec:
            self._fn = self._resolve(spec)

    @staticmethod
    def _resolve(spec: str) -> Callable:
        import importlib

        import jax

        mod_name, _, fn_name = spec.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name or "model")
        return jax.jit(fn)

    def attach(self, fn: Callable) -> None:
        import jax

        self._fn = jax.jit(fn)

    def process(self, clock: RobotClock, msg: Stamped) -> None:
        if msg.payload is None or self._fn is None:
            return
        import jax.numpy as jnp

        frame = jnp.asarray(np.asarray(msg.payload))
        self.last_output = self._fn(frame)
