"""WPILib AprilTag field-layout loader.

Replaces the reference's ``field_layout.rs``
(``/root/reference/crates/apriltags/src/field_layout.rs:16-94``): parses the
WPILib-format ``field.json`` (camelCase keys, ``ID``, scalar-first ``W/X/Y/Z``
quaternion) into tag->field isometries.

Device-first difference: instead of a ``HashMap<usize, Iso3>``, the layout is a
dense, fixed-capacity array table indexed by tag id, so the fused pipeline can
gather tag poses for detected ids with a single device gather (no host trip).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from chalkydri_tpu.geometry.transforms import SE3, quat_to_matrix

# Dense table capacity: ids 0..MAX_TAG_ID inclusive. The 2026 field uses ids
# 1..32 (``/root/reference/field.json``); 64 leaves headroom for any family.
MAX_TAG_ID = 63


class FieldLayout(NamedTuple):
    """Dense tag-pose table.

    ``present[id]`` is True for ids in the layout; rows for absent ids are
    identity poses. ``field_size`` is (length, width) in meters.
    """

    rotations: jax.Array  # [MAX_TAG_ID + 1, 3, 3]
    translations: jax.Array  # [MAX_TAG_ID + 1, 3]
    present: jax.Array  # [MAX_TAG_ID + 1] bool
    field_size: tuple[float, float]

    def tag_pose(self, tag_id) -> SE3:
        """Gather tag pose(s) by (possibly batched, possibly invalid) id."""
        idx = jnp.clip(tag_id, 0, MAX_TAG_ID)
        return SE3(self.rotations[idx], self.translations[idx])

    def has_tag(self, tag_id) -> jax.Array:
        idx = jnp.clip(tag_id, 0, MAX_TAG_ID)
        in_range = (tag_id >= 0) & (tag_id <= MAX_TAG_ID)
        return self.present[idx] & in_range


def parse_field_layout(data: dict, dtype=jnp.float64) -> FieldLayout:
    """Parse an already-decoded WPILib layout dict.

    Schema parity with ``crates/apriltags/src/field_layout.rs:47-94``:
    ``{"tags": [{"ID": n, "pose": {"translation": {x,y,z},
    "rotation": {"quaternion": {W,X,Y,Z}}}}], "field": {"length", "width"}}``.
    """
    n = MAX_TAG_ID + 1
    rotations = [jnp.eye(3, dtype=dtype)] * n
    translations = [jnp.zeros(3, dtype=dtype)] * n
    present = [False] * n
    for tag in data["tags"]:
        tid = int(tag["ID"])
        if not (0 <= tid <= MAX_TAG_ID):
            continue
        pose = tag["pose"]
        t = pose["translation"]
        q = pose["rotation"]["quaternion"]
        quat = jnp.array(
            [float(q["W"]), float(q["X"]), float(q["Y"]), float(q["Z"])], dtype=dtype
        )
        rotations[tid] = quat_to_matrix(quat)
        translations[tid] = jnp.array(
            [float(t["x"]), float(t["y"]), float(t["z"])], dtype=dtype
        )
        present[tid] = True
    field = data.get("field", {})
    return FieldLayout(
        rotations=jnp.stack(rotations),
        translations=jnp.stack(translations),
        present=jnp.array(present),
        field_size=(float(field.get("length", 0.0)), float(field.get("width", 0.0))),
    )


def load_field_layout(path: str | None = None, dtype=jnp.float64) -> FieldLayout:
    """Load ``field.json``.

    The reference hardcodes the filename and loads from the working directory
    (``crates/apriltags/src/field_layout.rs:19``); we accept a path but default
    to the same convention.
    """
    if path is None:
        path = "field.json"
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"field layout {path!r} not found — drop the season's WPILib "
            "field.json in the working directory (the reference's "
            "convention) or pass --field/path explicitly"
        )
    with open(path) as f:
        return parse_field_layout(json.load(f), dtype=dtype)
