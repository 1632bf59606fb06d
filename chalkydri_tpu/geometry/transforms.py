"""Batched rigid-body transforms (SE3) and rotation utilities.

Replaces the reference's use of ``nalgebra`` isometries/quaternions
(``/root/reference/crates/chalkydri_sqpnp/src/lib.rs:8-26``,
``crates/apriltags/src/field_layout.rs:33-40``) with batched JAX arrays.

Conventions
-----------
- Rotations are 3x3 matrices with arbitrary leading batch dims.
- ``SE3`` is a (rotation, translation) pair registered as a pytree, so it can
  flow through jit/vmap/shard_map.
- Quaternions are (w, x, y, z) scalar-first, matching the WPILib field-layout
  JSON schema (``crates/apriltags/src/field_layout.rs:76-87``).
- Euler angles are intrinsic roll/pitch/yaw (X-Y-Z), matching
  ``nalgebra::UnitQuaternion::from_euler_angles`` used by the reference at
  ``crates/chalkydri_sqpnp/src/lib.rs:440-444``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from chalkydri_tpu.utils.precision import highest_precision


class SE3(NamedTuple):
    """A rigid transform ``x -> R @ x + t`` with leading batch dims.

    Mirrors ``nalgebra::Isometry3`` (``Iso3``) from the reference.
    """

    rotation: jax.Array  # [..., 3, 3]
    translation: jax.Array  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "SE3":
        rot = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
        t = jnp.zeros((*batch_shape, 3), dtype=dtype)
        return SE3(rot, t)

    @highest_precision
    def apply(self, points: jax.Array) -> jax.Array:
        """Transform points of shape [..., 3]."""
        return (
            jnp.einsum("...ij,...j->...i", self.rotation, points) + self.translation
        )

    @highest_precision
    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: first apply ``other``, then ``self``."""
        rot = jnp.einsum("...ij,...jk->...ik", self.rotation, other.rotation)
        t = (
            jnp.einsum("...ij,...j->...i", self.rotation, other.translation)
            + self.translation
        )
        return SE3(rot, t)

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    @highest_precision
    def inverse(self) -> "SE3":
        rot_t = jnp.swapaxes(self.rotation, -1, -2)
        t = -jnp.einsum("...ij,...j->...i", rot_t, self.translation)
        return SE3(rot_t, t)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """(w, x, y, z) quaternion [..., 4] -> rotation matrix [..., 3, 3].

    Normalizes first (the reference goes through
    ``UnitQuaternion::from_quaternion``, which also normalizes:
    ``crates/apriltags/src/field_layout.rs:36-37``).
    """
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(rot: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> (w, x, y, z) quaternion [..., 4].

    Branch-free Shepperd's method (selects the numerically best of the four
    candidate formulations with ``where``; jit/vmap-safe).
    """
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    # Four candidate quaternions (unnormalized), one per dominant component.
    qw = jnp.stack(
        [1 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1
    )
    qx = jnp.stack(
        [m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1
    )
    qy = jnp.stack(
        [m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], axis=-1
    )
    qz = jnp.stack(
        [m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], axis=-1
    )
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4(case), 4(wxyz)]
    diag = jnp.stack([tr, m00, m11, m22], axis=-1)
    case = jnp.argmax(diag, axis=-1)
    q = jnp.take_along_axis(
        cands, case[..., None, None].repeat(4, axis=-1), axis=-2
    )[..., 0, :]
    q = q / safe_sqrt(jnp.sum(q * q, axis=-1, keepdims=True))
    # Canonical sign: w >= 0
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q


def euler_to_matrix(roll: jax.Array, pitch: jax.Array, yaw: jax.Array) -> jax.Array:
    """Roll/pitch/yaw -> rotation matrix, R = Rz(yaw) @ Ry(pitch) @ Rx(roll).

    Matches ``nalgebra::UnitQuaternion::from_euler_angles`` semantics used for
    the robot->camera extrinsics (``crates/chalkydri_sqpnp/src/lib.rs:440-444``).
    """
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    r = jnp.stack(
        [
            cy * cp,
            cy * sp * sr - sy * cr,
            cy * sp * cr + sy * sr,
            sy * cp,
            sy * sp * sr + cy * cr,
            sy * sp * cr - cy * sr,
            -sp,
            cp * sr,
            cp * cr,
        ],
        axis=-1,
    )
    return r.reshape(*jnp.shape(cy), 3, 3)


def matrix_to_yaw(rot: jax.Array) -> jax.Array:
    """Extract the Z (yaw) Euler angle; matches ``euler_angles().2`` in the
    reference's pose publish path (``crates/apriltags/src/lib.rs:343``)."""
    return jnp.arctan2(rot[..., 1, 0], rot[..., 0, 0])


def wrap_angle(theta: jax.Array) -> jax.Array:
    """Wrap to (-pi, pi], as ``(delta + PI).rem_euclid(2 PI) - PI``
    (``crates/chalkydri_sqpnp/src/lib.rs:351``)."""
    pi = jnp.pi
    return jnp.mod(theta + pi, 2 * pi) - pi


def smoothstep(x: jax.Array) -> jax.Array:
    """Hermite smoothstep on clamped x: x^2 (3 - 2x)
    (``crates/chalkydri_sqpnp/src/lib.rs:355-356``)."""
    x = jnp.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


# NWU robot frame <-> CV camera frame.
#
# The reference builds the robot->camera extrinsic from NWU (x fwd, y left,
# z up) offsets and converts into the OpenCV camera frame (x right, y down,
# z fwd) via a fixed change of basis
# (``crates/chalkydri_sqpnp/src/lib.rs:448-460``).
# Host constant (np, not jnp): a module-level device array would commit a
# JAX backend at import time, before the application can choose one.
# Converted at the use site.
_NWU_TO_CV = np.array(
    [
        [0.0, 0.0, 1.0],
        [-1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
    ]
)


def robot_to_cam_from_offsets(
    fwd_m, left_m, up_m, roll_deg, pitch_deg, yaw_deg, dtype=jnp.float64
) -> SE3:
    """Build the robot->camera(CV) isometry from NWU mounting offsets.

    Port of ``SqPnP::create_solver_camera_transform``
    (``crates/chalkydri_sqpnp/src/lib.rs:430-461``): the NWU camera pose on the
    robot composed with the NWU->CV basis change, inverted.

    Note the reference passes translation (x, y, z) as (fwd, left, up)
    (``crates/apriltags/src/lib.rs:247-254``).
    """
    to = jnp.asarray
    nwu_rot = euler_to_matrix(
        to(jnp.deg2rad(to(roll_deg, dtype=dtype))),
        to(jnp.deg2rad(to(pitch_deg, dtype=dtype))),
        to(jnp.deg2rad(to(yaw_deg, dtype=dtype))),
    )
    nwu_t = jnp.stack(
        [to(fwd_m, dtype=dtype), to(left_m, dtype=dtype), to(up_m, dtype=dtype)],
        axis=-1,
    )
    robot_pose_of_cam_nwu = SE3(nwu_rot, nwu_t)
    nwu_to_cv = SE3(jnp.asarray(_NWU_TO_CV, dtype=dtype), jnp.zeros(3, dtype=dtype))
    return robot_pose_of_cam_nwu.compose(nwu_to_cv).inverse()
