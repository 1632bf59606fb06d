"""Small-matrix linear algebra shaped for batched latency.

``jnp.linalg.solve``'s partial-pivoted LU runs a serial pivot search per
column, which dominates the small batched systems this framework solves
(15x15, 8x8). SPD systems don't need pivoting, so an unrolled no-pivot
elimination is pure elementwise work that XLA fuses; non-SPD least-squares
problems become SPD via their (conditioned) normal equations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def spd_solve(a: jax.Array, b: jax.Array) -> jax.Array:
    """No-pivot Gaussian elimination for small SPD systems.

    a: [..., n, n], b: [..., n]; n small and static. SPD (or any strongly
    diagonally-dominant) matrices are stable without pivoting.
    """
    n = a.shape[-1]
    m = jnp.concatenate([a, b[..., None]], axis=-1)  # [..., n, n+1]
    row_is_k = [
        jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0) == k for k in range(n)
    ]
    for k in range(n):
        piv = m[..., k, k:k + 1]
        piv = jnp.where(jnp.abs(piv) < 1e-30, 1e-30, piv)
        row = (m[..., k, :] / piv)[..., None, :]
        col = m[..., :, k:k + 1]
        # One select per step: row k becomes the normalized pivot row,
        # every other row eliminates against it. (An .at[k].set lowers to
        # dynamic-update-slice, which breaks XLA's fusion of the unrolled
        # pivot chain.)
        m = jnp.where(row_is_k[k], row, m - col * row)
    return m[..., :, -1]


def spd_solve_many(a: jax.Array, b: jax.Array) -> jax.Array:
    """No-pivot elimination with a MATRIX right-hand side.

    a: [..., n, n], b: [..., n, k]. One augmented elimination solves all k
    systems — vmapping ``spd_solve`` over columns re-eliminates the same
    matrix k times (measured on the SQPnP omega inverse: 9x the work).
    """
    n = a.shape[-1]
    m = jnp.concatenate([a, b], axis=-1)  # [..., n, n+k]
    for kk in range(n):
        piv = m[..., kk, kk:kk + 1]
        piv = jnp.where(jnp.abs(piv) < 1e-30, 1e-30, piv)
        row = (m[..., kk, :] / piv)[..., None, :]
        col = m[..., :, kk:kk + 1]
        row_is_kk = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0) == kk
        # Single fused select per pivot step; see spd_solve.
        m = jnp.where(row_is_kk, row, m - col * row)
    return m[..., :, n:]


# NOTE: a 3x3-block Schur inverse (closed-form adjugate inv3 composed
# through recursive Schur complements) was prototyped here for its ~3x
# shorter sequential chain than the n-step elimination. On REAL SQPnP tag
# omegas (kappa ~ 3e4, 4-dim near-null cluster + trace-relative shift) it
# was numerically unusable in f32: max rel error 0.91 vs the elimination's
# 1.7e-4 on the same matrix — composing explicit block inverses multiplies
# their errors where elimination accumulates them additively. Keep solves
# in elimination form; don't resurrect the blocked inverse for
# ill-conditioned SPD inputs.


def lstsq_spd(a: jax.Array, b: jax.Array) -> jax.Array:
    """Least-squares via SPD normal equations: solve (a^T a) x = a^T b.

    Only for well-conditioned a (normalize your problem first — the normal
    equations square the condition number). The products force HIGHEST
    precision: a default-precision matmul may run in TF32 or bf16
    (utils/precision.py), which would void the f32 conditioning argument (cost is negligible at these sizes).
    """
    hp = jax.lax.Precision.HIGHEST
    ata = jnp.einsum("...ij,...ik->...jk", a, a, precision=hp)
    atb = jnp.einsum("...ij,...i->...j", a, b, precision=hp)
    return spd_solve(ata, atb)
