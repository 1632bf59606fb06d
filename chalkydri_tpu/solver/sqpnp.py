"""Batched SQPnP (Sequential Quadratic Programming PnP) core.

Batched re-design of the reference's from-scratch solver
(``/root/reference/crates/chalkydri_sqpnp/src/lib.rs``). Semantics ported
exactly; the *shape* of the computation is redesigned for XLA:

- every stage is fixed-shape and mask-driven (padded point sets), so a batch of
  frames vmaps into one fused program;
- the 6 rotation candidates (3 smallest eigenvectors x +-1,
  ``sqpnp/src/lib.rs:396-428``) are a vmapped axis, not a loop;
- the <=15 Newton iterations on the 15x15 KKT system
  (``sqpnp/src/lib.rs:97-115,463-479``) run as a ``lax.fori_loop`` with masked
  convergence (converged candidates keep their value; identical result to the
  reference's early break because converged deltas are below tol);
- candidate selection (cheirality + min penalized energy,
  ``sqpnp/src/lib.rs:267-294``) is a masked argmin.

Key reference constants:
  max_iter=15, tol^2=1e-16       sqpnp/src/lib.rs:201-212
  6 candidates                   sqpnp/src/lib.rs:403-406
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# spd_solve lives in ops/linalg (shared with the homography/decode fits);
# re-exported here because the Schur KKT below is its original use.
from chalkydri_tpu.ops.linalg import spd_solve, spd_solve_many  # noqa: F401
from chalkydri_tpu.utils.precision import highest_precision

MAX_ITER = 15
TOL_SQ = 1e-16
NUM_CANDIDATES = 6


class SqPnPResult(NamedTuple):
    rotation: jax.Array  # [..., 3, 3] world->cam
    translation: jax.Array  # [..., 3] world->cam
    energy: jax.Array  # [...] pure geometric energy r^T omega r
    valid: jax.Array  # [...] bool: a cheirality-passing candidate existed


def build_linear_system(points_3d: jax.Array, points_2d: jax.Array, mask: jax.Array):
    """Accumulate the SQPnP least-squares system over masked points.

    Port of ``build_linear_system`` (``sqpnp/src/lib.rs:124-180``): for each
    (3D point p, image ray v) pair, with the ray projector
    P = I - v v^T / |v|^2, accumulate

        Q_tt += P
        Q_rt[3i:3i+3] += p_i * P        (i in x,y,z)
        Q_rr[3i:3i+3, 3j:3j+3] += p_i p_j P

    then omega = Q_rr - Q_rt Q_tt^{-1} Q_rt^T.

    Args:
      points_3d: [N, 3] centered world points.
      points_2d: [N, 3] camera rays (any scale; P is scale-invariant).
      mask: [N] bool; padded entries contribute zero.

    Returns:
      (omega [9,9], q_tt_inv [3,3], q_rt [9,3])
    """
    dtype = points_3d.dtype
    m = mask.astype(dtype)[:, None, None]  # [N,1,1]

    sq_norm = jnp.sum(points_2d * points_2d, axis=-1)  # [N]
    inv_norm = jnp.where(sq_norm > 0, 1.0 / jnp.maximum(sq_norm, 1e-30), 0.0)
    v_vt = points_2d[:, :, None] * points_2d[:, None, :]  # [N,3,3]
    proj = jnp.eye(3, dtype=dtype)[None] - v_vt * inv_norm[:, None, None]
    proj = proj * m  # masked projector

    q_tt = jnp.sum(proj, axis=0)  # [3,3]

    # p_outer[n, i, j] = p_i * p_j ; q_rr[3i+a, 3j+b] = sum_n p_i p_j P[a,b]
    p = points_3d  # [N,3]
    # q_rt: block rows scaled by p_i -> [3(block i), 3] stacked to [9,3]
    q_rt = jnp.einsum("ni,nab->iab", p, proj).reshape(9, 3)
    # q_rr: [i,j] block = sum_n p_i p_j P  -> [3,3,3,3] -> [9,9]
    q_rr = jnp.einsum("ni,nj,nab->iajb", p, p, proj).reshape(9, 9)

    q_tt_inv = robust_inv3(q_tt)
    omega = q_rr - q_rt @ q_tt_inv @ q_rt.T
    return omega, q_tt_inv, q_rt


def robust_inv3(m: jax.Array) -> jax.Array:
    """3x3 inverse; returns zeros when singular (the reference uses
    ``try_inverse().unwrap_or_default()``, ``sqpnp/src/lib.rs:171``)."""
    det = jnp.linalg.det(m)
    ok = jnp.abs(det) > 1e-30
    safe = jnp.where(ok, det, 1.0)
    adj = _adjugate3(m)
    inv = adj / safe
    return jnp.where(ok, inv, jnp.zeros_like(m))


def _adjugate3(m: jax.Array) -> jax.Array:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    cof = jnp.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        axis=-1,
    )
    return cof.reshape(*m.shape[:-2], 3, 3)


def _round_robin_pairs(n: int):
    """Tournament schedule: n(n-1)/2 index pairs grouped into rounds of
    DISJOINT pairs (circle method; odd n gets a bye per round)."""
    m = n + (n % 2)
    rounds = []
    circle = list(range(m - 1))
    for r in range(m - 1):
        pairs = []
        # fixed player m-1 vs circle[r]; then opposite ends of the circle
        a0 = circle[r]
        if m - 1 < n:
            pairs.append((min(a0, m - 1), max(a0, m - 1)))
        for i in range(1, m // 2):
            p = circle[(r + i) % (m - 1)]
            q = circle[(r - i) % (m - 1)]
            if p < n and q < n:
                pairs.append((min(p, q), max(p, q)))
        rounds.append(pairs)
    return rounds


def _jacobi_eigh_small(a: jax.Array, sweeps: int = 5):
    """Symmetric n x n (n small, static) eigendecomposition by PARALLEL
    cyclic Jacobi: each round applies all of a round-robin schedule's
    DISJOINT Givens rotations as one compound orthogonal G (disjoint
    planes commute exactly), so a sweep is n-ish rounds of 3 matmuls
    instead of n(n-1)/2 sequential rotations — the solve stage is a
    chain of tiny dependent ops, so its length is what costs, and this
    halves its longest remaining chain. Branch-free (atan2 handles zero
    off-diagonals); angles within a round are computed from the same
    pre-round matrix (the standard parallel-Jacobi variant, convergent
    for round-robin orderings; accuracy asserted against numpy's eigh in
    tests/test_solver.py). Sweep count: parallel ordering trades a little
    convergence per sweep for ~2x fewer rounds — measured worst f64
    eigen-residuals over 200 random 5x5 PSD draws: 4 sweeps 5e-5,
    5 sweeps 3e-8 (below f32 eps, the production dtype), 6 sweeps 2e-15;
    the default 5 keeps the chain at 25 rounds where cyclic needed 40
    rotations. Returns (eigenvalues [n] unsorted, eigenvectors as
    columns [n, n])."""
    import numpy as _np2

    n = a.shape[0]
    dtype = a.dtype
    v = jnp.eye(n, dtype=dtype)
    hp = jax.lax.Precision.HIGHEST
    schedule = _round_robin_pairs(n)
    # Host constants per round: D selects the (pp, qq) diagonal slots of
    # every pair, S the antisymmetric (qp, -pq) slots; G = I + sum_k
    # ((c_k - 1) D_k + s_k S_k) assembles all rotations in ~4 fused ops.
    consts = []
    for pairs in schedule:
        ds, ss = [], []
        for (p, q) in pairs:
            d = _np2.zeros((n, n))
            d[p, p] = d[q, q] = 1.0
            s = _np2.zeros((n, n))
            s[q, p] = 1.0
            s[p, q] = -1.0
            ds.append(d)
            ss.append(s)
        consts.append((pairs, _np2.stack(ds), _np2.stack(ss)))

    for _ in range(sweeps):
        for pairs, d_np, s_np in consts:
            app = jnp.stack([a[p, p] for p, _ in pairs])
            aqq = jnp.stack([a[q, q] for _, q in pairs])
            apq = jnp.stack([a[p, q] for p, q in pairs])
            theta = 0.5 * jnp.arctan2(2.0 * apq, app - aqq)
            c, s = jnp.cos(theta), jnp.sin(theta)
            d_c = jnp.asarray(d_np, dtype)
            s_c = jnp.asarray(s_np, dtype)
            g = (jnp.eye(n, dtype=dtype)
                 + jnp.sum((c - 1.0)[:, None, None] * d_c, axis=0)
                 + jnp.sum(s[:, None, None] * s_c, axis=0))
            a = jnp.matmul(jnp.matmul(g.T, a, precision=hp), g,
                           precision=hp)
            v = jnp.matmul(v, g, precision=hp)
    return jnp.diagonal(a), v


def _analytic_eigh3(a: jax.Array):
    """Closed-form symmetric 3x3 eigendecomposition (Smith's trigonometric
    form + cross-product eigenvectors), branch-free.

    Replaces the 4-sweep Jacobi inside ``nearest_so3``: the Jacobi's 12
    sequential rotations are ~100 dependent tiny ops (the solve stage
    is a latency-bound chain); this is ~35 ops with the same f32 accuracy on
    the stress corpus (tests/test_solver.py compares both against the f64
    SVD oracle, including the rank-1/rank-0 guesses the SQPnP candidates
    routinely produce).

    Eigenvalues: for B = (A - q I)/p with q = tr/3, p = sqrt(tr(B'^2)/6),
    the shifted matrix has det in [-2, 2] and eigenvalues
    2 cos(phi + 2k pi / 3); scalar matrices (p ~ 0) fall back to q.

    Eigenvectors: v1 (largest lambda) and v3 (smallest) are each computed
    as the largest-norm cross product of two rows of (A - lambda I) —
    exact for simple eigenvalues; v2 completes the right-handed frame.
    Near-degenerate PAIRS make one of the crosses ill-conditioned, but
    exactly then any orthonormal basis of the pair's subspace is
    near-optimal for the caller (nearest_so3's U-construction
    re-orthonormalizes and only the SUM of the tied singular directions'
    contributions matters); the norm-ranked cross selection picks the
    best-conditioned candidate, and the caller's fallbacks cover exact
    ties. Returns (eigenvalues [3] DESCENDING, eigenvectors as columns
    [3, 3], right-handed: v2 = v3 x v1).
    """
    dtype = a.dtype
    q = jnp.trace(a) / 3.0
    b = a - q * jnp.eye(3, dtype=dtype)
    p2 = jnp.sum(b * b) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 0.0))
    safe_p = jnp.maximum(p, jnp.asarray(1e-30, dtype))
    detb = jnp.linalg.det(b)
    r = jnp.clip(detb / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # cos(phi) >= cos(phi + 4pi/3) >= cos(phi + 2pi/3) for phi in [0, pi/3]
    lam1 = q + 2.0 * p * jnp.cos(phi)
    lam3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3

    def eigvec(lam):
        m = a - lam * jnp.eye(3, dtype=dtype)
        # All 3 row-pair crosses; pick the largest by norm with a one-hot
        # select (fuses with the arithmetic; no tiny dynamic gather).
        c01 = jnp.cross(m[0], m[1])
        c12 = jnp.cross(m[1], m[2])
        c20 = jnp.cross(m[2], m[0])
        cs = jnp.stack([c01, c12, c20])  # [3, 3]
        n2 = jnp.sum(cs * cs, axis=1)
        selv = (n2 == jnp.max(n2)) & (
            jnp.cumsum((n2 == jnp.max(n2)).astype(jnp.int32)) == 1
        )
        v = jnp.sum(jnp.where(selv[:, None], cs, 0.0), axis=0)
        n = jnp.linalg.norm(v)
        e1 = jnp.zeros(3, dtype).at[0].set(1.0)
        return jnp.where(n > 1e-30, v / jnp.maximum(n, 1e-30), e1), n

    v1, n1 = eigvec(lam1)
    v3raw, n3 = eigvec(lam3)
    # Orthogonalize v3 against v1 (crosses of near-degenerate pairs can
    # leak a v1 component), with an orthonormal-completion fallback when
    # the pair {lam2, lam3} is (near-)degenerate and the cross vanished.
    w3 = v3raw - jnp.dot(v1, v3raw) * v1
    nw3 = jnp.linalg.norm(w3)
    # Fallback: most-orthogonal coordinate axis completed against v1.
    k = jnp.argmin(jnp.abs(v1))
    ek = (jnp.arange(3) == k).astype(dtype)
    fb = ek - jnp.dot(v1, ek) * v1
    fb = fb / jnp.maximum(jnp.linalg.norm(fb), 1e-30)
    v3 = jnp.where(nw3 > 1e-6, w3 / jnp.maximum(nw3, 1e-30), fb)
    v2 = jnp.cross(v3, v1)
    vals = jnp.stack([lam1, lam2, lam3])
    vecs = jnp.stack([v1, v2, v3], axis=1)
    return vals, vecs


def nearest_so3(r_vec: jax.Array) -> jax.Array:
    """Project a 9-vector (column-major 3x3) onto SO(3).

    Semantics of the reference's SVD projection (``sqpnp/src/lib.rs:
    41-59``: U V^T with the last singular column negated when det < 0),
    computed WITHOUT a LAPACK-style SVD (its iterations are sequential
    scalar work): eigendecompose M^T M by fixed-
    iteration Jacobi, then rebuild the orthogonal factor from the two
    dominant singular directions with a cross-product completion (see the
    inline notes — this is also the det<0 fix, and it is exact on the
    rank-1 inputs the candidate guesses routinely are).
    """
    m = r_vec.reshape(3, 3).T  # column-major unpack
    hp = jax.lax.Precision.HIGHEST
    a = jnp.matmul(m.T, m, precision=hp)
    # Closed-form eigendecomposition, DESCENDING eigenvalues, right-handed
    # V (det +1 by construction — the role the even-permutation sort
    # played for the Jacobi variant); ~3x shorter dependency chain than
    # the 4-sweep Jacobi on this latency-bound stage.
    _, v_s = _analytic_eigh3(a)

    # U columns built from the two LARGEST singular directions,
    # orthonormalized; the third column is their cross product. This is
    # simultaneously the det<0 fix: det(U)=+1 by construction, so
    # R = U V^T is the nearest ROTATION in both sign cases (the
    # reference's flip of U's last column is exactly the cross-product
    # completion when det(M) < 0). Rank-deficient inputs are ROUTINE here
    # — the omega eigenvector guesses reshape to exactly rank-1 matrices
    # — so each column has a branch-free orthonormal FALLBACK instead of
    # a divide-by-clamped-sigma (which collapsed to zero columns on exact
    # rank deficiency): when M contributes no usable direction, take the
    # dominant column of the projector onto the remaining subspace, like
    # LAPACK's arbitrary null-space completion.
    a1 = jnp.matmul(m, v_s[:, 0], precision=hp)
    a2 = jnp.matmul(m, v_s[:, 1], precision=hp)
    n1 = jnp.linalg.norm(a1)
    scale = jnp.maximum(n1, 1e-20)
    e1 = jnp.zeros(3, m.dtype).at[0].set(1.0)
    u1 = jnp.where(n1 > 1e-12, a1 / scale, e1)

    w2 = a2 - jnp.dot(u1, a2) * u1
    n2 = jnp.linalg.norm(w2)
    proj1 = jnp.eye(3, dtype=m.dtype) - jnp.outer(u1, u1)
    cn = jnp.linalg.norm(proj1, axis=0)
    fb2 = proj1[:, jnp.argmax(cn)] / jnp.maximum(jnp.max(cn), 1e-20)
    u2 = jnp.where(n2 > 1e-5 * scale, w2 / jnp.maximum(n2, 1e-20), fb2)

    u3 = jnp.cross(u1, u2)
    u_s = jnp.stack([u1, u2, u3], axis=1)
    rot = jnp.matmul(u_s, v_s.T, precision=hp)
    return rot.T.reshape(9)  # column-major pack


# Constraint index pattern for constraints_and_jacobian: row k constrains
# columns (p_k, q_k) of R — the three unit norms then the three
# orthogonalities. Host constants; selecting rows of small matrices by
# 0/1 matmul is exact and avoids both Python-loop op chains and dynamic
# gathers.
import numpy as _np

_CJ_P = _np.eye(3, dtype=_np.float64)[[0, 1, 2, 0, 0, 1]]  # [6, 3]
_CJ_Q = _np.eye(3, dtype=_np.float64)[[0, 1, 2, 1, 2, 2]]
_CJ_DIAG = _np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])


def constraints_and_jacobian(r: jax.Array):
    """SO(3) orthonormality constraints h(r) [6] and Jacobian [6, 9].

    Port of ``constraints_and_jacobian`` (``sqpnp/src/lib.rs:61-95``); r is
    column-major (c1 = r[0:3], c2 = r[3:6], c3 = r[6:9]). Matrix form —
    h_k = c_{p_k} . c_{q_k} - [p_k == q_k], jac_k = e_{p_k} (x) c_{q_k} +
    e_{q_k} (x) c_{p_k} — so one Gram matmul + two 0/1-selection matmuls
    replace the 12-op stack/concat chain (the Newton loop is
    latency-bound; every op in its body repeats up to max_iter times).
    """
    dtype = r.dtype
    hp = jax.lax.Precision.HIGHEST
    c = r.reshape(3, 3)  # row i = column c_{i+1} of R
    e1 = jnp.asarray(_CJ_P, dtype)
    e2 = jnp.asarray(_CJ_Q, dtype)
    g = jnp.matmul(c, c.T, precision=hp)  # Gram [3, 3]
    h = jnp.sum(jnp.matmul(e1, g, precision=hp) * e2, axis=1) - jnp.asarray(
        _CJ_DIAG, dtype)
    cq = jnp.matmul(e2, c, precision=hp)  # [6, 3] = c_{q_k}
    cp = jnp.matmul(e1, c, precision=hp)  # [6, 3] = c_{p_k}
    jac = (e1[:, :, None] * cq[:, None, :]
           + e2[:, :, None] * cp[:, None, :]).reshape(6, 9)
    return h, jac




def regularized_omega_inv(omega: jax.Array, eps_rel: float = 1e-4):
    """(omega + eps I)^-1 with a trace-relative shift. omega is PSD with
    near-null directions (the rotation candidates live in them); the shift
    makes it SPD so the Schur-complement KKT step below is well-posed.
    Shared across a frame's 6 candidates and all Newton iterations."""
    dtype = omega.dtype
    eps = eps_rel * jnp.maximum(jnp.trace(omega) / 9.0, 1e-12)
    omega_eps = omega + eps * jnp.eye(9, dtype=dtype)
    # One augmented elimination for all 9 columns (spd_solve_many) —
    # vmapping spd_solve re-eliminated the same matrix 9 times. A
    # 3x3-block Schur inverse (explicit inv(A11) composed through the
    # Schur complement) was tried for its ~3x shorter dependency chain
    # and measured CATASTROPHICALLY wrong on real tag omegas in f32
    # (rel err 0.91 vs 1.7e-4 here, kappa ~ 3e4 with a 4-dim near-null
    # cluster): composing explicit block inverses multiplies their
    # errors where row elimination accumulates them additively.
    return spd_solve_many(omega_eps, jnp.eye(9, dtype=dtype))


def smallest_eigvecs(omega: jax.Array, omega_inv: jax.Array,
                     k: int = 3, apps: int = 4,
                     block: int = 5) -> jax.Array:
    """The ``k`` smallest eigenvectors of a symmetric PSD 9x9 (columns,
    ascending) by INVERSE SUBSPACE ITERATION on a 9 x ``block`` basis +
    ``block`` x ``block`` Rayleigh-Ritz.

    ``jnp.linalg.eigh`` on 9x9 batches runs a sequential, scalar-ish QR
    iteration; the rotation candidates only
    need the near-null subspace, and ``omega_inv = (omega + eps I)^-1`` is
    ALREADY computed for the Newton steps. Iterating X <- orthonormalize(
    omega_inv X) with a block WIDER than 3 makes the 3rd Ritz vector
    converge at rate ((lambda_3 + eps) / (lambda_block+1 + eps))^k rather
    than ((lambda_3 + eps) / (lambda_4 + eps))^k — real noisy tag omegas
    DO produce near-degenerate lambda_3 ~ lambda_4 pairs (a 3-column
    block stalls at ratio ~0.92 on such scenes), while lambda_6 sits a
    decade higher, so the guard columns restore fast convergence. The
    Rayleigh-Ritz (fixed-sweep Jacobi on the projected block) then
    separates the individual eigenvectors, resolving close pairs exactly
    as eigh does. Per-column norm clamps keep the zero-omega (empty tag
    mask) case finite; the result is then arbitrary orthonormal, matching
    eigh's arbitrary basis, and the solve is discarded by the mask anyway.
    """
    dtype = omega.dtype
    hp = jax.lax.Precision.HIGHEST
    x = jnp.eye(9, block, dtype=dtype)

    def orthonormalize(x):
        # Modified Gram-Schmidt, branch-free fallbacks.
        cols = []
        for j in range(block):
            c = x[:, j]
            for q in cols:
                c = c - jnp.dot(q, c) * q
            n = jnp.linalg.norm(c)
            fallback = jnp.zeros(9, dtype).at[j].set(1.0)
            cols.append(jnp.where(n > 1e-20, c / jnp.maximum(n, 1e-20),
                                  fallback))
        return jnp.stack(cols, axis=1)

    for _ in range(apps):
        # Orthonormalize after EVERY application: omega_inv's dominance
        # ratio reaches (lambda_5/eps) ~ 20-1000 on real tag omegas, so
        # stacked un-normalized applications drive the block columns
        # toward parallel and into f32's MGS cancellation floor. 4
        # applications are CONVERGED on a 240-random-scene stress (the
        # worst Rayleigh-quotient ratio is identical at 4 and 6 — the
        # residual is an f32 accuracy floor, not a convergence tail).
        x = orthonormalize(jnp.matmul(omega_inv, x, precision=hp))
    s = jnp.matmul(x.T, jnp.matmul(omega, x, precision=hp), precision=hp)
    w, u = _jacobi_eigh_small(s)
    order = jnp.argsort(w)[:k]
    return jnp.matmul(x, u[:, order], precision=hp)


def newton_refine(r0: jax.Array, omega: jax.Array, max_iter: int = MAX_ITER,
                  tol_sq: float = TOL_SQ, omega_inv: jax.Array | None = None):
    """Refine a rotation 9-vector with <= max_iter SQP Newton steps.

    Port of ``optimization`` + ``solve_newton``
    (``sqpnp/src/lib.rs:97-115,463-479``). The reference solves the 15x15
    KKT system

        [omega  J^T] [dr]   [-omega r]
        [J       0 ] [mu] = [-h      ]

    with pivoted LU; here the step uses the SCHUR COMPLEMENT of a
    trace-regularized omega_eps = omega + eps I:

        (J omega_eps^-1 J^T) mu = J omega_eps^-1 rhs1 + h
        dr = omega_eps^-1 (rhs1 - J^T mu),  rhs1 = -omega r

    Every fixed point of the reference iteration (h = 0, omega r in
    range(J^T)) is a fixed point of this one (dr = 0 there for any eps), so
    both converge to the same KKT points; the regularized step's two
    solves are SPD (spd_solve, no pivot search) instead of a pivoted
    15x15 LU. Masked convergence replaces the early break; a
    non-finite solve freezes the iterate (the reference breaks out).
    """
    if omega_inv is None:
        omega_inv = regularized_omega_inv(omega)

    def body(carry):
        r, done = carry
        h, jac = constraints_and_jacobian(r)
        rhs1 = -(omega @ r)
        b = jac @ omega_inv  # [6, 9]
        schur = b @ jac.T  # [6, 6] SPD
        mu = spd_solve(schur, b @ rhs1 + h)
        delta = omega_inv @ (rhs1 - jac.T @ mu)
        finite = jnp.all(jnp.isfinite(delta))
        step_ok = finite & ~done
        r_new = jnp.where(step_ok, r + delta, r)
        converged = jnp.dot(delta, delta) < tol_sq
        done_new = done | ~finite | (step_ok & converged)
        return r_new, done_new

    # CHUNKED UNROLL: while_loop over chunks of 3 straight-line masked
    # steps. The loop body is ~60 tiny ops and the solve stage is a
    # latency-bound chain, so unrolling lets XLA fuse across
    # iterations — but a FULL unroll always pays max_iter steps while
    # clean solves converge in ~4-6; checking the done flag every 3 steps
    # keeps the early exit at chunk granularity. Bit-identical to the
    # per-step while_loop by construction: a vmapped while_loop also runs
    # until EVERY lane converges, with exactly these masked no-op
    # updates, and extra steps after convergence are the same no-ops.
    chunk = 3
    n_chunks = (max_iter + chunk - 1) // chunk

    def chunk_body(carry):
        r, done, i = carry
        rd = (r, done)
        for _ in range(chunk):
            rd = body(rd)
        r, done = rd
        return r, done, i + 1

    r, _, _ = jax.lax.while_loop(
        lambda c: (c[2] < n_chunks) & ~c[1],
        chunk_body,
        (r0, jnp.asarray(False), jnp.int32(0)),
    )
    energy = jnp.dot(r, omega @ r)
    return r, energy


def solve_candidates(omega: jax.Array, fwd_in_cam: jax.Array, gyro_cos, gyro_sin,
                     sign_change_error, max_iter: int = MAX_ITER,
                     n_eigvecs: int = 4):
    """Generate and refine the 2*n_eigvecs rotation candidates with gyro
    penalty.

    Port of ``solve_rotation_candidates`` (``sqpnp/src/lib.rs:396-428``):
    the smallest eigenvectors of omega, x {-1, +1}, projected to SO(3),
    Newton-refined, plus the gyro heading-error energy penalty
    ``sign_change_error * max(0, 1 - cos angle(robot_fwd, gyro))``.

    The reference seeds from the 3 smallest eigenvectors; the default here
    is FOUR. A planar target (every FRC tag wall) gives omega a 4-dim
    near-null space (the planar two-fold pose ambiguity), and with only a
    3-vector slice of it the Newton refinements can ALL land in the mirror
    basin — measured on a rendered fronto-parallel two-tag wall: 3/12
    input orderings lost the true pose entirely (every cheirality-valid
    candidate gone), while the 4-eigvec seed set found it in 12/12. The
    two extra refinements ride the same vmap, adding no sequential steps.

    Returns (r_vecs [2k, 9], penalized_energy [2k], pure_energy [2k]).
    """
    omega_inv = regularized_omega_inv(omega)  # shared by all candidates
    base = smallest_eigvecs(omega, omega_inv, k=n_eigvecs).T  # [k, 9]
    signs = jnp.array([-1.0, 1.0], dtype=omega.dtype)
    guesses = (base[:, None, :] * signs[None, :, None]).reshape(
        2 * n_eigvecs, 9)

    def refine_one(guess):
        r_start = nearest_so3(guess)
        r, energy = newton_refine(r_start, omega, max_iter=max_iter,
                                  omega_inv=omega_inv)
        # Gyro penalty: robot forward direction in world frame is R^T d
        # where d = fwd_in_cam (sqpnp/src/lib.rs:410-420; the column-major
        # index arithmetic there computes exactly (R^T d)_x, (R^T d)_y).
        d = fwd_in_cam
        fwd_x = r[0] * d[0] + r[1] * d[1] + r[2] * d[2]
        fwd_y = r[3] * d[0] + r[4] * d[1] + r[5] * d[2]
        dot = fwd_x * gyro_cos + fwd_y * gyro_sin
        angle_error = jnp.maximum(1.0 - dot, 0.0)
        return r, energy + sign_change_error * angle_error, energy

    return jax.vmap(refine_one)(guesses)


@highest_precision
def solve_sqpnp(points_3d: jax.Array, points_2d: jax.Array, mask: jax.Array,
                fwd_in_cam: jax.Array, gyro_cos, gyro_sin, sign_change_error,
                max_iter: int = MAX_ITER, plaus_fn=None) -> SqPnPResult:
    """Full single-frame SQPnP solve with fixed-capacity masked points.

    Port of ``SqPnP::solve`` (``sqpnp/src/lib.rs:248-295``): centroid shift,
    omega build, candidate refinement, cheirality filter, best-penalized-energy
    selection, translation recovery t = t_local - R c.

    Args:
      points_3d: [N, 3] world-frame corner points (padded).
      points_2d: [N, 3] camera rays (padded).
      mask: [N] bool validity.
      fwd_in_cam: [3] robot-forward direction expressed in the camera frame.
      plaus_fn: optional physical-plausibility TIEBREAK, an extension beyond
        the reference: ``(r_mats [6, 3, 3], t_all [6, 3]) -> [6]`` penalties
        (smaller = more physically plausible, e.g. the robot's height off
        the floor). Planar targets (every FRC tag wall) have a two-fold
        pose ambiguity whose two basins' energies TIE at the corner-noise
        floor on near-exact scenes — measured: the MIRROR pose (robot 2 m
        in the air) beat the true pose by 0.4% in f64 reprojection energy
        on a rendered two-tag wall. Energy cannot break that tie, physics
        can. Candidates within one regularization shift (eps * ||r||^2 —
        differences below it are meaningless: the Newton steps themselves
        are eps-blurred) of the best cheirality-valid energy are re-ranked
        by plaus_fn instead. Scenes with real noise sit far above the
        band, where selection is exactly the reference's argmin.
    """
    dtype = points_3d.dtype

    # Sanitize BEFORE any arithmetic: padded slots may hold garbage and real
    # points may be non-finite (diverged unprojects); `NaN * 0 = NaN` would
    # poison omega through the masked sums below. Non-finite real points are
    # dropped from the mask, matching the reference's behavior of discarding
    # corners that fail to unproject (crates/apriltags/src/lib.rs:316-328).
    finite = jnp.all(jnp.isfinite(points_3d), axis=-1) & jnp.all(
        jnp.isfinite(points_2d), axis=-1
    )
    mask = mask & finite
    safe_ray = jnp.zeros_like(points_2d).at[..., 2].set(1.0)
    points_3d = jnp.where(mask[:, None], points_3d, 0.0)
    points_2d = jnp.where(mask[:, None], points_2d, safe_ray)

    n = jnp.sum(mask)
    enough = n >= 3  # reference requires >= 3 points (lib.rs:255-257)

    mf = mask.astype(dtype)[:, None]
    centroid = jnp.sum(points_3d * mf, axis=0) / jnp.maximum(n.astype(dtype), 1.0)
    centered = (points_3d - centroid) * mf

    omega, q_tt_inv, q_rt = build_linear_system(centered, points_2d, mask)

    r_vecs, penalized, pure = solve_candidates(
        omega, fwd_in_cam, gyro_cos, gyro_sin, sign_change_error, max_iter=max_iter
    )

    # Translation per candidate: t_local = -Q_tt^{-1} Q_rt^T r;
    # t = t_local - R c  (lib.rs:272-273).
    def trans_of(r):
        t_local = -(q_tt_inv @ (q_rt.T @ r))
        r_mat = r.reshape(3, 3).T  # column-major unpack
        return t_local - r_mat @ centroid, r_mat

    t_all, r_mats = jax.vmap(trans_of)(r_vecs)  # [6,3], [6,3,3]

    # Cheirality: all masked world points must land in front of the camera
    # (z > 0, lib.rs:275-282).
    p_cam_z = (
        jnp.einsum("cij,nj->cni", r_mats, points_3d)[..., 2] + t_all[:, None, 2]
    )  # [6, N]
    in_front = jnp.all(p_cam_z > 0.0, axis=1, where=mask[None, :])  # [6]

    score = jnp.where(in_front, penalized, jnp.inf)
    if plaus_fn is None:
        best = jnp.argmin(score)
    else:
        # Tiebreak band: the omega regularization shift scaled by
        # ||r||^2 = 3 (rotation 9-vectors) — the energy resolution floor.
        eps = 1e-4 * jnp.maximum(jnp.trace(omega) / 9.0, 1e-12)
        e_min = jnp.min(score)
        tied = score <= e_min + 3.0 * eps
        plaus = plaus_fn(r_mats, t_all)
        best = jnp.argmin(jnp.where(tied, plaus, jnp.inf))
    # Winner extraction by select-sum, not x[best] gathers: the select
    # fuses with its producers where a tiny dynamic gather would not (see
    # the one-hot lookup note in chalkydri_tpu/pipeline.py); a one-hot masked sum of
    # a single nonzero row is bitwise the same value.
    sel = jnp.arange(score.shape[0]) == best
    pick = lambda x: jnp.sum(
        jnp.where(sel.reshape(sel.shape + (1,) * (x.ndim - 1)), x, 0),
        axis=0,
    )
    valid = jnp.isfinite(pick(score)) & enough

    return SqPnPResult(
        rotation=pick(r_mats),
        translation=pick(t_all),
        energy=pick(pure),
        valid=valid,
    )
