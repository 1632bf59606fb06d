"""Stage 4: quad fitting — turn each boundary cluster into a candidate quad.

libapriltag's fit_quads (via apriltag-sys in the reference, SURVEY.md
section 2.3) sorts boundary points by angle, finds 4 corner indices by line-fit
error peaks, then refits lines per edge and intersects them. The custom
detector sketches the same geometry via gift-wrapping
(``/root/reference/crates/chalkydri-apriltags/src/utils.rs:27-153``).

Batched re-design: a fixed-iteration expectation-maximization style fit,
VECTORIZED over clusters AND edges (shapes [K, 4, P] throughout — per-edge
Python loops of tiny ops cost more in launch overhead than the math itself):

1. init corners at the extreme points along the 4 diagonal directions
   (+x+y, +x-y, -x-y, -x+y) — robust for convex quads,
2. repeat N times (static): assign each boundary point to the nearest of the
   4 current edges (one-hot), weighted least-squares line fits via batched
   moment accumulation (closed-form 2x2 eigenvector), corners = adjacent
   line intersections,
3. quad filters: every edge supported by >= MIN_EDGE_POINTS points, min edge
   length, convexity, bounded residual.

Corners come out ordered counter-clockwise in image coords (y down) starting
from the corner that, for an upright tag, is bottom-left — matching
libapriltag's detection corner convention, which in turn matches the solver's
tag-frame corner order (``crates/chalkydri_sqpnp/src/lib.rs:379-394``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

FIT_ITERS = 4  # refine_quads recovers sub-pixel accuracy afterwards
MIN_EDGE_POINTS = 5
MIN_EDGE_LEN = 6.0  # pixels
MAX_LINE_RMS = 1.2  # pixels, residual gate


class Quads(NamedTuple):
    corners: jax.Array  # [K, 4, 2] float32, CCW (image coords, y down)
    valid: jax.Array  # [K] bool


def _line_fits_batched(px, py, w):
    """Weighted PCA line fits for all clusters x edges at once.

    px, py: [K, P]; w: [K, 4, P] per-edge weights.
    Returns (cx, cy, nx, ny, rms) each [K, 4] — point-normal line form.
    """
    wsum = jnp.maximum(jnp.sum(w, axis=-1), 1e-6)  # [K, 4]
    cx = jnp.einsum("kep,kp->ke", w, px) / wsum
    cy = jnp.einsum("kep,kp->ke", w, py) / wsum
    dx = px[:, None, :] - cx[..., None]  # [K, 4, P]
    dy = py[:, None, :] - cy[..., None]
    sxx = jnp.sum(w * dx * dx, axis=-1) / wsum
    syy = jnp.sum(w * dy * dy, axis=-1) / wsum
    sxy = jnp.sum(w * dx * dy, axis=-1) / wsum
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
    lam_small = tr / 2.0 - disc
    n1x, n1y = sxy, lam_small - sxx
    n2x, n2y = lam_small - syy, sxy
    use1 = n1x * n1x + n1y * n1y > n2x * n2x + n2y * n2y
    nx = jnp.where(use1, n1x, n2x)
    ny = jnp.where(use1, n1y, n2y)
    norm = jnp.sqrt(jnp.maximum(nx * nx + ny * ny, 1e-12))
    nx = nx / norm
    ny = ny / norm
    rms = jnp.sqrt(jnp.maximum(lam_small, 0.0))
    return cx, cy, nx, ny, rms


def _intersect_batched(c1x, c1y, n1x, n1y, c2x, c2y, n2x, n2y):
    """Intersections of point-normal line pairs (all [K, 4])."""
    det = n1x * n2y - n1y * n2x
    safe = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
    b1 = n1x * c1x + n1y * c1y
    b2 = n2x * c2x + n2y * c2y
    x = (b1 * n2y - b2 * n1y) / safe
    y = (n1x * b2 - n2x * b1) / safe
    return x, y


def _fit_quads_core(points: jax.Array, mask: jax.Array, fit_iters: int):
    """points [4, K, P] channel-first (x, y, gx, gy — see cluster.Clusters),
    mask [K, P] -> (corners [K, 4, 2], valid [K])."""
    px = points[0]  # [K, P]
    py = points[1]
    w = mask.astype(jnp.float32)  # [K, P]
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-6)
    ccx = jnp.sum(px * w, axis=-1, keepdims=True) / wsum  # [K, 1]
    ccy = jnp.sum(py * w, axis=-1, keepdims=True) / wsum

    # --- init: extremes along 4 diagonals [K, 4, 2] ------------------------
    neg = jnp.float32(-1e9)
    rx = px - ccx
    ry = py - ccy
    scores = jnp.stack(
        [rx + ry, rx - ry, -rx - ry, -rx + ry], axis=1
    )  # [K, 4, P]
    scores = jnp.where(mask[:, None, :], scores, neg)
    arg = jnp.argmax(scores, axis=-1)  # [K, 4]
    corners = jnp.stack(
        [jnp.take_along_axis(px, arg, axis=-1),
         jnp.take_along_axis(py, arg, axis=-1)],
        axis=-1,
    )  # [K, 4, 2]

    counts = jnp.zeros(corners.shape[:2], jnp.float32)
    rmss = jnp.zeros(corners.shape[:2], jnp.float32)
    for _ in range(fit_iters):
        # Edge e runs corner e -> corner (e+1)%4.
        c0 = corners  # [K, 4, 2]
        c1 = jnp.roll(corners, -1, axis=1)
        ex = c1[..., 0] - c0[..., 0]  # [K, 4]
        ey = c1[..., 1] - c0[..., 1]
        el2 = jnp.maximum(ex * ex + ey * ey, 1e-12)
        rx = px[:, None, :] - c0[..., 0:1]  # [K, 4, P]
        ry = py[:, None, :] - c0[..., 1:2]
        t = jnp.clip((rx * ex[..., None] + ry * ey[..., None]) / el2[..., None], 0.0, 1.0)
        qx = c0[..., 0:1] + t * ex[..., None]
        qy = c0[..., 1:2] + t * ey[..., None]
        d2 = (px[:, None, :] - qx) ** 2 + (py[:, None, :] - qy) ** 2  # [K, 4, P]
        assign = jnp.argmin(d2, axis=1)  # [K, P]
        onehot = jax.nn.one_hot(assign, 4, axis=1, dtype=jnp.float32)  # [K, 4, P]
        we = onehot * w[:, None, :]
        counts = jnp.sum(we, axis=-1)  # [K, 4]

        fcx, fcy, fnx, fny, rmss = _line_fits_batched(px, py, we)
        # corner e = intersection of edge (e-1) and edge e
        pcx = jnp.roll(fcx, 1, axis=1)
        pcy = jnp.roll(fcy, 1, axis=1)
        pnx = jnp.roll(fnx, 1, axis=1)
        pny = jnp.roll(fny, 1, axis=1)
        x, y = _intersect_batched(pcx, pcy, pnx, pny, fcx, fcy, fnx, fny)
        corners = jnp.stack([x, y], axis=-1)

    # --- orientation: make CCW in image coords (y down) --------------------
    c_next = jnp.roll(corners, -1, axis=1)
    area2 = jnp.sum(
        corners[..., 0] * c_next[..., 1] - c_next[..., 0] * corners[..., 1],
        axis=-1,
    )  # [K]
    flip = (area2 > 0)[:, None, None]
    corners = jnp.where(flip, corners[:, ::-1, :], corners)

    # --- validity gates ----------------------------------------------------
    c_next = jnp.roll(corners, -1, axis=1)
    elen = jnp.linalg.norm(c_next - corners, axis=-1)  # [K, 4]
    c_next2 = jnp.roll(c_next, -1, axis=1)
    cross = (
        (c_next[..., 0] - corners[..., 0]) * (c_next2[..., 1] - c_next[..., 1])
        - (c_next[..., 1] - corners[..., 1]) * (c_next2[..., 0] - c_next[..., 0])
    )  # [K, 4]
    convex = jnp.all(cross < 0, axis=-1) | jnp.all(cross > 0, axis=-1)
    finite = jnp.all(jnp.isfinite(corners), axis=(1, 2))
    valid = (
        finite
        & convex
        & jnp.all(counts >= MIN_EDGE_POINTS, axis=-1)
        & jnp.all(elen >= MIN_EDGE_LEN, axis=-1)
        & jnp.all(rmss <= MAX_LINE_RMS, axis=-1)
    )
    return corners, valid


def fit_quad(points: jax.Array, mask: jax.Array,
             fit_iters: int = FIT_ITERS) -> tuple[jax.Array, jax.Array]:
    """Fit one quad to one cluster (points [4, P] channel-first, mask [P])."""
    corners, valid = _fit_quads_core(points[:, None], mask[None], fit_iters)
    return corners[0], valid[0]


@partial(jax.jit, static_argnames=("fit_iters",))
def fit_quads(points: jax.Array, mask: jax.Array, cluster_valid: jax.Array,
              fit_iters: int = FIT_ITERS) -> Quads:
    """Fit all clusters of one frame: points [4, K, P] channel-first,
    mask [K, P]."""
    corners, valid = _fit_quads_core(points, mask, fit_iters)
    return Quads(corners=corners, valid=valid & cluster_valid)
