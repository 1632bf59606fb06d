"""Stage 6: sub-pixel edge refinement (libapriltag refine_edges equivalent).

The cluster-midpoint quads carry a ~0.5 px inward bias (boundary points sit at
midpoints between the last black and first white pixel centers). libapriltag's
refine_edges recovers sub-pixel accuracy by snapping each edge line to the
image's actual intensity gradient; the reference gets this through apriltag-sys
(corner accuracy target <0.1 px, BASELINE.md config #5).

Vectorized batched version, per quad edge:

- sample S points along the edge (excluding corner neighborhoods),
- at each, walk the outward normal in [-R, R] with sub-pixel steps, bilinear-
  sampling the grayscale image,
- the gradient-magnitude-weighted centroid of |d(intensity)/dn| along that
  walk is the sub-pixel edge crossing,
- refit each edge line through its S adjusted points (weighted PCA),
- corners = intersections of adjacent refined lines.

All gathers are batched bilinear samples; one [K, 4, S, W] tensor per frame.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from chalkydri_tpu.detector.homography import bilinear_sample
from chalkydri_tpu.detector.quad import _intersect_batched, _line_fits_batched

N_SAMPLES = 8  # points per edge
N_WALK = 9  # samples along the normal
WALK_RANGE = 2.0  # pixels each side


@partial(jax.jit,
         static_argnames=("n_samples", "n_walk", "walk_range", "hw"))
def refine_quads(
    gray: jax.Array,  # [H, W] uint8/float, or flat packed u32 (see below)
    corners: jax.Array,  # [K, 4, 2]
    valid: jax.Array,  # [K]
    n_samples: int = N_SAMPLES,
    n_walk: int = N_WALK,
    walk_range: float = WALK_RANGE,
    hw: tuple[int, int] | None = None,
    base: jax.Array | None = None,
):
    """Refine all quads of one frame. Returns corners [K, 4, 2] float32.

    ``hw``/``base``: flat multi-frame sampling form — ``gray`` is a 1-D
    packed uint32 table of stacked frames, ``hw`` the per-frame geometry
    and ``base`` this frame's flat offset (see ``bilinear_sample``); used
    by the batched post-cluster tail to keep the gather table unbatched
    under the per-frame vmap."""
    k = corners.shape[0]
    c0 = corners  # [K, 4, 2]
    c1 = jnp.roll(corners, -1, axis=1)  # edge endpoints

    # Sample fractions, avoiding the corner regions (t in [0.15, 0.85]).
    t = jnp.linspace(0.15, 0.85, n_samples, dtype=jnp.float32)  # [S]
    px = c0[:, :, None, 0] + t[None, None, :] * (c1 - c0)[:, :, None, 0]
    py = c0[:, :, None, 1] + t[None, None, :] * (c1 - c0)[:, :, None, 1]  # [K,4,S]

    ex = c1[..., 0] - c0[..., 0]  # [K, 4]
    ey = c1[..., 1] - c0[..., 1]
    elen = jnp.sqrt(jnp.maximum(ex * ex + ey * ey, 1e-9))
    # Outward normal: for a CCW-in-y-down quad (negative shoelace), the
    # outward normal of edge (dx, dy) is (dy, -dx) / len.
    nx = ey / elen
    ny = -ex / elen

    w = jnp.linspace(-walk_range, walk_range, n_walk, dtype=jnp.float32)  # [W]
    sx = px[..., None] + nx[:, :, None, None] * w  # [K, 4, S, W]
    sy = py[..., None] + ny[:, :, None, None] * w

    vals = bilinear_sample(
        gray, jnp.stack([sx, sy], axis=-1), hw=hw, base=base
    )  # [K, 4, S, W]

    # Gradient along the walk; positions at midpoints of adjacent samples.
    grad = jnp.abs(vals[..., 1:] - vals[..., :-1])  # [K, 4, S, W-1]
    wmid = 0.5 * (w[1:] + w[:-1])  # [W-1]
    gsum = jnp.maximum(jnp.sum(grad, axis=-1), 1e-6)
    offset = jnp.sum(grad * wmid, axis=-1) / gsum  # [K, 4, S]
    # Confidence: total gradient mass along the walk (low = no real edge).
    conf = jnp.sum(grad, axis=-1)  # [K, 4, S]

    ax = px + offset * nx[:, :, None]
    ay = py + offset * ny[:, :, None]  # adjusted points [K, 4, S]

    # All K x 4 edge line fits in ONE batched call (each edge has its own
    # sample points, so edges fold into the cluster axis with a singleton
    # edge dim) — per-edge Python-loop fits were ~4x the sequential tiny-op
    # chain on this latency-bound stage.
    fcx, fcy, fnx, fny, _ = _line_fits_batched(
        ax.reshape(k * 4, n_samples),
        ay.reshape(k * 4, n_samples),
        conf.reshape(k * 4, 1, n_samples),
    )  # each [K*4, 1]
    fcx, fcy, fnx, fny = (
        f.reshape(k, 4) for f in (fcx, fcy, fnx, fny)
    )
    # corner e = intersection of edge (e-1) and edge e
    pcx, pcy = jnp.roll(fcx, 1, axis=1), jnp.roll(fcy, 1, axis=1)
    pnx, pny = jnp.roll(fnx, 1, axis=1), jnp.roll(fny, 1, axis=1)
    x, y = _intersect_batched(pcx, pcy, pnx, pny, fcx, fcy, fnx, fny)
    new_corners = jnp.stack([x, y], axis=-1)  # [K, 4, 2]
    # Guard: refinement must not move a corner more than the walk range
    # (+1 px slack); otherwise keep the original.
    delta = jnp.linalg.norm(new_corners - corners, axis=-1)
    ok = (delta < walk_range + 1.0)[..., None] & jnp.isfinite(new_corners)
    refined = jnp.where(ok, new_corners, corners)
    return jnp.where(valid[:, None, None], refined, corners)
