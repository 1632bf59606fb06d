"""Homography estimation + bilinear image sampling for tag decoding.

libapriltag computes a homography from the tag's unit square to the fitted
quad (via apriltag-sys in the reference, SURVEY.md section 2.3). Here the
4-point DLT is solved in closed form per quad (vmapped batch of 8x8 systems),
and payload sampling is a batched bilinear gather from the grayscale frame.

Tag coordinate convention: the quad's corners correspond to
(-1, -1), (1, -1), (1, 1), (-1, 1) in tag coordinates — the OUTER edge of the
black border ring. With the detector's corner order (BL, BR, TR, TL for an
upright tag, y down in the image) this puts tag +x to the right and tag +y
UP in the image, so data-grid row r (top to bottom) lives at decreasing y.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from chalkydri_tpu.ops.linalg import lstsq_spd

# Tag-frame corners in the order the quad fitter emits them (BL, BR, TR, TL
# in image terms for an upright tag). Host constant (np, not jnp): creating
# a device array at import time would commit a JAX backend the moment
# chalkydri_tpu is imported, before the application can choose one.
TAG_CORNERS = np.array(
    [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], dtype=np.float32
)


def homography_from_corners(corners: jax.Array) -> jax.Array:
    """DLT homography H mapping tag coords -> image pixels.

    corners: [4, 2] image corners ordered to match TAG_CORNERS.
    Returns H [3, 3] with H[2,2] = 1.

    The 8x8 DLT system is solved via SPD normal equations after Hartley
    normalization of the pixel side (shift to the centroid, scale mean
    corner distance to sqrt(2)): the source side is already the unit
    square, so the normalized system is well-conditioned (cond ~ 10) and
    the normal equations are safe in f32 — while avoiding the pivoted 8x8
    LU's serial pivot search (ops/linalg.py).
    """
    dtype = corners.dtype
    src = TAG_CORNERS.astype(dtype)
    centroid = corners.mean(axis=0)
    scale = jnp.sqrt(jnp.asarray(2.0, dtype)) / jnp.maximum(
        jnp.mean(jnp.linalg.norm(corners - centroid, axis=-1)), 1e-6
    )
    norm = (corners - centroid) * scale  # normalized pixel corners

    rows = []
    rhs = []
    for i in range(4):
        x, y = src[i, 0], src[i, 1]
        u, v = norm[i, 0], norm[i, 1]
        rows.append(
            jnp.stack([x, y, jnp.ones_like(x), jnp.zeros_like(x),
                       jnp.zeros_like(x), jnp.zeros_like(x), -u * x, -u * y])
        )
        rhs.append(u)
        rows.append(
            jnp.stack([jnp.zeros_like(x), jnp.zeros_like(x), jnp.zeros_like(x),
                       x, y, jnp.ones_like(x), -v * x, -v * y])
        )
        rhs.append(v)
    a = jnp.stack(rows)  # [8, 8]
    b = jnp.stack(rhs)  # [8]
    h8 = lstsq_spd(a, b)
    hn = jnp.concatenate([h8, jnp.ones_like(h8[:1])]).reshape(3, 3)
    # Denormalize: pixels = T^-1 @ normalized with
    # T^-1 = [[1/s, 0, cx], [0, 1/s, cy], [0, 0, 1]] — composed ELEMENTWISE,
    # not as a matmul: a default-precision float32 matmul may run in a
    # reduced-precision mode (TF32 on the GPU's tensor cores), which would
    # quantize the pixel-scale translation (centroid up to ~1600) and shift
    # every decode sample (utils/precision.py documents the same hazard
    # for the solver path).
    inv_s = 1.0 / scale
    h = jnp.stack([
        hn[0] * inv_s + centroid[0] * hn[2],
        hn[1] * inv_s + centroid[1] * hn[2],
        hn[2],
    ])
    return h / h[2, 2]


def apply_homography(h: jax.Array, pts: jax.Array) -> jax.Array:
    """Map tag-frame points [..., 2] through H [3, 3] -> pixels [..., 2]."""
    x, y = pts[..., 0], pts[..., 1]
    w = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    u = (h[0, 0] * x + h[0, 1] * y + h[0, 2]) / w
    v = (h[1, 0] * x + h[1, 1] * y + h[1, 2]) / w
    return jnp.stack([u, v], axis=-1)


def pack_neighborhood(img: jax.Array) -> jax.Array:
    """Pack each pixel's 2x2 neighborhood into one uint32 word.

    byte 0 = (y, x), byte 1 = (y, x+1), byte 2 = (y+1, x),
    byte 3 = (y+1, x+1); the last row/column replicate (matching
    bilinear_sample's border clamp). Bilinear sampling a packed image costs
    ONE gather per sample instead of four (random 1D gathers dominate the
    sampling stages). Pack once per frame and share across refine +
    decode.

    Accepts [H, W] or any leading batch dims ([..., H, W]): the packing
    operates on the trailing two axes, per frame.
    """
    p = img.astype(jnp.uint32)
    right = jnp.concatenate([p[..., 1:], p[..., -1:]], axis=-1)
    down = jnp.concatenate([p[..., 1:, :], p[..., -1:, :]], axis=-2)
    downright = jnp.concatenate([down[..., 1:], down[..., -1:]], axis=-1)
    return p | (right << 8) | (down << 16) | (downright << 24)


def bilinear_sample(img: jax.Array, xy: jax.Array, hw=None,
                    base=None) -> jax.Array:
    """Bilinear sample a [H, W] image at float pixel coords [..., 2].

    ``img`` is either a raw grayscale image (4-gather path) or a
    ``pack_neighborhood`` uint32 image (single-gather fast path —
    bit-identical results). Out-of-bounds coordinates clamp to the border
    (callers gate validity separately). Returns float32 samples.

    Flat multi-frame form: ``img`` may be a 1-D uint32 packed table
    holding B stacked frames (``pack_neighborhood(batch).reshape(-1)``)
    with ``hw=(h, w)`` giving the per-frame geometry and ``base`` a
    per-sample flat offset (``frame_index * h * w``, broadcastable to
    ``xy[..., 0]``). This keeps the gather TABLE unbatched when callers
    vmap over frames, so the batch costs no extra gather dimension.
    """
    if img.ndim == 1:
        if img.dtype != jnp.uint32:
            raise ValueError("flat bilinear_sample requires a packed "
                             "uint32 table")
        if hw is None:
            raise ValueError("flat bilinear_sample requires hw=(h, w)")
        h, w = hw
    else:
        h, w = img.shape
    x = jnp.clip(xy[..., 0], 0.0, w - 1.000001)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.000001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    if img.dtype == jnp.uint32:  # packed 2x2 neighborhoods
        idx = y0 * w + x0
        if base is not None:
            idx = idx + base
        word = img.reshape(-1)[idx]
        v00 = (word & 0xFF).astype(jnp.float32)
        v01 = ((word >> 8) & 0xFF).astype(jnp.float32)
        v10 = ((word >> 16) & 0xFF).astype(jnp.float32)
        v11 = ((word >> 24) & 0xFF).astype(jnp.float32)
    else:
        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
        flat = img.reshape(-1).astype(jnp.float32)
        v00 = flat[y0 * w + x0]
        v01 = flat[y0 * w + x1]
        v10 = flat[y1 * w + x0]
        v11 = flat[y1 * w + x1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
