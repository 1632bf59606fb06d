"""Stage 5: payload decode — sample bits through the homography, match the
family codebook, score a decision margin.

Replaces libapriltag's quad_decode (via apriltag-sys in the reference;
family/bits_corrected config at
``/root/reference/crates/apriltags/src/lib.rs:227-261``):

- fit linear intensity models for 'black' (border ring samples) and 'white'
  (ring just outside the tag) — the threshold surface is their midpoint,
- bilinear-sample each data cell center, bit = sample > threshold,
- XOR + popcount against all codes x 4 rotations in ONE batched integer op
  (the codebook is one dense table; libapriltag walks a per-quad C hash instead),
- decision_margin = mean |sample - threshold| over data cells (same scale
  and intent as libapriltag's margin; used by
  ``filtered_by_decision_margin``, crates/apriltags/src/lib.rs:127-141),
- corners are rolled so the output corner order is canonical with respect to
  the DECODED tag orientation (detection corners match the tag frame corner
  model at crates/chalkydri_sqpnp/src/lib.rs:379-394).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from chalkydri_tpu.detector.families import TagFamily
from chalkydri_tpu.detector.homography import (
    apply_homography,
    bilinear_sample,
    homography_from_corners,
)
from chalkydri_tpu.ops.linalg import spd_solve


class Decoded(NamedTuple):
    tag_id: jax.Array  # [K] int32 (-1 when invalid)
    hamming: jax.Array  # [K] int32
    decision_margin: jax.Array  # [K] float32
    corners: jax.Array  # [K, 4, 2] rotation-corrected corners
    valid: jax.Array  # [K] bool


def _popcount32(x: jax.Array) -> jax.Array:
    """Vectorized popcount for uint32."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def _sample_grids(family: TagFamily):
    """Static (host-side) sample coordinate tables in tag coords.

    Returns (data_xy [nbits, 2], black_xy [nb, 2], white_xy [nw, 2]).
    Tag coords: [-1, 1] spans the outer edge of the black border; +y is UP in
    the image (see homography.py), data row r runs top (high y) to bottom.
    """
    dim = family.dim
    td = family.total_dim
    s = 2.0 / td

    def cell_center(r, c):
        x = -1.0 + (c + 1 + 0.5) * s
        y = 1.0 - (r + 1 + 0.5) * s
        return (x, y)

    data = [cell_center(r, c) for r in range(dim) for c in range(dim)]

    # Black samples: border ring cell centers.
    black = []
    for i in range(td):
        for j in range(td):
            if i in (0, td - 1) or j in (0, td - 1):
                x = -1.0 + (j + 0.5) * s
                y = 1.0 - (i + 0.5) * s
                black.append((x, y))

    # White samples: ring half a cell outside the border.
    white = []
    m = 1.0 + 0.5 * s
    n_side = td + 1
    for i in range(n_side):
        t = -m + (2 * m) * i / (n_side - 1)
        white.extend([(t, m), (t, -m), (m, t), (-m, t)])

    to = lambda v: np.asarray(v, np.float32)
    return to(data), to(black), to(white)


def _fit_linear_model(xy: jax.Array, values: jax.Array):
    """Least-squares fit v ~ a + b x + c y. xy [S, 2], values [S].

    The 3x3 normal matrix is SPD (+ ridge), so the no-pivot solve applies
    (jnp.linalg.solve's pivoted LU is a serial pivot search, ops/linalg.py).
    Products at HIGHEST precision: a default-precision matmul may run in
    TF32 or bf16 (utils/precision.py), which would corrupt
    the intensity model at the [0, 255] x tag-coordinate scale.
    """
    hp = jax.lax.Precision.HIGHEST
    ones = jnp.ones_like(values)
    a = jnp.stack([ones, xy[..., 0], xy[..., 1]], axis=-1)  # [S, 3]
    ata = jnp.matmul(a.T, a, precision=hp) + 1e-6 * jnp.eye(
        3, dtype=values.dtype
    )
    atb = jnp.matmul(a.T, values, precision=hp)
    return spd_solve(ata, atb)  # [3]


def _eval_linear(coef: jax.Array, xy: jax.Array) -> jax.Array:
    return coef[0] + coef[1] * xy[..., 0] + coef[2] * xy[..., 1]


def make_decoder(family: TagFamily, bits_corrected: int = 2):
    """Build a jittable decode(gray, corners, quad_valid) for one family.

    The family's tables are closed over as device constants.
    """
    data_xy_np, black_xy_np, white_xy_np = _sample_grids(family)
    data_xy = jnp.asarray(data_xy_np)
    black_xy = jnp.asarray(black_xy_np)
    white_xy = jnp.asarray(white_xy_np)
    codes32 = jnp.asarray(family.codes32)  # [N, 4, 2] uint32
    nbits = family.nbits
    dim = family.dim

    # bit index (MSB-first over row-major grid) -> which uint32 half and bit.
    weights_hi = jnp.asarray(
        [1 << (nbits - 1 - i - 32) if nbits - 1 - i >= 32 else 0 for i in range(nbits)],
        jnp.uint32,
    )
    weights_lo = jnp.asarray(
        [1 << (nbits - 1 - i) if nbits - 1 - i < 32 else 0 for i in range(nbits)],
        jnp.uint32,
    )

    def decode_quad(gray, corners, quad_valid, hw=None, base=None):
        h = homography_from_corners(corners)
        d_pix = apply_homography(h, data_xy)
        b_pix = apply_homography(h, black_xy)
        w_pix = apply_homography(h, white_xy)

        d_val = bilinear_sample(gray, d_pix, hw=hw, base=base)
        b_val = bilinear_sample(gray, b_pix, hw=hw, base=base)
        w_val = bilinear_sample(gray, w_pix, hw=hw, base=base)

        black_coef = _fit_linear_model(black_xy, b_val)
        white_coef = _fit_linear_model(white_xy, w_val)

        thresh = 0.5 * (_eval_linear(black_coef, data_xy) + _eval_linear(white_coef, data_xy))
        bits = d_val > thresh  # [nbits]
        margin = jnp.mean(jnp.abs(d_val - thresh))

        # Border sanity: black must actually be darker than white.
        contrast_ok = jnp.mean(w_val) - jnp.mean(b_val) > 10.0

        hi = jnp.sum(jnp.where(bits, weights_hi, jnp.uint32(0)))
        lo = jnp.sum(jnp.where(bits, weights_lo, jnp.uint32(0)))

        ham = _popcount32(codes32[..., 0] ^ hi) + _popcount32(codes32[..., 1] ^ lo)
        ham_flat = ham.reshape(-1)  # [N*4]
        best = jnp.argmin(ham_flat)
        best_ham = jnp.min(ham_flat)  # == ham_flat[best]; min avoids the
        #   tiny dynamic gather
        tag_id = (best // 4).astype(jnp.int32)
        rot = (best % 4).astype(jnp.int32)

        ok = quad_valid & contrast_ok & (best_ham <= bits_corrected)

        # Rotation-correct the corners so corner 0 is the tag-frame
        # bottom-left (canonical order BL, BR, TR, TL — libapriltag's
        # convention and the solver's corner model,
        # crates/chalkydri_sqpnp/src/lib.rs:379-394). The roll is
        # ``2 - rot``, validated against rendered ground truth at all four
        # physical rotations (tests/test_detector.py).
        rolled = jnp.stack(
            [jnp.roll(corners, 2 - r, axis=0) for r in range(4)]
        )  # [4, 4, 2]
        selr = jnp.arange(4) == rot  # one-hot select, not a dynamic gather
        corners_out = jnp.sum(
            jnp.where(selr[:, None, None], rolled, 0.0), axis=0)

        return Decoded(
            tag_id=jnp.where(ok, tag_id, -1),
            hamming=best_ham.astype(jnp.int32),
            decision_margin=margin,
            corners=corners_out,
            valid=ok,
        )

    @partial(jax.jit, static_argnames=("hw",))
    def decode(gray, corners, quad_valid, hw=None, base=None):
        """gray [H, W] (or flat packed u32 + ``hw``/``base``, see
        ``bilinear_sample``); corners [K, 4, 2]; quad_valid [K] ->
        Decoded [K]."""
        return jax.vmap(
            lambda c, v: decode_quad(gray, c, v, hw=hw, base=base)
        )(corners, quad_valid)

    return decode
