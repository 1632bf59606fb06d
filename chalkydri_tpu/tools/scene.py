"""Synthetic AprilTag scenes in numpy alone (no OpenCV).

The bench, the chip smoke test and the multi-device dryrun draw their
frames with this warp, so they run wherever numpy and JAX do. The test
suite's ground-truth renderer (tests/reference_impl/render.py) warps with
OpenCV instead; both put the outer black-border corners exactly at the
requested pixel coordinates (cell boundaries sit at pixel center - 0.5).
"""

from __future__ import annotations

import numpy as np

from chalkydri_tpu.detector.families import TagFamily, render_tag


def homography(src, dst) -> np.ndarray:
    """DLT homography [3, 3] mapping 4+ src points [N, 2] onto dst."""
    rows = []
    for (x, y), (u, v) in zip(src, dst):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, vt = np.linalg.svd(np.asarray(rows, np.float64))
    return vt[-1].reshape(3, 3)


def paste_tag(canvas: np.ndarray, img: np.ndarray, corners_dst,
              cell_px: int) -> None:
    """Bilinear inverse-warp a rendered tag (incl. a one-cell white border)
    onto ``canvas`` in place, its outer black-border corners landing at
    ``corners_dst`` [4, 2] (BL, BR, TR, TL in image coords)."""
    corners_dst = np.asarray(corners_dst, np.float64)
    side = img.shape[0]
    b = float(cell_px)
    src = np.array(
        [[b, side - b], [side - b, side - b], [side - b, b], [b, b]],
        np.float64,
    ) - 0.5
    hinv = np.linalg.inv(homography(src, corners_dst))

    # Canvas region to touch: dst bbox padded by ~1.5 cells of white border.
    edge = float(np.linalg.norm(corners_dst[1] - corners_dst[0]))
    pad = 1.5 * edge / (side / cell_px - 2.0)
    x0 = max(0, int(np.floor(corners_dst[:, 0].min() - pad)))
    x1 = min(canvas.shape[1], int(np.ceil(corners_dst[:, 0].max() + pad)) + 1)
    y0 = max(0, int(np.floor(corners_dst[:, 1].min() - pad)))
    y1 = min(canvas.shape[0], int(np.ceil(corners_dst[:, 1].max() + pad)) + 1)
    if x1 <= x0 or y1 <= y0:
        return
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=0)
    uvw = hinv @ pts
    u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]

    inside = (u >= -0.5) & (u <= side - 0.5) & (v >= -0.5) & (v <= side - 0.5)
    uc = np.clip(u, 0, side - 1.0)
    vc = np.clip(v, 0, side - 1.0)
    iu, iv = np.floor(uc).astype(int), np.floor(vc).astype(int)
    iu1, iv1 = np.minimum(iu + 1, side - 1), np.minimum(iv + 1, side - 1)
    fu, fv = uc - iu, vc - iv
    val = (
        img[iv, iu] * (1 - fu) * (1 - fv)
        + img[iv, iu1] * fu * (1 - fv)
        + img[iv1, iu] * (1 - fu) * fv
        + img[iv1, iu1] * fu * fv
    )
    region = canvas[y0:y1, x0:x1].ravel()
    region[inside] = np.round(val[inside]).astype(np.uint8)
    canvas[y0:y1, x0:x1] = region.reshape(y1 - y0, x1 - x0)


def place_tag(canvas: np.ndarray, family: TagFamily, tag_id: int,
              corners_dst, cell_px: int = 16) -> np.ndarray:
    """Draw tag ``tag_id`` with its outer black-border corners at
    ``corners_dst`` [4, 2] (BL, BR, TR, TL). Returns those corners, the
    ground truth a correct detector reports for an upright tag."""
    img = render_tag(family, tag_id, cell_px=cell_px, white_border=1)
    paste_tag(canvas, img, corners_dst, cell_px)
    return np.asarray(corners_dst, np.float64)
