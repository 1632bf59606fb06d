"""AprilTag family codebooks as device arrays.

The reference selects a family by name and an error-correction budget
(``bits_corrected``) when building the C detector
(``/root/reference/crates/apriltags/src/lib.rs:227-261``; defaults
``tag36h11`` / 3 bits). Here a family is a fixed device-resident table:

- ``codes32[n, 4, 2]``: for each code and each of its 4 rotations, the
  (hi, lo) uint32 halves of the packed bit code. Codes are compared with a
  single XOR + popcount against the sampled bits, batched over all quads and
  all codes at once (one [Q, N*4] integer op instead of the
  reference's per-detection C codebook walk).

Bit packing convention is defined by ``tools/gen_families.py``: bit (r, c) of
the canonical upright rendering, row-major, MSB-first; bit = 1 means the cell
is white.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "_data")

DEFAULT_FAMILY = "tag36h11"  # crates/apriltags/src/lib.rs:45
DEFAULT_BITS_CORRECTED = 3  # crates/apriltags/src/lib.rs:230


class TagFamily(NamedTuple):
    name: str
    dim: int  # data grid is dim x dim
    nbits: int
    ncodes: int
    min_hamming: int
    # numpy (host) tables; moved to device by the pipeline when staged.
    codes: np.ndarray  # [n] uint64, canonical rotation
    codes_rot: np.ndarray  # [n, 4] uint64, all four rotations
    codes32: np.ndarray  # [n, 4, 2] uint32 (hi, lo)

    @property
    def total_dim(self) -> int:
        """Tag side length in cells including the 1-cell black border."""
        return self.dim + 2


def _rotate_code(code: int, dim: int) -> int:
    """Rotate the bit grid 90 degrees clockwise."""
    nbits = dim * dim
    bits = [(code >> (nbits - 1 - i)) & 1 for i in range(nbits)]
    grid = np.array(bits, dtype=np.uint8).reshape(dim, dim)
    rot = np.rot90(grid, -1)
    out = 0
    for b in rot.reshape(-1):
        out = (out << 1) | int(b)
    return out


@lru_cache(maxsize=None)
def load_family(name: str = DEFAULT_FAMILY) -> TagFamily:
    path = os.path.join(_DATA_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"family table {name!r} not found at {path}; run "
            "`python -m chalkydri_tpu.tools.gen_families` to generate it"
        )
    data = np.load(path)
    codes = data["codes"].astype(np.uint64)
    dim = int(data["dim"])
    nbits = dim * dim
    n = len(codes)

    codes_rot = np.zeros((n, 4), dtype=np.uint64)
    codes_rot[:, 0] = codes
    for r in range(1, 4):
        codes_rot[:, r] = [
            _rotate_code(int(c), dim) for c in codes_rot[:, r - 1]
        ]

    hi = (codes_rot >> np.uint64(32)).astype(np.uint32)
    lo = (codes_rot & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    codes32 = np.stack([hi, lo], axis=-1)

    return TagFamily(
        name=name,
        dim=dim,
        nbits=nbits,
        ncodes=n,
        min_hamming=int(data["min_hamming"]),
        codes=codes,
        codes_rot=codes_rot,
        codes32=codes32,
    )


def render_tag(family: TagFamily, tag_id: int, cell_px: int = 8,
               white_border: int = 1) -> np.ndarray:
    """Render a tag as a grayscale uint8 image (0/255), for tests and tools.

    Layout: ``white_border`` cells of white, 1 cell of black border, then the
    dim x dim data grid — the standard AprilTag print layout.
    """
    dim = family.dim
    code = int(family.codes[tag_id])
    nbits = family.nbits
    bits = np.array(
        [(code >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=np.uint8
    ).reshape(dim, dim)
    side = dim + 2 + 2 * white_border
    img = np.zeros((side, side), dtype=np.uint8)
    img[:] = 255  # white surround
    b = white_border
    img[b : side - b, b : side - b] = 0  # black border ring
    img[b + 1 : side - b - 1, b + 1 : side - b - 1] = bits * 255
    return np.kron(img, np.ones((cell_px, cell_px), dtype=np.uint8))
