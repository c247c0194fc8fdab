"""Block smoothing of a progressive JPEG whose scans leave bits of its first
AC coefficients unsent, as libjpeg-turbo 3.1's ``decompress_smooth_data``
(jdcoefct.c) runs it before the IDCT; numpy only.

libjpeg smooths when every component has its DC (some of its bits),
non-zero quantizers for the first ten coefficients, and some of the first
nine AC coefficients (zigzag 1-9) still lack bits (``smoothing_ok``). Each
block then estimates those of the nine that are zero and not fully known
from the DC values of the 5 x 5 blocks around it (columns past the
component's edge take the nearest column; rows as ``_rows`` picks them),
each estimate ``round(Q00 * num / (Qxy * 256))``,
clamped below 2^Al where Al bits are still missing. Where no AC bit at
all has arrived, a wider kernel estimates the nine and the DC too.
"""

from __future__ import annotations

from typing import List

import numpy as np

# zigzag index k (1-9) -> natural position of the coefficient
_NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
# the estimate of each AC (zigzag 1-5) from the 5 x 5 DCs (row-major, the
# block at the centre): with some AC data, and with none (change_dc)
_KERNELS = {
    1: ({(2, 0): -7, (2, 1): 50, (2, 3): -50, (2, 4): 7},
        {(0, 0): -1, (0, 1): -1, (0, 3): 1, (0, 4): 1, (1, 0): -3, (1, 1): 13, (1, 3): -13,
         (1, 4): 3, (2, 0): -3, (2, 1): 38, (2, 3): -38, (2, 4): 3, (3, 0): -3, (3, 1): 13,
         (3, 3): -13, (3, 4): 3, (4, 0): -1, (4, 1): -1, (4, 3): 1, (4, 4): 1}),
    2: ({(0, 2): -7, (1, 2): 50, (3, 2): -50, (4, 2): 7},
        {(0, 0): -1, (0, 1): -3, (0, 2): -3, (0, 3): -3, (0, 4): -1, (1, 0): -1, (1, 1): 13,
         (1, 2): 38, (1, 3): 13, (1, 4): -1, (3, 0): 1, (3, 1): -13, (3, 2): -38, (3, 3): -13,
         (3, 4): 1, (4, 0): 1, (4, 1): 3, (4, 2): 3, (4, 3): 3, (4, 4): 1}),
    3: ({(0, 2): -1, (1, 2): 13, (2, 2): -24, (3, 2): 13, (4, 2): -1},
        {(0, 2): 1, (1, 1): 2, (1, 2): 7, (1, 3): 2, (2, 1): -5, (2, 2): -14, (2, 3): -5,
         (3, 1): 2, (3, 2): 7, (3, 3): 2, (4, 2): 1}),
    4: ({(1, 4): 1, (3, 0): 1, (3, 1): -10, (3, 3): 10, (0, 1): -1, (3, 4): -1, (4, 1): 1,
         (4, 3): -1, (0, 3): 1, (1, 0): -1, (1, 1): 10, (1, 3): -10},
        {(0, 0): -1, (0, 4): 1, (1, 1): 9, (1, 3): -9, (3, 1): -9, (3, 3): 9, (4, 0): 1,
         (4, 4): -1}),
    5: ({(2, 0): -1, (2, 1): 13, (2, 2): -24, (2, 3): 13, (2, 4): -1},
        {(1, 1): 2, (1, 2): -5, (1, 3): 2, (2, 0): 1, (2, 1): 7, (2, 2): -14, (2, 3): 7,
         (2, 4): 1, (3, 1): 2, (3, 2): -5, (3, 3): 2}),
}
# zigzag 6-9, estimated only where no AC data has arrived
_KERNELS_NO_AC = {
    6: {(1, 1): 1, (1, 3): -1, (2, 1): 2, (2, 3): -2, (3, 1): 1, (3, 3): -1},
    7: {(1, 1): 1, (1, 2): -3, (1, 3): 1, (3, 1): -1, (3, 2): 3, (3, 3): -1},
    8: {(1, 1): 1, (1, 3): -1, (2, 1): -3, (2, 3): 3, (3, 1): 1, (3, 3): -1},
    9: {(1, 1): 1, (1, 2): 2, (1, 3): 1, (3, 1): -1, (3, 2): -2, (3, 3): -1},
}
_DC_KERNEL = ((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8),
              (-6, 6, 42, 6, -6), (-2, -6, -8, -6, -2))


def _columns(width: int) -> np.ndarray:
    """(width, 5): the block column of each of the five DC columns around
    each block, the nearest one past the edge."""
    c = np.arange(width)[:, None] + np.arange(-2, 3)[None, :]
    return np.clip(c, 0, width - 1)


def _rows(height: int, v: int, padded: int) -> np.ndarray:
    """(height, 5): the block row of each of the five DC rows around each of
    the component's ``height`` rows, as libjpeg picks them iMCU row by iMCU
    row (``v`` block rows each, ``padded`` rows in all): it counts a block's
    image row and the image's rows by the current iMCU row's block rows, so
    in the last one, which has fewer, rows above and below are cut sooner,
    and before it the row two below may be a padding row."""
    total = padded // v
    out = []
    for r in range(height):
        imcu, block_row = divmod(r, v)
        block_rows = v if imcu < total - 1 else (height % v or v)
        image_row = imcu * block_rows + block_row
        image_rows = block_rows * total
        prev = r - 1 if image_row > 0 else r
        prev_prev = r - 2 if image_row > 1 else prev
        nxt = r + 1 if image_row < image_rows - 1 else r
        next_next = r + 2 if image_row < image_rows - 2 else nxt
        out.append((prev_prev, prev, r, nxt, next_next))
    return np.asarray(out)


def _estimate(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """libjpeg's rounded division of ``num`` by ``q << 8``, clamped below
    2^Al where Al > 0."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        mag = np.minimum(mag, (1 << al) - 1)
    return np.where(num >= 0, mag, -mag)


def smooth(grid: np.ndarray, rows: int, cols: int, v: int, quant: np.ndarray,
           bits: List[int]) -> np.ndarray:
    """The smoothed (rows, cols, 64) natural-order quantized blocks of a
    component whose MCU grid of blocks (padding rows included; ``v`` block
    rows an iMCU row) is ``grid``, given its quantizers (natural order) and
    the bits each zigzag coefficient 0-9 lacks (-1: none sent)."""
    r, c = _rows(rows, v, grid.shape[0]), _columns(cols)
    blocks = grid[:rows, :cols]
    dc = grid[:, :cols, 0].astype(np.int64)
    # (rows, cols, 5, 5): the DC values around each block
    grid = dc[r[:, None, :, None], c[None, :, None, :]]
    change_dc = all(b == -1 for b in bits[1:10])
    q00 = int(quant[0])
    out = blocks.astype(np.int64).copy()
    ks = list(range(1, 10)) if change_dc else list(range(1, 6))
    for k in ks:
        al = bits[k]
        pos = _NATURAL[k]
        if al == 0:
            continue
        kernel = _KERNELS[k][1 if change_dc else 0] if k <= 5 else _KERNELS_NO_AC[k]
        num = q00 * sum(w * grid[:, :, i, j] for (i, j), w in kernel.items())
        est = _estimate(num, int(quant[pos]), al)
        out[:, :, pos] = np.where(out[:, :, pos] == 0, est, out[:, :, pos])
    if change_dc:
        num = q00 * sum(w * grid[:, :, i, j] for i, row in enumerate(_DC_KERNEL)
                        for j, w in enumerate(row))
        out[:, :, 0] = _estimate(num, q00, 0)
    return out
