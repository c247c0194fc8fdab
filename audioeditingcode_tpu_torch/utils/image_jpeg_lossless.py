"""Lossless JPEG (SOF3, T.81 Annex H) scans for ``image_io.decode_jpeg``, as
libjpeg-turbo 3.1's ``jdlhuff.c``, ``jddiffct.c`` and ``jdpred.c`` decode
them, numpy and the standard library only.

- Each sample's difference is Huffman-coded as a DC difference is (a
  category, then that many bits; category 16 means 32768 with no bits), in
  MCUs of one sample a component (a non-interleaved scan) or of h x v
  samples of each component (an interleaved scan).
- Undifferencing, per component and row, modulo 2^16: the first row of a
  scan or of a restart interval predicts its first sample by 2^(P - Pt - 1)
  and the rest from the left; each later row predicts its first sample from
  above and the rest by the scan's predictor (1: Ra, 2: Rb, 3: Rc, 4: Ra +
  Rb - Rc, 5: Ra + ((Rb - Rc) >> 1), 6: Rb + ((Ra - Rc) >> 1), 7: (Ra + Rb)
  >> 1), over the component's own width; samples in the MCU padding are
  decoded and dropped.
- A restart interval is a whole number of MCU rows (libjpeg fails
  otherwise); the output sample is the value shifted left by the point
  transform, kept to 8 bits.
- ``planes`` replicates subsampled components (libjpeg's upsampler is
  not fancy where a data unit is one sample). libjpeg-turbo takes three
  components as RGB in lossless mode, whatever their ids, and refuses to
  convert YCbCr (a JFIF marker, an Adobe transform 1) or YCCK, where PIL
  fails and ``image_io`` raises; four are CMYK, inverted by PIL.
- Samples of 8 bits only: PIL refuses other precisions.
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import image_jpeg_exact
from .image_jpeg_stream import Source, intervals


def _diffs(w16: List[int], tables: List[List[int]], count: int, p: int):
    """``count`` sample differences from bit ``p`` on, the i-th with table
    ``tables[i % n]`` (a code no entry starts: 17 bits, the difference 0),
    and the bit after them."""
    n = len(tables)
    out = [0] * count
    for i in range(count):
        e = tables[i % n][w16[p]]
        if not e:
            p += 17
            continue
        p += e >> 8
        s = e & 255
        if s == 16:
            v = 32768
        elif s:
            v = w16[p] >> (16 - s)
            p += s
            if v < 1 << (s - 1):
                v += 1 - (1 << s)
        else:
            v = 0
        out[i] = v
    return out, p


def _undifference(diff: np.ndarray, prev: np.ndarray, first: bool, predictor: int,
                  initial: int) -> np.ndarray:
    """One row of samples from its differences (int64) and the row above."""
    d = diff.astype(np.int64)
    if first:  # jpeg_undifference_first_row
        d = d.copy()
        d[0] += initial
        return np.cumsum(d) & 0xFFFF
    rb = prev.astype(np.int64)
    rc = np.concatenate([rb[:1], rb[:-1]])
    start = (d[0] + rb[0]) & 0xFFFF
    if predictor in (1, 4, 5):  # Ra enters with a weight of one: a running sum
        grad = rb[1:] - rc[1:]
        t = d[1:] + {1: 0, 4: grad, 5: grad >> 1}[predictor]
        return np.cumsum(np.concatenate([[start], t])) & 0xFFFF
    if predictor in (2, 3):
        return np.concatenate([[start], (d[1:] + (rb[1:] if predictor == 2 else rc[1:]))
                               & 0xFFFF])
    out = [start]
    ra = start
    dl, rbl, rcl = d.tolist(), rb.tolist(), rc.tolist()
    for x in range(1, len(dl)):
        if predictor == 6:
            ra = (dl[x] + rbl[x] + ((ra - rcl[x]) >> 1)) & 0xFFFF
        else:
            ra = (dl[x] + ((ra + rbl[x]) >> 1)) & 0xFFFF
        out.append(ra)
    return np.asarray(out, np.int64)


def decode_scan(frame: dict, src: Source, members, predictor: int, se: int, ah: int, pt: int,
                huff, restart: int, peek16, table, exact_bits) -> None:
    """Decode one lossless scan from ``src`` into ``frame["samples"]`` (each
    component's (height, width) int64 samples at its own size); ``members``
    (component, DC table, AC table) each, ``table(huff, 0, number, True)``
    a DC table's lookup, ``exact_bits(src, pad)`` an ``image_jpeg_exact.Bits``
    over the segment last read. Restart markers and data that runs out are read
    as ``image_jpeg_stream.intervals`` reads them, a row of MCUs at a time
    (``decode_mcus``): the row that runs out is decoded from zero bits, the
    rows after it up to the next restart marker get zero differences and
    restart the prediction (``CENTERJSAMPLE``)."""
    comps = frame["comps"]
    n = len(members)
    if not 1 <= predictor <= 7 or se != 0 or ah != 0 or pt >= frame["precision"]:
        raise ValueError(f"corrupt JPEG data: lossless scan with predictor {predictor}, Se {se}, "
                         f"Ah {ah}, Pt {pt}")
    tables = {ci: table(huff, 0, dct, True) for ci, dct, _ in members}
    width, height, hmax, vmax = frame["width"], frame["height"], frame["hmax"], frame["vmax"]
    if n == 1:
        ci = members[0][0]
        _, h, v, _ = comps[ci]
        mcux, mcuy = -(-width * h // hmax), -(-height * v // vmax)
        layout = [(ci, 0, 0, 1, 1)]
    else:
        mcux, mcuy = -(-width // hmax), -(-height // vmax)
        layout = [(ci, yy, xx, comps[ci][2], comps[ci][1]) for ci, _, _ in members
                  for yy in range(comps[ci][2]) for xx in range(comps[ci][1])]
    order = [tables[ci] for ci, _, _, _, _ in layout]
    per_mcu = len(layout)
    if restart and restart % mcux:
        raise ValueError(f"lossless JPEG restart interval {restart} is not a whole number of "
                         f"MCU rows of {mcux} (libjpeg fails on it)")
    rows_per_interval = restart // mcux if restart else mcuy
    grids = {ci: np.zeros((mcuy * vv, mcux * hh), np.int64) for ci, _, _, vv, hh in layout}
    decoded = np.zeros(mcuy, bool)

    def rows(first: int, count: int, data: bytes, pad: int = 4):
        w16, nbits, p = peek16(data, pad), 8 * len(data), 0
        r0 = first // mcux
        for r in range(count // mcux):
            if p > nbits:
                return r * mcux, True
            d, p = _diffs(w16, order, mcux * per_mcu, p)
            d = np.asarray(d, np.int64).reshape(mcux, per_mcu)
            for j, (ci, yy, xx, vv, hh) in enumerate(layout):
                grids[ci][(r0 + r) * vv + yy, xx::hh][:mcux] = d[:, j]
            decoded[r0 + r] = True
        return count, p > nbits

    def decode(first: int, count: int, data: bytes):
        if src.span and src.at_end:  # where the fills fall decides: byte for byte
            d = image_jpeg_exact.lossless(exact_bits(src, 5 * mcux * per_mcu), order,
                                          count // mcux, mcux * per_mcu)
            r0, done = first // mcux, len(d) // (mcux * per_mcu)
            for r in range(done):
                row = np.asarray(d[r * mcux * per_mcu:(r + 1) * mcux * per_mcu],
                                 np.int64).reshape(mcux, per_mcu)
                for j, (ci, yy, xx, vv, hh) in enumerate(layout):
                    grids[ci][(r0 + r) * vv + yy, xx::hh][:mcux] = row[:, j]
                decoded[r0 + r] = True
            return done * mcux, False
        try:
            return rows(first, count, data)
        except IndexError:  # the row that runs out: zero bits enough for any
            return rows(first, count, data, 5 * mcux * per_mcu + 4)

    intervals(src, restart, mcux * mcuy, decode)
    # the prediction restarts (start_pass) at the scan's first row, at each
    # restart marker and at each row left undecoded; libjpeg undifferences
    # an iMCU row (v sample rows) after decoding all its MCU rows, so a
    # restart anywhere in it restarts the prediction at its first row
    fresh = ~decoded
    fresh[::rows_per_interval] = True
    initial = 1 << (frame["precision"] - pt - 1)
    for ci in grids:
        _, h, v, _ = comps[ci]
        per_row = v if n > 1 else 1  # sample rows in an MCU row
        cw, chh = -(-width * h // hmax), -(-height * v // vmax)
        g = grids[ci]
        out = np.zeros((chh, cw), np.int64)
        prev = None
        for y in range(chh):
            first = y % v == 0 and fresh[y // per_row:(y + v - 1) // per_row + 1].any()
            prev = _undifference(g[y, :cw], prev, first, predictor, initial)
            out[y] = prev
        frame["samples"][ci] = (out << pt) & 255


def planes(frame: dict) -> List[np.ndarray]:
    """Each component's samples brought to the image's size by replication
    (libjpeg's upsampler is not fancy where a data unit is one sample)."""
    width, height, hmax, vmax = frame["width"], frame["height"], frame["hmax"], frame["vmax"]
    out = []
    for ci, (_, h, v, _) in enumerate(frame["comps"]):
        s = frame["samples"].get(ci)
        if s is None:
            raise ValueError("lossless JPEG component with no scan")
        if hmax % h or vmax % v:
            raise ValueError(f"JPEG sampling {h}x{v} of {hmax}x{vmax} is fractional")
        out.append(np.repeat(np.repeat(s, vmax // v, axis=0), hmax // h, axis=1)[:height, :width])
    return out
