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


def _diffs(w16: List[int], tables: List[List[int]], count: int) -> List[int]:
    """``count`` sample differences, the i-th with table ``tables[i % n]``."""
    n = len(tables)
    out = [0] * count
    p = 0
    for i in range(count):
        e = tables[i % n][w16[p]]
        if not e:
            raise ValueError("corrupt JPEG data: no Huffman code for a lossless difference")
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
    return out


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


def decode_scan(frame: dict, header: bytes, segments: List[bytes], huff, restart: int,
                peek16) -> None:
    """Decode one lossless scan into ``frame["samples"]`` (each component's
    (height, width) int64 samples at its own size)."""
    comps = frame["comps"]
    ids = [c[0] for c in comps]
    n = header[0]
    predictor, se = header[1 + 2 * n], header[2 + 2 * n]
    ah, pt = header[3 + 2 * n] >> 4, header[3 + 2 * n] & 15
    if not 1 <= predictor <= 7 or se != 0 or ah != 0 or pt >= frame["precision"]:
        raise ValueError(f"corrupt JPEG data: lossless scan with predictor {predictor}, Se {se}, "
                         f"Ah {ah}, Pt {pt}")
    members = []
    for i in range(n):
        ci = ids.index(header[1 + 2 * i])
        table = huff.get((0, header[2 + 2 * i] >> 4))
        if table is None:
            raise ValueError("JPEG scan uses a Huffman table it does not define")
        members.append((ci, table))
    width, height, hmax, vmax = frame["width"], frame["height"], frame["hmax"], frame["vmax"]
    if n == 1:
        ci = members[0][0]
        _, h, v, _ = comps[ci]
        mcux, mcuy = -(-width * h // hmax), -(-height * v // vmax)
        layout = [(ci, 0, 0, 1, 1)]
    else:
        mcux, mcuy = -(-width // hmax), -(-height // vmax)
        layout = [(ci, yy, xx, comps[ci][2], comps[ci][1]) for ci, _ in members
                  for yy in range(comps[ci][2]) for xx in range(comps[ci][1])]
    tables = [dict(members)[ci] for ci, _, _, _, _ in layout]
    per_mcu = len(layout)
    if restart and restart % mcux:
        raise ValueError(f"lossless JPEG restart interval {restart} is not a whole number of "
                         f"MCU rows of {mcux} (libjpeg fails on it)")
    rows_per_interval = restart // mcux if restart else mcuy
    grids = {ci: np.zeros((mcuy * vv, mcux * hh), np.int64) for ci, _, _, vv, hh in layout}
    for k, seg in enumerate(segments):
        r0 = k * rows_per_interval
        if r0 >= mcuy:
            break
        nrows = min(rows_per_interval, mcuy - r0)
        try:
            d = _diffs(peek16(seg), tables, nrows * mcux * per_mcu)
        except IndexError:
            raise ValueError("truncated JPEG data: the scan ends early") from None
        d = np.asarray(d, np.int64).reshape(nrows, mcux, per_mcu)
        for j, (ci, yy, xx, vv, hh) in enumerate(layout):
            grids[ci][(r0 * vv + yy)::vv, xx::hh][:nrows, :mcux] = d[:, :, j]
    if len(segments) * rows_per_interval < mcuy:
        raise ValueError("truncated JPEG data: the scan ends before its last restart interval")
    initial = 1 << (frame["precision"] - pt - 1)
    for ci in grids:
        _, h, v, _ = comps[ci]
        cw, chh = -(-width * h // hmax), -(-height * v // vmax)
        g = grids[ci]
        rows_per_restart = rows_per_interval * (v if n > 1 else 1)
        out = np.zeros((chh, cw), np.int64)
        prev = None
        for y in range(chh):
            prev = _undifference(g[y, :cw], prev, y % rows_per_restart == 0, predictor, initial)
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
