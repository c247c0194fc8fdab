"""WebP decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

PIL decodes every WebP file through libwebp's animation decoder onto an
RGBA canvas; for a still image the frame is copied onto the canvas, not
blended, so the colour under a transparent pixel is kept and
``convert("RGB")`` drops the alpha without compositing. This module reads:

- the RIFF container: a simple ``VP8L`` (lossless) or ``VP8 `` (lossy)
  file, or an extended one (``VP8X``: its canvas size, which must be the
  frame's, and ICCP, EXIF, XMP and unknown chunks skipped);
- the lossless bitstream (the WebP lossless format, RFC 9649): the four
  transforms (predictor with its 14 modes, cross-colour, subtract-green,
  colour indexing with pixel bundling), the colour cache, meta prefix
  codes (the entropy image), simple and normal code-length codes, LZ77
  backward references with the 120-entry distance map; a stream that runs
  out of bits raises, as libwebp does;
- the ``ALPH`` chunk of a lossy image: raw or lossless-compressed alpha
  (the green channel of a header-less lossless stream), unfiltered
  (none, horizontal, vertical or gradient) as libwebp's ``filters.c``;
  ``read_webp_rgba`` returns it, ``decode_webp`` drops it;
- the lossy key frame through ``image_vp8.decode_vp8``, with libwebp's
  fancy upsampling and fixed-point YUV -> RGB.

- animated WebP (``ANIM``/``ANMF``): its first frame, as libwebp's
  ``WebPAnimDecoder`` that PIL reads every WebP with draws it: onto a
  zero-filled canvas of the VP8X size (the ANIM background colour is a
  hint the decoder ignores), at (2 x, 2 y) and its own size, neither
  blended nor disposed (the first frame is a key frame); the frame's
  ``VP8 `` (with or without ``ALPH``) or ``VP8L`` stream goes through the
  decoders above. A frame that does not fit the canvas raises, as libwebp
  fails on it.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from . import image_vp8

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# RFC 9649's distance map: code - 1 -> (dy << 4) | (8 - dx)
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c035759131d"
    "565a232d444c555b333d68026769121e666a222e545c434d656b323e78017779535d111f646c424e767a212f"
    "757b313f636d525e00747c414f1020626e30737d515f40727e616f50717f6070")
_NUM_LITERALS, _NUM_LENGTHS, _NUM_DISTANCES = 256, 24, 40
_BLACK = 0xFF000000


class _Bits:
    """A least-significant-bit-first reader over ``data``: ``win[i]`` holds
    the four bytes from byte i, so up to 25 bits peek from any position."""

    def __init__(self, data: bytes):
        b = np.frombuffer(data + b"\x00" * 4, np.uint8).astype(np.int64)
        self.win = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)).tolist()
        self.pos = 0
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if self.pos > self.end:
            raise ValueError("truncated WebP lossless data: the stream ends early")
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)


def _code(lengths: List[int]) -> Tuple[List[int], int]:
    """A canonical prefix code from its code lengths: (a table indexed by
    the next ``max length`` bits, least significant first -> (symbol << 4)
    | length, the max length). One used symbol reads no bit, as libwebp."""
    used = [(n, s) for s, n in enumerate(lengths) if n]
    if not used:
        raise ValueError("corrupt WebP lossless data: a prefix code with no symbol")
    if len(used) == 1:
        return [used[0][1] << 4], 0
    top = max(n for n, _ in used)
    if sum(1 << (top - n) for n, _ in used) != 1 << top:
        raise ValueError("corrupt WebP lossless data: an incomplete or oversubscribed prefix "
                         "code")
    table = np.zeros(1 << top, np.int64)
    code = 0
    for n in range(1, top + 1):
        for s in (s for m, s in used if m == n):
            rev = int(format(code, f"0{n}b")[::-1], 2)
            table[rev::1 << n] = (s << 4) | n
            code += 1
        code <<= 1
    return table.tolist(), top


def _read_code(br: _Bits, alphabet: int) -> Tuple[List[int], int]:
    """One prefix code of the bitstream (``ReadHuffmanCode``)."""
    lengths = [0] * alphabet
    if br.read(1):  # simple: one or two symbols of length 1
        count = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        symbols = [first] + ([br.read(8)] if count == 2 else [])
        for s in symbols:
            if s >= alphabet:
                raise ValueError("corrupt WebP lossless data: a symbol past the alphabet")
            lengths[s] = 1
        return _code(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    table, top = _code(cl)
    mask = (1 << top) - 1
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("corrupt WebP lossless data: more code lengths than symbols")
    else:
        max_symbol = alphabet
    s, prev = 0, 8
    while s < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        e = table[(br.win[br.pos >> 3] >> (br.pos & 7)) & mask]
        br.read(e & 15)
        n = e >> 4
        if n < 16:
            lengths[s] = n
            s += 1
            if n:
                prev = n
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
            repeat = br.read(extra) + offset
            if s + repeat > alphabet:
                raise ValueError("corrupt WebP lossless data: a code-length run past the "
                                 "alphabet")
            lengths[s:s + repeat] = [prev if n == 16 else 0] * repeat
            s += repeat
    return _code(lengths)


def _prefix_value(symbol: int, br: _Bits) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _decode_image(br: _Bits, xsize: int, ysize: int, level0: bool) -> List[int]:
    """An entropy-coded image (``DecodeImageStream`` after the transforms):
    xsize * ysize ARGB values, row by row."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"corrupt WebP lossless data: colour cache of {cache_bits} bits")
    meta, meta_bits, meta_w = None, 0, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = -(-xsize // (1 << meta_bits))
        image = _decode_image(br, meta_w, -(-ysize // (1 << meta_bits)), False)
        meta = [(p >> 8) & 0xFFFF for p in image]
    groups = []
    for _ in range(max(meta) + 1 if meta else 1):
        groups.append([_read_code(br, a) for a in (
            _NUM_LITERALS + _NUM_LENGTHS + (1 << cache_bits if cache_bits else 0),
            _NUM_LITERALS, _NUM_LITERALS, _NUM_LITERALS, _NUM_DISTANCES)])
    total = xsize * ysize
    out: List[int] = []
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0
    win, end = br.win, br.end
    pos = br.pos
    col = row = 0
    mask = (1 << meta_bits) - 1 if meta else -1
    group = groups[0]
    refetch = True
    append = out.append
    while len(out) < total:
        if meta is not None and (refetch or not col & mask):
            group = groups[meta[(row >> meta_bits) * meta_w + (col >> meta_bits)]]
        refetch = False
        (gt, gb), (rt, rb), (bt, bb), (at, ab), (dt, db) = group
        w = win[pos >> 3] >> (pos & 7)
        e = gt[w & ((1 << gb) - 1)]
        pos += e & 15
        code = e >> 4
        if code < _NUM_LITERALS:
            e = rt[(win[pos >> 3] >> (pos & 7)) & ((1 << rb) - 1)]
            pos += e & 15
            red = e >> 4
            e = bt[(win[pos >> 3] >> (pos & 7)) & ((1 << bb) - 1)]
            pos += e & 15
            blue = e >> 4
            e = at[(win[pos >> 3] >> (pos & 7)) & ((1 << ab) - 1)]
            pos += e & 15
            append(((e >> 4) << 24) | (red << 16) | (code << 8) | blue)
            col += 1
        elif code < _NUM_LITERALS + _NUM_LENGTHS:
            br.pos = pos
            length = _prefix_value(code - _NUM_LITERALS, br)
            e = dt[(win[br.pos >> 3] >> (br.pos & 7)) & ((1 << db) - 1)]
            br.pos += e & 15
            dcode = _prefix_value(e >> 4, br)
            pos = br.pos
            if dcode > 120:
                dist = dcode - 120
            else:
                p = _CODE_TO_PLANE[dcode - 1]
                dist = max(1, (p >> 4) * xsize + 8 - (p & 15))
            n = len(out)
            if dist > n or length > total - n:
                raise ValueError("corrupt WebP lossless data: a backward reference out of the "
                                 "image")
            if dist >= length:
                out.extend(out[n - dist:n - dist + length])
            else:
                seg = out[n - dist:]
                out.extend((seg * (length // dist + 1))[:length])
            col += length
            refetch = True
        else:
            if cache is None:
                raise ValueError("corrupt WebP lossless data: a colour cache code without a "
                                 "cache")
            while cached < len(out):
                v = out[cached]
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
                cached += 1
            append(cache[code - _NUM_LITERALS - _NUM_LENGTHS])
            col += 1
        while col >= xsize:
            col -= xsize
            row += 1
        if pos > end:
            raise ValueError("truncated WebP lossless data: the stream ends early")
    br.pos = pos
    return out


def _add(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(v: int):
    return v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255


def _pack(c) -> int:
    return (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]


def _predict(mode: int, left: int, top: int, tl: int, tr: int) -> int:
    """The 14 predictor modes of the lossless format (14 and 15 as 0)."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg(_avg(left, tr), top)
    if mode == 6:
        return _avg(left, tl)
    if mode == 7:
        return _avg(left, top)
    if mode == 8:
        return _avg(tl, top)
    if mode == 9:
        return _avg(top, tr)
    if mode == 10:
        return _avg(_avg(left, tl), _avg(top, tr))
    if mode == 11:  # libwebp's Select(T, L, TL)
        lc, tc, cc = _channels(left), _channels(top), _channels(tl)
        pa_minus_pb = sum(abs(lv - cv) - abs(tv - cv) for lv, tv, cv in zip(lc, tc, cc))
        return top if pa_minus_pb <= 0 else left
    if mode == 12:
        return _pack([min(255, max(0, lv + tv - cv)) for lv, tv, cv in
                      zip(_channels(left), _channels(top), _channels(tl))])
    if mode == 13:
        out = []
        for av, cv in zip(_channels(_avg(left, top)), _channels(tl)):
            d = av - cv
            out.append(min(255, max(0, av + ((d + (d < 0)) >> 1))))  # C's truncating d / 2
        return _pack(out)
    return _BLACK


def _unpredict(res: List[int], width: int, height: int, bits: int, modes: List[int]) -> List[int]:
    """The predictor transform undone, row by row."""
    out = list(res)
    bw = -(-width // (1 << bits))
    for x in range(width):
        out[x] = _add(res[x], _BLACK if x == 0 else out[x - 1])
    for y in range(1, height):
        base = y * width
        out[base] = _add(res[base], out[base - width])
        row_modes = modes[(y >> bits) * bw:(y >> bits) * bw + bw]
        for x in range(1, width):
            i = base + x
            mode = (row_modes[x >> bits] >> 8) & 15
            up = i - width
            out[i] = _add(res[i], _predict(mode, out[i - 1], out[up], out[up - 1], out[up + 1]))
    return out


def _uncross(px: np.ndarray, width: int, bits: int, coded: List[int]) -> np.ndarray:
    """The cross-colour transform undone (``VP8LTransformColorInverse``)."""
    h = px.shape[0] // width
    bw = -(-width // (1 << bits))
    codes = np.asarray(coded, np.int64).reshape(-1, bw)
    idx = codes[np.arange(h)[:, None] >> bits, np.arange(width)[None, :] >> bits].reshape(-1)

    def s8(v):
        return ((v & 255) ^ 128) - 128

    g2r, g2b, r2b = s8(idx), s8(idx >> 8), s8(idx >> 16)
    green = s8(px >> 8)
    red = ((px >> 16) + ((g2r * green) >> 5)) & 255
    blue = ((px & 255) + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 255
    return (px & 0xFF00FF00) | (red << 16) | blue


def _unindex(px: np.ndarray, width: int, height: int, bits: int, palette: List[int]
             ) -> np.ndarray:
    """The colour-indexing transform undone: each packed pixel's green byte
    holds 1 << bits indices, the first in its low bits; an index past the
    palette gives transparent black."""
    pal = np.zeros(256, np.int64)
    pal[:len(palette)] = palette
    packed = ((px >> 8) & 255).reshape(height, -1)
    if bits == 0:
        return pal[packed].reshape(-1)
    per = 1 << bits
    size = 8 >> bits
    x = np.arange(width)
    idx = (packed[:, x >> bits] >> ((x & (per - 1)) * size)) & ((1 << size) - 1)
    return pal[idx].reshape(-1)


def decode_vp8l_image(data: bytes, width: int, height: int, br: Optional[_Bits] = None
                      ) -> np.ndarray:
    """A lossless image stream (the transforms, then the main image) of
    ``width`` x ``height`` -> (H, W) ARGB as int64."""
    br = br or _Bits(data)
    xsize = width
    transforms = []
    while br.read(1):
        kind = br.read(2)
        if any(t[0] == kind for t in transforms):
            raise ValueError(f"corrupt WebP lossless data: transform {kind} twice")
        if kind in (0, 1):
            bits = br.read(3) + 2
            image = _decode_image(br, -(-xsize // (1 << bits)), -(-height // (1 << bits)), False)
            transforms.append((kind, xsize, bits, image))
        elif kind == 2:
            transforms.append((kind, xsize, 0, None))
        else:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            palette = _decode_image(br, n, 1, False)
            for i in range(1, n):
                palette[i] = _add(palette[i], palette[i - 1])
            transforms.append((kind, xsize, bits, palette))
            xsize = -(-xsize // (1 << bits))
    px = _decode_image(br, xsize, height, True)
    for kind, w, bits, image in reversed(transforms):
        if kind == 0:
            px = _unpredict(px if isinstance(px, list) else px.tolist(), w, height, bits, image)
        else:
            arr = np.asarray(px, np.int64)
            if kind == 1:
                arr = _uncross(arr, w, bits, image)
            elif kind == 2:
                g = (arr >> 8) & 255
                arr = (arr & 0xFF00FF00) | ((((arr >> 16) + g) & 255) << 16) | ((arr + g) & 255)
            else:
                arr = _unindex(arr, w, height, bits, image)
            px = arr
    return np.asarray(px, np.int64).reshape(height, width)


def _vp8l(chunk: bytes, path: str) -> Tuple[np.ndarray, int, int]:
    if len(chunk) < 5 or chunk[0] != 0x2F:
        raise ValueError(f"{path}: corrupt WebP lossless data: no 0x2f signature")
    br = _Bits(chunk)
    br.read(8)
    width, height = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha_is_used: a hint only
    if br.read(3) != 0:
        raise ValueError(f"{path}: WebP lossless version other than 0")
    return decode_vp8l_image(chunk, width, height, br), width, height


def _alpha(chunk: bytes, width: int, height: int, path: str) -> np.ndarray:
    """An ALPH chunk -> (H, W) uint8 alpha (``ALPHDecode``, ``filters.c``)."""
    if not chunk:
        raise ValueError(f"{path}: empty WebP ALPH chunk")
    method, filt = chunk[0] & 3, (chunk[0] >> 2) & 3
    if method == 0:
        if len(chunk) - 1 < width * height:
            raise ValueError(f"{path}: truncated WebP alpha data")
        a = np.frombuffer(chunk, np.uint8, width * height, 1).reshape(height, width)
    elif method == 1:
        a = ((decode_vp8l_image(chunk[1:], width, height) >> 8) & 255).astype(np.uint8)
    else:
        raise ValueError(f"{path}: WebP alpha compression method {method}")
    a = a.astype(np.int64)
    if filt == 0:
        return a.astype(np.uint8)
    out = np.zeros_like(a)
    out[0] = np.cumsum(a[0]) & 255  # the first row is left-predicted, from 0
    for y in range(1, height):
        if filt == 1:  # horizontal: the first pixel from the one above
            out[y] = (np.cumsum(a[y]) + out[y - 1, 0]) & 255
        elif filt == 2:  # vertical
            out[y] = (a[y] + out[y - 1]) & 255
        else:  # gradient: clip(left + top - top-left), sequential along the row
            top = out[y - 1].tolist()
            row = a[y].tolist()
            left = tl = top[0]
            vals = []
            for x in range(width):
                g = left + top[x] - tl
                left = (row[x] + (0 if g < 0 else 255 if g > 255 else g)) & 255
                tl = top[x]
                vals.append(left)
            out[y] = vals
    return out.astype(np.uint8)


def _riff_chunks(data: bytes, path: str, pos: int = 12, end=None):
    """The (tag, body) chunks from ``pos`` to ``end`` (the RIFF size's end)."""
    if end is None:
        end = min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (n,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + n > len(data):
            raise ValueError(f"{path}: truncated WebP data: the {tag.decode('latin-1')!r} chunk "
                             f"ends past the file")
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)


def read_webp_rgba(path: str) -> np.ndarray:
    """A WebP file as (H, W, 4) uint8 RGBA, the canvas libwebp's animation
    decoder gives PIL (alpha 255 where the file has none; an animation's
    first frame)."""
    with open(path, "rb") as f:
        return decode_webp_rgba(f.read(), path)


def decode_webp_rgba(data: bytes, path: str) -> np.ndarray:
    """``read_webp_rgba`` on the file's bytes (``path`` names it in errors)."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{path}: not a WebP (RIFF WEBP) file")
    if 8 + struct.unpack("<I", data[4:8])[0] > len(data):
        raise ValueError(f"{path}: truncated WebP data: the RIFF size is past the file")
    chunks = list(_riff_chunks(data, path))
    if not chunks:
        raise ValueError(f"{path}: WebP file without a chunk")
    canvas = None
    if chunks[0][0] == b"VP8X":
        head = chunks[0][1]
        if len(head) < 10:
            raise ValueError(f"{path}: corrupt WebP VP8X chunk")
        canvas = (int.from_bytes(head[4:7], "little") + 1, int.from_bytes(head[7:10], "little") + 1)
        if head[0] & 0x02 or any(t in (b"ANIM", b"ANMF") for t, _ in chunks):
            return _first_frame(chunks, canvas, path)
    rgba = _frame(chunks, canvas is not None, path)
    if canvas is not None and canvas != (rgba.shape[1], rgba.shape[0]):
        raise ValueError(f"{path}: WebP canvas {canvas} differs from its image "
                         f"{(rgba.shape[1], rgba.shape[0])}")
    return rgba


def _first_frame(chunks, canvas: Tuple[int, int], path: str) -> np.ndarray:
    """The canvas after an animated WebP's first ANMF frame (see the module
    docstring)."""
    if not any(t == b"ANIM" for t, _ in chunks):
        raise ValueError(f"{path}: animated WebP without an ANIM chunk")
    anmf = next((body for t, body in chunks if t == b"ANMF"), None)
    if anmf is None or len(anmf) < 16:
        raise ValueError(f"{path}: animated WebP without a frame")
    x, y = 2 * int.from_bytes(anmf[0:3], "little"), 2 * int.from_bytes(anmf[3:6], "little")
    fw, fh = int.from_bytes(anmf[6:9], "little") + 1, int.from_bytes(anmf[9:12], "little") + 1
    if x + fw > canvas[0] or y + fh > canvas[1]:
        raise ValueError(f"{path}: WebP frame of {fw} x {fh} at ({x}, {y}) runs past its canvas "
                         f"{canvas}")
    sub = list(_riff_chunks(anmf, path, 16, len(anmf)))
    frame = _frame(sub, True, path)
    if frame.shape[:2] != (fh, fw):
        raise ValueError(f"{path}: WebP frame of {frame.shape[1]} x {frame.shape[0]} where its "
                         f"ANMF header says {fw} x {fh}")
    out = np.zeros((canvas[1], canvas[0], 4), np.uint8)
    out[y:y + fh, x:x + fw] = frame
    return out


def _frame(chunks, extended: bool, path: str) -> np.ndarray:
    """The RGBA pixels of the first VP8 or VP8L stream among ``chunks``
    (the ALPH chunk's alpha where the file is extended)."""
    alph = next((body for t, body in chunks if t == b"ALPH"), None)
    image = next(((t, body) for t, body in chunks if t in (b"VP8 ", b"VP8L")), None)
    if image is None:
        raise ValueError(f"{path}: WebP file without a VP8 or VP8L chunk")
    if image[0] == b"VP8L":
        argb, width, height = _vp8l(image[1], path)
        rgba = np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255, argb >> 24],
                        axis=-1).astype(np.uint8)
    else:
        rgb = image_vp8.decode_vp8(image[1], path)
        height, width = rgb.shape[:2]
        a = (_alpha(alph, width, height, path) if alph is not None and extended
             else np.full((height, width), 255, np.uint8))
        rgba = np.concatenate([rgb, a[:, :, None]], axis=-1)
    return rgba


def decode_webp(data: bytes, path: str) -> np.ndarray:
    """A WebP file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    return np.ascontiguousarray(decode_webp_rgba(data, path)[:, :, :3])
