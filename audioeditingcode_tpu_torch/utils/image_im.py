"""IM (IFUNC / LabEye) decoding for ``image_io.read_image``, numpy and the
standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

IM has no accept test: PIL's ``ImImagePlugin`` is the first opener without
one, tried on every file that reaches it, and ``header`` copies its text
header rules: a line feed among the first 100 bytes, lines of at most 100
bytes (a ``\\r`` before a line skipped, ``\\r\\n`` or ``\\n`` cut off) each
``key: value`` by PIL's regular expression, until a NUL, a ``\\x1a`` or the
end; at least one of PIL's nine tags; the data after the next ``\\x1a``.
A line that does not match passes the file on to the next opener. "Image
size (x*y)", "Scale (x,y)" and "File size (no of images)" are numbers (a
value that is not one makes PIL fail); "Image type" is looked up in PIL's
table of types and raw modes (any other type is kept as the mode, which
PIL opens and then fails to load).

A "Lut" field puts 768 bytes of palette (256 reds, greens, blues) before
the data. A greyscale palette leaves the mode as it is (PIL keeps a
non-linear one as a ``lut`` attribute it never applies); another one
turns ``L`` into ``P`` and ``LA`` into ``PA`` with that palette, and is
ignored by the other modes.

The rows are stored bottom to top (PIL's raw tile with orientation -1) and
this module reads the first frame in each raw mode of PIL's table: ``1``;
``L``; ``P`` (``B2``/``B4`` packed 2- and 4-bit indices; PIL's palette
of zeros, all black, where no Lut gives one); line-interleaved planes
(``RGB;L``, ``RGBA;L``, ``RGBX;L``, ``CMYK;L``, ``YCbCr;L``, ``LA;L``,
``PA;L``: each row holds the row of each band in turn); interleaved
``RGB``; whole planes ``RGB;T``/``RYB;T`` (green, red, blue); 32-bit
signed ``I``; 8, 16 and 32-bit ``F`` from unsigned, signed and float
samples; ``F`` of other widths through PIL's ``bit`` decoder (``_bits``);
``I;16`` little- and big-endian. Then
``convert("RGB")`` as PIL does it: ``1`` to 0 or 255, ``I`` and ``I;16``
clamped to 0..255, ``F`` truncated (NaN and below 0 to 0, 255 and above
to 255), ``CMYK`` by ``image_io.cmyk_to_rgb`` and ``YCbCr`` by PIL's
fixed-point ``ImagingConvertYCbCr2RGB``.

What this module refuses, each where PIL fails: types outside PIL's table
(PIL opens them and fails to load them), ``RLB``/``RYB`` (PIL has no
unpacker for them), ``PA`` without a colour Lut, and data shorter than the
image (PIL raises "image file is truncated").
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from .image_identify import PassOn, check_size
from .image_io import band_to_rgb, cmyk_to_rgb

OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

MODE, SIZE, LUT = "Image type", "Image size (x*y)", "Lut"
_NUMBERS = ("File size (no of images)", "Scale (x,y)", SIZE)
_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", LUT,
         "Name", "Scale (x,y)", SIZE, MODE)
_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# raw mode -> (numpy sample type, bytes a sample) for one-band numeric data
_NUMERIC = {"I;32": "<i4", "I;32S": "<i4", "F;8": "u1", "F;8S": "i1", "F;16": "<u2",
            "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4", "I;16": "<u2", "I;16L": "<u2",
            "I;16B": ">u2"}
_PLANES = {"RGB;L": 3, "RGBA;L": 4, "RGBX;L": 4, "CMYK;L": 4, "YCbCr;L": 3, "LA;L": 2,
           "PA;L": 2}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            raise ValueError(f"IM header value {s!r} is not a number (PIL fails on it)") from None


def _fields(data: bytes, path: str) -> Tuple[dict, str, int]:
    """PIL's header loop: (fields, raw mode, position after the ``\\x1a``)."""
    if b"\n" not in data[:100]:
        raise PassOn("not an IM file")
    info = {MODE: "L", SIZE: (512, 512), "File size (no of images)": 1}
    rawmode, n, pos, end_of_data = "L", 0, 0, len(data)
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        nl = data.find(b"\n", pos)
        nl = end_of_data if nl < 0 else nl + 1
        s += data[pos:nl]
        pos = nl
        if len(s) > 100:
            raise PassOn("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _LINE.match(s)
        if not m:
            raise PassOn("syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in _NUMBERS:
            v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k == "Comment":
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        n += k in _TAGS
    if not n:
        raise PassOn("not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += 1
    if not s:
        raise PassOn("IM file truncated")
    return info, rawmode, pos


def _lut(info: dict, mode: str, rawmode: str, data: bytes, pos: int):
    """PIL's Lut rules: (mode, raw mode, palette or None, data offset)."""
    if LUT not in info:
        return mode, rawmode, None, pos
    palette = data[pos:pos + 768]
    greyscale = True
    for i in range(256):  # PIL's loop, IndexError (a short palette) included
        if not palette[i] == palette[i + 256] == palette[i + 512]:
            greyscale = False
    pal = None
    if mode in ("L", "LA", "P", "PA") and not greyscale:
        if mode in ("L", "P"):
            mode = rawmode = "P"
        else:
            mode, rawmode = "PA", "PA;L"
        pal = np.frombuffer(palette, np.uint8).reshape(3, 256).T
    return mode, rawmode, pal, pos + 768


def header(data: bytes, path: str) -> dict:
    """PIL's ``ImImageFile._open``: the mode, raw mode, size, palette and
    data offset, or ``PassOn`` where PIL passes the file on."""
    info, rawmode, pos = _fields(data, path)
    try:
        width, height = info[SIZE][0], info[SIZE][1]
        mode = info[MODE]
        mode, rawmode, pal, pos = _lut(info, mode, rawmode, data, pos)
        if not mode or width <= 0 or height <= 0:
            raise PassOn("no mode, or a size of 0")
    except (IndexError, TypeError) as e:
        raise PassOn(f"IM header: {e}") from None
    if isinstance(width, int) and isinstance(height, int):
        check_size(width, height, path)
    return {"mode": mode, "rawmode": rawmode, "size": (width, height), "palette": pal,
            "offset": pos}


def _table(coef: float) -> np.ndarray:
    """One of ``ConvertYCbCr.c``'s tables: (int)(coef * 64 * (i - 128) + 0.5)."""
    return np.trunc(coef * 64 * (np.arange(256) - 128) + 0.5).astype(np.int64)


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """PIL's ``ImagingConvertYCbCr2RGB``: y plus table values shifted down
    6 bits (arithmetic), clipped."""
    y, cb, cr = (ycc[..., i].astype(np.int64) for i in range(3))
    r = y + (_table(1.402)[cr] >> 6)
    g = y + ((_table(-0.34414)[cb] + _table(-0.71414)[cr]) >> 6)
    b = y + (_table(1.772)[cb] >> 6)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _bits(data: bytes, pos: int, w: int, h: int, bits: int, path: str) -> np.ndarray:
    """PIL's ``bit`` decoder with the IM plugin's arguments (fill 3, pad 8,
    unsigned): the bits of each byte from the least significant, ``bits``
    to a sample; at each row's end the count of buffered bits goes to 0
    but the bits themselves stay, and the next byte is ORed over them;
    where more than 32 bits are buffered, the buffer restarts from the
    last byte's unread bits. Rows are (h, w) bottom to top as stored."""
    mask = (1 << bits) - 1
    out = np.zeros((h, w), np.float32)
    buf = count = x = y = 0
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError(f"{path}: truncated IM data: {h} rows of {bits}-bit samples do not "
                             f"fit in the file (PIL: image file is truncated)")
        byte = data[pos]
        pos += 1
        buf |= byte << count
        count += 8
        while count >= bits:
            out[y, x] = buf & mask
            if count > 32:
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            x += 1
            if x >= w:
                y += 1
                if y >= h:
                    return out
                x = count = 0


def read_im_rgb(path: str) -> np.ndarray:
    """An IM file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = header(data, path)
    except PassOn as e:
        raise ValueError(f"{path}: not an IM file PIL opens ({e})") from None
    mode, rawmode, (w, h), pos = head["mode"], head["rawmode"], head["size"], head["offset"]
    if not isinstance(w, int) or not isinstance(h, int):
        raise ValueError(f"{path}: IM image size {w} x {h} is not whole (PIL fails on it)")
    if mode not in ("1", "L", "P", "LA", "PA", "RGB", "RGBA", "CMYK", "YCbCr", "I", "F", "I;16",
                    "I;16L", "I;16B"):
        raise ValueError(f"{path}: IM image type {mode!r} (PIL opens it and fails to load it)")
    if mode == "LA" and rawmode == "PA;L":
        raise ValueError(f"{path}: IM PA image without a colour Lut (PIL fails on it: no LA "
                         f"unpacker for PA;L)")

    def take(n: int) -> bytes:
        if len(data) - pos < n:
            raise ValueError(f"{path}: truncated IM data: {n} bytes of pixels do not fit in the "
                             f"file (PIL: image file is truncated)")
        return data[pos:pos + n]

    if rawmode == "1":
        stride = (w + 7) // 8
        rows = np.frombuffer(take(stride * h), np.uint8).reshape(h, stride)
        v = np.unpackbits(rows, axis=1)[:, :w].astype(np.uint8) * 255
    elif rawmode in ("P;2", "P;4"):
        bits = int(rawmode[2])
        stride = (w * bits + 7) // 8
        rows = np.frombuffer(take(stride * h), np.uint8).reshape(h, stride)
        v = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits) @ (
            1 << np.arange(bits - 1, -1, -1))
    elif rawmode in ("L", "P"):
        v = np.frombuffer(take(w * h), np.uint8).reshape(h, w)
    elif rawmode in _PLANES:
        c = _PLANES[rawmode]
        v = np.frombuffer(take(c * w * h), np.uint8).reshape(h, c, w).transpose(0, 2, 1)
    elif rawmode == "RGB":
        v = np.frombuffer(take(3 * w * h), np.uint8).reshape(h, w, 3)
    elif rawmode in ("RGB;T", "RYB;T"):
        planes = np.frombuffer(take(3 * w * h), np.uint8).reshape(3, h, w)
        v = np.stack([planes[1], planes[0], planes[2]], -1)
    elif rawmode[2:].isdigit() and rawmode.startswith("F;") and rawmode not in _NUMERIC:
        v = _bits(data, pos, w, h, int(rawmode[2:]), path)
    elif rawmode in _NUMERIC:
        dt = np.dtype(_NUMERIC[rawmode])
        v = np.frombuffer(take(dt.itemsize * w * h), dt).reshape(h, w)
    else:
        raise ValueError(f"{path}: IM raw mode {rawmode!r} (PIL fails on it: it has no unpacker "
                         f"for it)")
    v = v[::-1]  # rows bottom to top
    if mode == "1" or mode == "L" or mode == "LA":
        grey = v if v.ndim == 2 else v[:, :, 0]
        return np.repeat(np.asarray(grey, np.uint8)[:, :, None], 3, axis=2)
    if mode in ("P", "PA"):
        idx = v if v.ndim == 2 else v[:, :, 0]
        pal = head["palette"]
        if pal is None:  # PIL's palette of zeros
            pal = np.zeros((256, 3), np.uint8)
        return np.ascontiguousarray(pal[idx])
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(v[:, :, :3])
    if mode == "CMYK":
        return cmyk_to_rgb(*np.moveaxis(v.astype(np.int64), -1, 0))
    if mode == "YCbCr":
        return _ycbcr_to_rgb(v)
    return band_to_rgb(v.astype(np.float32) if mode == "F" else v)
