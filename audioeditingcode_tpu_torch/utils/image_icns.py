"""ICNS (Mac OS icon) decoding for ``image_io.read_image``, numpy and the
standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``IcnsImagePlugin`` walks the big-endian blocks (a 4-byte type and a
size that counts its 8-byte header) up to the file's stated size; a block
size of 0 or less, or a header cut short, passes the file on, as does a
file without any of the types below. It picks the largest (width, height,
scale) of those present, compared as tuples, and reads every type of that
size in this order, the later overriding the earlier:

- PNG or JPEG 2000 entries (ic10, ic09, ic14, ic08, ic13, ic07, icp6,
  ic12, icp5, ic11, icp4): a PNG goes through ``image_io.decode_png``, a
  JPEG 2000 one (a JP2 file or a raw codestream, only the entry's own
  bytes) through ``image_jpeg2000.decode_jpeg2000``, each at its own size,
  which must be one PIL allows for the file's sizes; anything else raises,
  as PIL fails ("Unsupported icon subimage format");
- packed RGB (it32 after a 4-byte zero signature, ih32, il32, is32): a
  block of exactly 3 x size x size bytes is raw RGB; otherwise each of R,
  G and B in turn is run-length coded (a byte b >= 128: the next byte
  b - 125 times; else b + 1 literal bytes), and a channel that does not
  come out at size x size ends the load, as in PIL;
- masks (t8mk, h8mk, l8mk, s8mk): size x size alpha bytes, read where
  present (a mask cut short fails as in PIL) and dropped by
  ``convert("RGB")``.

A PNG entry wins over the packed one; a size with only a mask fails, as
in PIL.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size

_PNG = "png"
# (width, height, scale) -> the block types PIL reads for it, in order
_SIZES = {(512, 512, 2): [(b"ic10", _PNG)], (512, 512, 1): [(b"ic09", _PNG)],
          (256, 256, 2): [(b"ic14", _PNG)], (256, 256, 1): [(b"ic08", _PNG)],
          (128, 128, 2): [(b"ic13", _PNG)],
          (128, 128, 1): [(b"ic07", _PNG), (b"it32", "rgb32t"), (b"t8mk", "mask")],
          (64, 64, 1): [(b"icp6", _PNG)], (32, 32, 2): [(b"ic12", _PNG)],
          (48, 48, 1): [(b"ih32", "rgb32"), (b"h8mk", "mask")],
          (32, 32, 1): [(b"icp5", _PNG), (b"il32", "rgb32"), (b"l8mk", "mask")],
          (16, 16, 2): [(b"ic11", _PNG)],
          (16, 16, 1): [(b"icp4", _PNG), (b"is32", "rgb32"), (b"s8mk", "mask")]}
_JP2 = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def header(data: bytes, path: str) -> dict:
    """PIL's ``IcnsFile`` and ``IcnsImageFile._open``: {"blocks": {type:
    (start, length)}, "sizes": the (w, h, scale) present, "best"}."""
    sig, filesize = struct.unpack(">4sI", data[:8])
    if sig != b"icns":
        raise PassOn("not an icns file")
    blocks, i = {}, 8
    while i < filesize:
        sig, size = struct.unpack(">4sI", data[i:i + 8])
        if size <= 0:
            raise PassOn("invalid block header")
        i += 8
        blocks[sig] = (i, size - 8)
        i += size - 8
    sizes = [s for s, kinds in _SIZES.items() if any(k in blocks for k, _ in kinds)]
    if not sizes:
        raise PassOn("No 32bit icon resources found")
    best = max(sizes)
    check_size(best[0] * best[2], best[1] * best[2], path)
    return {"blocks": blocks, "sizes": sizes, "best": best}


def _rgb32(data: bytes, start: int, length: int, side: int, path: str) -> np.ndarray:
    """PIL's ``read_32``: (side, side, 3) uint8."""
    n = side * side
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError(f"{path}: truncated ICNS entry (PIL fails on it: not enough image "
                             f"data)")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3).copy()
    out = np.zeros((3, n), np.uint8)
    pos, end = start, len(data)
    for band in range(3):
        got, left = bytearray(), n
        while left > 0 and pos < end:
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                got += data[pos:pos + 1] * count
                pos += 1
            else:
                count = b + 1
                got += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"{path}: ICNS channel with {left} bytes left to fill (PIL fails on "
                             f"it: error reading channel)")
        if len(got) < n:
            raise ValueError(f"{path}: ICNS channel cut short by the file's end (PIL fails on "
                             f"it: not enough image data)")
        out[band] = np.frombuffer(bytes(got[:n]), np.uint8)
    return out.T.reshape(side, side, 3)


def _png_or_jp2(data: bytes, start: int, length: int, sizes, path: str) -> np.ndarray:
    """PIL's ``read_png_or_jpeg2000`` and the size its ``load`` then sets."""
    from .image_io import _SIGNATURE, decode_png
    from .image_jpeg2000 import JP2_SIGNATURE, decode_jpeg2000

    sig = data[start:start + 12]
    if sig.startswith(_SIGNATURE):
        rgb, kind = decode_png(data[start:], path), "PNG"
    elif sig.startswith(_JP2) or sig == JP2_SIGNATURE:
        rgb, kind = decode_jpeg2000(data[start:start + length], path), "JPEG 2000"
    else:
        raise ValueError(f"{path}: unsupported ICNS subimage format (PIL fails on it)")
    h, w = rgb.shape[:2]
    check_size(w, h, path)
    if not any(s[0] * s[2] // w == s[1] * s[2] / h for s in sizes):
        raise ValueError(f"{path}: ICNS {kind} entry of {w} x {h}, not one of the allowed sizes "
                         f"of this image (PIL fails on it)")
    return rgb


def decode_icns(data: bytes, path: str) -> np.ndarray:
    """An ICNS file's bytes as (H, W, 3) uint8 RGB (see the module
    docstring)."""
    try:
        head = header(data, path)
    except (PassOn, struct.error) as e:
        raise ValueError(f"{path}: not an ICNS file PIL opens ({e})") from None
    blocks, best = head["blocks"], head["best"]
    side = best[0] * best[2]
    channels = {}
    for kind, reader in _SIZES[best]:
        if kind not in blocks:
            continue
        start, length = blocks[kind]
        if reader == _PNG:
            channels["RGBA"] = _png_or_jp2(data, start, length, head["sizes"], path)
        elif reader == "mask":
            if len(data) < start + side * side:
                raise ValueError(f"{path}: ICNS mask cut short (PIL fails on it)")
            channels["A"] = True
        else:
            if reader == "rgb32t":
                if data[start:start + 4] != bytes(4):
                    raise ValueError(f"{path}: it32 entry without its zero signature (PIL fails "
                                     f"on it)")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb32(data, start, length, side, path)
    if "RGBA" in channels:
        return channels["RGBA"]
    if "RGB" not in channels:
        raise ValueError(f"{path}: ICNS size {best} with only a mask (PIL fails on it)")
    return channels["RGB"]
