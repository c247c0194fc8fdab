"""BLP (Blizzard mipmap) decoding for ``image_io.read_image``, numpy and the
standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``BlpImagePlugin`` reads the header (BLP1: compression, an alpha
flag, the size, an encoding; BLP2: compression, encoding, alpha depth and
alpha encoding as signed bytes, the size), opens RGBA where the alpha is
not 0 and RGB otherwise, then its Python decoders read 16 mipmap offsets
and 16 lengths and decode the first mipmap:

- BLP1, compression 0 (JPEG): a JPEG header of the size the next word
  gives, then the first mipmap's bytes appended to it, decoded as a JPEG
  file (``image_io.decode_jpeg``; four components are taken as CMYK
  whatever their Adobe transform, as PIL sets the stream's colour space to
  CMYK), converted to RGB, and those bytes
  then read as **BGR** rows of the BLP's width.
- BLP1, compression 1, encoding 4 or 5: a 256-entry BGRA palette right
  after the offsets, then the first mipmap's length in indices read from
  there (not from its offset).
- BLP2, compression 1: the palette, then from the first mipmap's offset
  either palette indices (encoding 1) or DXT1, DXT3 or DXT5 blocks
  (encoding 2, alpha encoding 0, 1 or 7) through PIL's Python DXT
  decoders (``image_bcn.decode_blp_dxt``, which do not replicate the top
  bits of 5-6-5 colours as its C decoder does).

The decoders hand PIL a byte string that it reads as rows of the image's
width in the image's mode: DXT output of 4 bytes a pixel (3 for DXT1
without alpha) in rows of whole blocks, or palette colours of the mode's
size, so a width that is not a multiple of 4, or DXT3/5 into an RGB
image, shears the picture as it does in PIL. Fewer bytes than the image
needs raise ("not enough image data"), as does data that ends before the
decoders' reads ("Truncated File Read"); other compressions and encodings
raise, as PIL fails on them.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str) -> dict:
    """PIL's ``BlpImageFile._open``: {"magic", "size", "alpha",
    "compression", "encoding", "alpha_encoding"}."""
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise PassOn("not a BLP file")
    (compression,) = struct.unpack("<i", data[4:8])
    if magic == b"BLP1":
        (alpha,) = struct.unpack("<I", data[8:12])
        width, height, encoding = struct.unpack("<IIi", data[12:24])
        alpha_encoding = 0
    else:
        encoding, alpha, alpha_encoding = struct.unpack("<bbb", data[8:11])
        width, height = struct.unpack("<II", data[12:20])
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"magic": magic, "size": (width, height), "alpha": alpha != 0,
            "compression": compression, "encoding": encoding, "alpha_encoding": alpha_encoding}


def _read(data: bytes, pos: int, n: int, path: str) -> bytes:
    """``ImageFile._safe_read``: n bytes or a failure."""
    if n <= 0:
        return b""
    if pos + n > len(data):
        raise ValueError(f"{path}: truncated BLP data: {n} bytes at {pos} run past the file "
                         f"(PIL fails on it: Truncated File Read)")
    return data[pos:pos + n]


def _as_raw(stream: np.ndarray, width: int, height: int, bands: int, path: str) -> np.ndarray:
    """PIL's ``set_as_raw``: a byte stream read as rows of ``width`` pixels
    of ``bands`` bytes; the first three bands as RGB."""
    need = width * height * bands
    if stream.size < need:
        raise ValueError(f"{path}: BLP data of {stream.size} bytes for {width} x {height} "
                         f"pixels of {bands} bytes (PIL fails on it: not enough image data)")
    px = stream.reshape(-1)[:need].reshape(height, width, bands)
    return np.ascontiguousarray(px[:, :, :3])


def _palette(data: bytes, pos: int, path: str) -> np.ndarray:
    """256 BGRA entries -> (256, 4) RGBA."""
    bgra = np.frombuffer(_read(data, pos, 1024, path), np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]]


def decode_blp(data: bytes, path: str) -> np.ndarray:
    """A BLP file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    from .image_bcn import decode_blp_dxt

    try:
        head = header(data, path)
    except (PassOn, struct.error) as e:
        raise ValueError(f"{path}: not a BLP file PIL opens ({e})") from None
    (width, height), alpha = head["size"], head["alpha"]
    bands = 4 if alpha else 3
    compression, encoding = head["compression"], head["encoding"]
    pos = 28 if head["magic"] == b"BLP1" else 20
    offsets = struct.unpack("<16I", _read(data, pos, 64, path))
    lengths = struct.unpack("<16I", _read(data, pos + 64, 64, path))
    pos += 128
    if head["magic"] == b"BLP1":
        if compression == 0:
            return _jpeg(data, pos, offsets[0], lengths[0], width, height, bands, path)
        if compression != 1 or encoding not in (4, 5):
            raise ValueError(f"{path}: BLP1 compression {compression}, encoding {encoding} (PIL "
                             f"fails on it: unsupported BLP encoding)")
        pal = _palette(data, pos, path)
        idx = np.frombuffer(_read(data, pos + 1024, lengths[0], path), np.uint8)
        return _as_raw(pal[idx, :bands], width, height, bands, path)
    pal = _palette(data, pos, path)
    if compression != 1 or encoding not in (1, 2):
        raise ValueError(f"{path}: BLP2 compression {compression}, encoding {encoding} (PIL fails "
                         f"on it: unknown BLP compression or encoding)")
    if encoding == 1:
        idx = np.frombuffer(_read(data, offsets[0], lengths[0], path), np.uint8)
        return _as_raw(pal[idx, :bands], width, height, bands, path)
    aenc = head["alpha_encoding"]
    if aenc not in (0, 1, 7):
        raise ValueError(f"{path}: BLP2 alpha encoding {aenc} (PIL fails on it: unsupported "
                         f"alpha encoding)")
    bw, bh = (width + 3) // 4, (height + 3) // 4
    size = bw * bh * (8 if aenc == 0 else 16)
    rgba = decode_blp_dxt(_read(data, offsets[0], size, path), width, height, aenc)
    out_bands = 4 if aenc or alpha else 3  # DXT1 gives RGB triples without alpha
    return _as_raw(rgba[:, :, :out_bands], width, height, bands, path)


def _jpeg(data: bytes, pos: int, offset: int, length: int, width: int, height: int,
          bands: int, path: str) -> np.ndarray:
    from .image_io import _JPEG_SIGNATURE, decode_jpeg

    (size,) = struct.unpack("<I", _read(data, pos, 4, path))
    jpeg_header = _read(data, pos + 4, size, path)
    pos += 4 + size
    pos += len(_read(data, pos, offset - pos, path))  # the bytes up to the mipmap, skipped
    stream = jpeg_header + _read(data, pos, length, path)
    if not stream.startswith(_JPEG_SIGNATURE):
        raise ValueError(f"{path}: BLP1 JPEG mipmap that is not a JPEG stream (PIL fails on it)")
    rgb = decode_jpeg(stream, path, cmyk=True)
    check_size(rgb.shape[1], rgb.shape[0], path)
    bgr = _as_raw(rgb, width, height, 3, path)[:, :, ::-1]
    return np.ascontiguousarray(bgr)
