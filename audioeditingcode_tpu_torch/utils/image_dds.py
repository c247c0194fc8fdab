"""DDS (DirectDraw Surface) decoding for ``image_io.read_image``, numpy and
the standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``DdsImagePlugin`` reads the 124-byte header (another size, or a
header cut short, ends ``Image.open``) and takes the pixel format from its
flags, in this order:

- ``DDPF_RGB``: RGB, or RGBA with ``DDPF_ALPHAPIXELS``, through PIL's
  Python ``dds_rgb`` decoder: pixels of bitcount // 8 bytes, little
  endian, from byte 128; each channel ``int((v & mask) >> shift) / (mask
  >> shift) * 255)`` in double precision, 0 for a zero mask. The decoder
  reads past the file's end without failing: missing bytes count as 0.
- ``DDPF_LUMINANCE``: L at 8 bits, LA at 16 with ``DDPF_ALPHAPIXELS``,
  raw from byte 128; another bitcount ends ``Image.open``.
- ``DDPF_PALETTEINDEXED8``: P with a 256-entry RGBA palette at byte 128,
  the indices raw after it.
- ``DDPF_FOURCC``: DXT1/3/5, ATI1 and BC4U (BC4), ATI2 and BC5U (BC5),
  BC5S, through PIL's C ``bcn`` decoder (``image_bcn.decode``) from byte
  128; DX10 reads a 20-byte header whose DXGI format picks BC1-BC7
  (TYPELESS, UNORM, UNORM_SRGB), BC5 SNORM, BC6H UF16 and SF16, or raw
  R8G8B8A8 (TYPELESS, UNORM, UNORM_SRGB), from byte 148; the sRGB tags
  only set PIL's gamma, not the pixels. Another FourCC ("Unimplemented
  pixel format") or DXGI format ("Unimplemented DXGI format") ends
  ``Image.open``, as do pixel-format flags with none of these bits.

The first surface is read (mipmaps, cube faces and volume slices after it
are ignored). A width or height of 0 passes the file on; raw or block data
that ends early raises, as PIL fails ("image file is truncated").
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size

_RGB, _ALPHAPIXELS, _LUMINANCE, _PAL8, _FOURCC = 0x40, 0x1, 0x20000, 0x20, 0x4
# FourCC -> (bcn n, PIL's pixel format)
_FOURCCS = {b"DXT1": (1, "DXT1"), b"DXT3": (2, "DXT3"), b"DXT5": (3, "DXT5"),
            b"BC4U": (4, "BC4"), b"ATI1": (4, "BC4"), b"BC5S": (5, "BC5S"),
            b"BC5U": (5, "BC5"), b"ATI2": (5, "BC5")}
# DXGI format -> (bcn n, PIL's pixel format); n 0 is raw RGBA
_DXGI = {70: (1, "BC1"), 71: (1, "BC1"), 73: (2, "BC2"), 74: (2, "BC2"), 76: (3, "BC3"),
         77: (3, "BC3"), 79: (4, "BC4"), 80: (4, "BC4"), 82: (5, "BC5"), 83: (5, "BC5"),
         84: (5, "BC5S"), 95: (6, "BC6H"), 96: (6, "BC6HS"), 97: (7, "BC7"), 98: (7, "BC7"),
         99: (7, "BC7"), 27: (0, "RGBA"), 28: (0, "RGBA"), 29: (0, "RGBA")}


def header(data: bytes, path: str) -> dict:
    """PIL's ``DdsImageFile._open``: {"size", "kind", "offset", ...};
    ``PassOn`` (or ``struct.error``) where PIL passes the file on."""
    if data[:4] != b"DDS ":
        raise PassOn("not a DDS file")
    (hsize,) = struct.unpack("<I", data[4:8])
    if hsize != 124:
        raise ValueError(f"{path}: DDS header size {hsize} (PIL fails on it: unsupported header "
                         f"size)")
    if len(data) < 128:
        raise ValueError(f"{path}: DDS header cut short at {len(data) - 8} of 120 bytes (PIL "
                         f"fails on it: incomplete header)")
    height, width = struct.unpack("<II", data[12:20])
    pfflags, fourcc, bitcount = struct.unpack("<I4sI", data[80:92])
    head = {"size": (width, height), "offset": 128}
    if pfflags & _RGB:
        count = 4 if pfflags & _ALPHAPIXELS else 3
        head.update(kind="rgb", bitcount=bitcount,
                    masks=struct.unpack(f"<{count}I", data[92:92 + 4 * count]))
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            head["kind"] = "L"
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            head["kind"] = "LA"
        else:
            raise ValueError(f"{path}: DDS luminance of {bitcount} bits (PIL fails on it: "
                             f"unsupported bitcount)")
    elif pfflags & _PAL8:
        head.update(kind="P", offset=128 + 1024)
    elif pfflags & _FOURCC:
        if fourcc == b"DX10":
            (dxgi,) = struct.unpack("<I", data[128:132])
            if dxgi not in _DXGI:
                raise ValueError(f"{path}: DDS DXGI format {dxgi} (PIL fails on it: "
                                 f"Unimplemented DXGI format)")
            n, pixel_format = _DXGI[dxgi]
            head.update(kind="RGBA" if n == 0 else "bcn", n=n, pixel_format=pixel_format,
                        offset=148)
        elif fourcc in _FOURCCS:
            n, pixel_format = _FOURCCS[fourcc]
            head.update(kind="bcn", n=n, pixel_format=pixel_format)
        else:
            raise ValueError(f"{path}: DDS FourCC {fourcc!r} (PIL fails on it: Unimplemented "
                             f"pixel format)")
    else:
        raise ValueError(f"{path}: DDS pixel format flags {pfflags:#x} (PIL fails on it: "
                         f"unknown pixel format flags)")
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return head


def _raw(data: bytes, offset: int, width: int, height: int, bands: int, path: str) -> np.ndarray:
    need = width * height * bands
    if len(data) < offset + need:
        raise ValueError(f"{path}: truncated DDS data: {need} bytes of pixels from byte "
                         f"{offset}, the file ends at {len(data)} (PIL fails on it: image file "
                         f"is truncated)")
    return np.frombuffer(data, np.uint8, need, offset).reshape(height, width, bands)


def _dds_rgb(data: bytes, width: int, height: int, bitcount: int, masks) -> np.ndarray:
    """PIL's ``DdsRgbDecoder``: (H, W, len(masks)) uint8."""
    nbytes = bitcount // 8
    n = width * height
    used = min(nbytes, 4)  # the masks are 32-bit: higher bytes never reach them
    raw = data[128:128 + n * nbytes].ljust(n * nbytes, b"\0")
    px = np.frombuffer(raw, np.uint8).reshape(n, nbytes)[:, :used].astype(np.uint64)
    value = (px << (8 * np.arange(used, dtype=np.uint64))).sum(-1) if used else np.zeros(
        n, np.uint64)
    out = np.zeros((n, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        out[:, i] = (v / total * 255).astype(np.int64)
    return out.reshape(height, width, len(masks))


def decode_dds(data: bytes, path: str) -> np.ndarray:
    """A DDS file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    from . import image_bcn

    try:
        head = header(data, path)
    except (PassOn, struct.error) as e:
        raise ValueError(f"{path}: not a DDS file PIL opens ({e})") from None
    (width, height), kind, offset = head["size"], head["kind"], head["offset"]
    if kind == "rgb":
        return np.ascontiguousarray(_dds_rgb(data, width, height, head["bitcount"],
                                             head["masks"])[:, :, :3])
    if kind == "bcn":
        px = image_bcn.decode(data[offset:], width, height, head["n"], head["pixel_format"],
                              path)
    elif kind == "P":
        pal = np.frombuffer(data[128:128 + 1024].ljust(1024, b"\0"), np.uint8).reshape(256, 4)
        return pal[_raw(data, offset, width, height, 1, path)[:, :, 0], :3]
    else:
        px = _raw(data, offset, width, height, {"L": 1, "LA": 2, "RGBA": 4}[kind], path)
    if px.shape[2] < 3:  # L, LA
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])
