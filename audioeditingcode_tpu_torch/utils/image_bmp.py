"""BMP decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

What PIL's ``BmpImagePlugin`` opens, this reads, with PIL's rules:

- headers: BITMAPCOREHEADER (OS/2 1.x, 12 bytes, 3-byte palette entries,
  bottom-up only), BITMAPINFOHEADER (40; BI_BITFIELDS masks in the 12 bytes
  after it), the V2/V3 and OS/2 2.x sizes (52, 56, 64), V4 and V5 (108,
  124; masks inside the header, alpha from 56 bytes on);
- rows bottom-up, or top-down where the height's top byte is 0xFF (a
  negative height), each padded to 4 bytes;
- the pixel data at ``bfOffBits``; where that points just past the
  header and the depth takes a palette, 4 bytes per palette entry further
  on, as PIL does (also for OS/2's 3-byte entries);
- 1, 4 and 8 bits through a palette of ``biClrUsed`` entries (0 meaning
  2^bits); an index past the palette is black. A palette that is black
  then white at 2 entries makes PIL open mode ``1``, and one whose entry i
  is (i, i, i) mode ``L``; PIL then reads the rows as 1 bit (``1``) or 8
  bits (``L``) a pixel whatever the depth: this does so for ``1`` and
  raises for ``L`` below 8 bits, where PIL reads past each row;
- 16 bits as BGR 555 (BI_RGB, or BI_BITFIELDS 0x7C00/0x3E0/0x1F) or 565
  (BI_BITFIELDS 0xF800/0x7E0/0x1F), each field scaled by PIL's
  ``v * 255 // (2^bits - 1)``; 24 bits BGR; 32 bits BGRX (BI_RGB, the
  fourth byte ignored) or one of the byte-aligned BI_BITFIELDS layouts PIL
  lists (alpha dropped); other masks raise, as PIL does;
- RLE8 and RLE4 as PIL's ``BmpRleDecoder`` runs them, quirks included:
  encoded runs cut at the row's end; end of line fills the row with index
  0; end of bitmap stops; a delta escape reads two bytes it ignores and
  two more as (right, up), and fills that many pixels with index 0; an
  absolute run of n pixels reads n bytes (RLE8) or n // 2 bytes (RLE4, two
  pixels each), then skips a byte where the file position is odd. A
  stream that ends before the image is full fails, as PIL fails ("not
  enough image data").

A file whose rows end before its height raises, as PIL raises "image file
is truncated". A DIB (the same without the 14-byte file header, PIL's
``DibImageFile``; also an ICO or CUR entry) goes through ``decode_dib``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_io import _samples as _unpack

_RLE8, _RLE4, _BITFIELDS = 1, 2, 3
# PIL's 32-bit BI_BITFIELDS layouts: masks -> the byte of each of R, G, B in
# the little-endian pixel
_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0),
            (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
            (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0),
            (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),
            (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),
            (0x0, 0x0, 0x0, 0x0): (2, 1, 0)}
# 16-bit layouts: masks -> bits of (R, G, B) and their shifts
_MASKS16 = {(0xF800, 0x7E0, 0x1F): ((5, 6, 5), (11, 5, 0)),
            (0x7C00, 0x3E0, 0x1F): ((5, 5, 5), (10, 5, 0))}


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool, path: str) -> np.ndarray:
    """PIL's ``BmpRleDecoder.decode``: the indices in file order, (H, W)."""
    out = bytearray()
    total = width * height
    x = 0
    n = len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded: a run of one byte, or of two nibbles in turn
            count = min(count, max(0, width - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += pair * (count // 2) + pair[:count % 2]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then (right, up) from the next two
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError(f"{path}: truncated BMP data: the file ends in an RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # absolute run
            take = byte // 2 if rle4 else byte
            chunk = data[pos:pos + take]
            pos += len(chunk)
            if rle4:
                pairs = np.frombuffer(chunk, np.uint8)
                out += np.stack([pairs >> 4, pairs & 15], axis=1).tobytes()
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            pos += pos % 2  # to a 16-bit boundary of the file
    if len(out) < total:
        raise ValueError(f"{path}: BMP RLE data ends after {len(out)} of {total} pixels "
                         f"(PIL: not enough image data)")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(height, width)


def decode_dib(dib: bytes, path: str, halve: bool = False) -> np.ndarray:
    """A DIB's bytes (PIL's ``DibImageFile``: a BMP without its file header)
    as PIL reads them, at half its height where ``halve`` (an ICO or CUR
    entry's bitmap, its AND mask below): a file header put in front, the
    pixels after the header, the masks and the palette."""
    if len(dib) < 16:
        raise ValueError(f"{path}: truncated DIB data")
    (hsize,) = struct.unpack("<I", dib[:4])
    dib = bytearray(dib)
    if hsize == 12:
        (height,) = struct.unpack("<H", dib[6:8])
        if halve:
            dib[6:8] = struct.pack("<H", height // 2)
        bits, compression, colors, entry = struct.unpack("<H", dib[10:12])[0], 0, 0, 3
    else:
        if len(dib) < 36:
            raise ValueError(f"{path}: truncated DIB header")
        (height,) = struct.unpack("<i", dib[8:12])
        if halve:
            dib[8:12] = struct.pack("<i", int(height / 2))
        bits, compression = struct.unpack("<HI", dib[14:20])
        (colors,) = struct.unpack("<I", dib[32:36])
        entry = 4
    masks = 12 if hsize == 40 and compression == _BITFIELDS else 0
    pal = entry * (colors or 1 << bits) if bits <= 8 else 0
    head = b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, 14 + hsize + masks + pal)
    return decode_bmp(head + bytes(dib), path)


def decode_bmp(data: bytes, path: str) -> np.ndarray:
    """A BMP file's bytes as (H, W, 3) uint8 RGB."""
    if not data.startswith(b"BM") or len(data) < 18:
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if len(data) < 14 + hsize:
        raise ValueError(f"{path}: truncated BMP data: the file ends in its header")
    head = data[18:14 + hsize]
    masks = None
    top_down = False
    if hsize == 12:
        width, height, _, bits = struct.unpack("<HHHH", head[:8])
        compression, colors, entry = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        top_down = head[7] == 0xFF
        width, height = struct.unpack("<ii", head[:8])
        if top_down:
            height = -height
        _, bits, compression = struct.unpack("<HHI", head[8:16])
        (colors,) = struct.unpack("<I", head[28:32])
        entry = 4
        if compression == _BITFIELDS:
            if len(head) >= 48:
                masks = struct.unpack("<III", head[36:48]) + (
                    struct.unpack("<I", head[48:52]) if len(head) >= 52 else (0,))
            else:  # BITMAPINFOHEADER: three masks after the header
                masks = struct.unpack("<III", data[14 + hsize:26 + hsize]) + (0,)
    else:
        raise ValueError(f"{path}: BMP header of {hsize} bytes is not one PIL reads")
    if width <= 0 or height <= 0:
        raise ValueError(f"{path}: BMP of {width} x {height} pixels")
    colors = colors or 1 << bits
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: {bits}-bit BMP is not a depth PIL reads")
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    pal_pos = 14 + hsize + (12 if masks is not None and hsize == 40 else 0)
    if compression not in (0, _RLE8, _RLE4, _BITFIELDS):
        raise ValueError(f"{path}: BMP compression {compression} (JPEG or PNG inside a BMP) "
                         f"is not read")
    if compression == _BITFIELDS and not (
            (bits == 32 and masks in _MASKS32) or (bits == 16 and masks[:3] in _MASKS16)
            or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))):
        raise ValueError(f"{path}: unsupported BMP bitfields layout {masks} at {bits} bits")
    mode, pal = "RGB", None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: BMP palette of {colors} entries")
        raw = data[pal_pos:pal_pos + entry * colors]
        table = np.frombuffer(raw[:len(raw) // entry * entry], np.uint8).reshape(-1, entry)
        grey = (0, 255) if colors == 2 else range(colors)
        if len(table) == colors and all(
                (table[i, :3] == v).all() for i, v in enumerate(grey)):
            mode = "1" if colors == 2 else "L"
        else:
            mode = "P"
            pal = np.zeros((256, 3), np.uint8)
            pal[:min(256, len(table))] = table[:256, 2::-1]
    if compression in (_RLE8, _RLE4):
        if bits > 8:
            raise ValueError(f"{path}: {bits}-bit BMP with RLE compression")
        if mode == "1":  # PIL: "unknown raw mode for given image mode"
            raise ValueError(f"{path}: RLE BMP with a black-and-white palette is not read")
        px = _rle(data, offset, width, height, compression == _RLE4, path)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        if offset + stride * height > len(data):
            raise ValueError(f"{path}: truncated BMP data: {height} rows of {stride} bytes do "
                             f"not fit in the file")
        rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
        if mode == "1":
            px = _unpack(rows, width, 1, 1)[:, :, 0] * 255
        elif mode == "L":
            if bits != 8:
                raise ValueError(f"{path}: {bits}-bit BMP with a greyscale palette is not "
                                 f"read (PIL reads its rows at 8 bits a pixel)")
            px = rows[:, :width]
        elif mode == "P":
            px = _unpack(rows, width, 1, bits)[:, :, 0]
        elif bits == 16:
            v = rows[:, :2 * width].reshape(height, width, 2).astype(np.int64) @ [1, 256]
            nbits, shifts = _MASKS16[masks[:3] if masks else (0x7C00, 0x3E0, 0x1F)]
            px = np.stack([((v >> s) & ((1 << b) - 1)) * 255 // ((1 << b) - 1)
                           for b, s in zip(nbits, shifts)], axis=-1)
        elif bits == 24:
            px = rows[:, :3 * width].reshape(height, width, 3)[:, :, ::-1]
        else:
            quad = rows[:, :4 * width].reshape(height, width, 4)
            px = quad[:, :, list(_MASKS32[masks] if compression == _BITFIELDS else (2, 1, 0))]
    if not top_down:
        px = px[::-1]
    if mode == "P":
        px = pal[px]
    elif mode in ("1", "L"):
        px = np.repeat(px[:, :, None], 3, axis=2)
    return np.ascontiguousarray(px, np.uint8)
