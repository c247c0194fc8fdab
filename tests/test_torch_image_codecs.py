"""The port's GIF, BMP, TIFF and WebP decoders and its four-component JPEG
(utils/image_gif.py, image_bmp.py, image_tiff.py, image_webp.py,
image_vp8.py, image_io.py; numpy only) against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))``, the JAX CLIs' reader, on the
CPU. Every case must be bit-equal.

- Files PIL writes: GIF (interlaced or not, palette and greyscale), BMP
  1/8/24-bit, TIFF raw, PackBits, LZW and Deflate (with predictor 2 through
  libtiff), lossless WebP, lossy WebP at several qualities and methods with
  and without alpha (the alpha too, against PIL's RGBA), CMYK JPEG baseline
  and progressive.
- Files built here from the formats' specs: GIF with a local table, an
  offset or oversized first image, transparency, a deferred clear, a short
  palette, every minimum code size; BMP with each header, 1/4/8-bit
  palettes, 16-bit 555/565, 32-bit BI_RGB and bitfields, top-down rows and
  RLE8/RLE4 with every escape; TIFF big-endian, tiled, planar, with
  predictor 2, 16-bit, palette, WhiteIsZero, old-style LZW, each
  Orientation (``write``: the TIFF and BigTIFF writer the other TIFF tests
  share); WebP ``VP8X``
  with a raw ALPH chunk under each filter; YCCK JPEG (the Adobe transform
  byte set to 2) and CMYK without an Adobe marker.
- libwebp's fancy upsampler and its YUV -> RGB each pinned by a test.
- ``load_image`` on each new format equals the JAX ``load_image``.
- Truncated and corrupt files raise a ValueError where PIL raises.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu.utils import image_io as jio
from audioeditingcode_tpu_torch.utils import image_io as tio
from audioeditingcode_tpu_torch.utils import image_vp8, image_webp
from test_torch_image_formats import _pattern, _pil


def _check(path):
    want = _pil(path)
    got = tio.read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both_raise(path):
    """PIL raises on ``path``; so must the port, with a ValueError."""
    with pytest.raises(Exception):
        _pil(path)
    with pytest.raises(ValueError):
        tio.read_image(path)


# -------------------------------------------------------------------- GIF
def gif_lzw(indices: bytes, min_size: int, end: bool = True) -> bytes:
    """GIF LZW, least significant bit first; a clear code first, none when
    the table is full (a deferred clear)."""
    clear = 1 << min_size
    table = {bytes([i]): i for i in range(clear)}
    nxt, size = clear + 2, min_size + 1
    codes = [(clear, size)]
    cur = b""
    for b in indices:
        c = bytes([b])
        if cur + c in table:
            cur += c
            continue
        codes.append((table[cur], size))
        if nxt < 4096:
            table[cur + c] = nxt
            nxt += 1
            if nxt - 1 == 1 << size and size < 12:
                size += 1
        cur = c
    if cur:
        codes.append((table[cur], size))
    if end:
        codes.append((clear + 1, size))
    acc = nbits = 0
    out = bytearray()
    for c, s in codes:
        acc |= c << nbits
        nbits += s
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    return bytes(out + (bytes([acc]) if nbits else b""))


def _sub_blocks(b: bytes) -> bytes:
    return b"".join(bytes([len(b[i:i + 255])]) + b[i:i + 255] for i in range(0, len(b), 255)) \
        + b"\x00"


def write_gif(path, idx, screen=None, offset=(0, 0), gtab=None, ltab=None, min_size=8,
              transparency=None, interlace=False, stream=None):
    """A GIF89a of one image: (h, w) indices at ``offset`` on a logical
    screen (width, height), global and/or local tables, a graphic control
    extension, a comment and a NETSCAPE extension."""
    h, w = idx.shape
    sw, sh = screen or (w, h)

    def table_flags(t):
        return 0x80 | (int(np.log2(len(t))) - 1)

    data = b"GIF89a" + struct.pack("<HHBBB", sw, sh, table_flags(gtab) if gtab is not None else 0,
                                   3, 0)
    if gtab is not None:
        data += np.asarray(gtab, np.uint8).tobytes()
    data += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    if transparency is not None:
        data += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\x00"
    data += b"\x21\xfe" + _sub_blocks(b"made by the test")
    flags = (0x40 if interlace else 0) | (table_flags(ltab) if ltab is not None else 0)
    data += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags)
    if ltab is not None:
        data += np.asarray(ltab, np.uint8).tobytes()
    rows = idx
    if interlace:
        rows = idx[np.concatenate([np.arange(r0, h, s) for r0, s in ((0, 8), (4, 8), (2, 4),
                                                                      (1, 2))])]
    if stream is None:
        stream = gif_lzw(rows.astype(np.uint8).reshape(-1).tobytes(), min_size)
    data += bytes([min_size]) + _sub_blocks(stream) + b";"
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("mode", ["P", "L", "RGB"])
def test_gif_from_pil(tmp_path, mode, interlace):
    for h, w in ((1, 1), (13, 29), (97, 130)):
        img = Image.fromarray(_pattern(h, w))
        img = img.convert("L") if mode == "L" else img.quantize(77) if mode == "P" else img
        path = str(tmp_path / "a.gif")
        img.save(path, interlace=interlace)
        _check(path)


GIF_CASES = ["min_size_2", "min_size_5", "min_size_7", "local_table", "offset_fill",
             "offset_transparency", "oversized", "deferred_clear", "short_palette",
             "grey_table", "no_table", "interlaced_local"]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_built_by_hand(tmp_path, case):
    rng = np.random.default_rng(GIF_CASES.index(case))
    path = str(tmp_path / "a.gif")
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 256, (37, 53))
    if case.startswith("min_size"):
        ms = int(case[-1])
        idx = rng.integers(0, 1 << ms, (37, 53))
        write_gif(path, idx, gtab=pal[:max(2, 1 << ms)], min_size=ms)
    elif case == "local_table":
        write_gif(path, idx, gtab=pal, ltab=rng.integers(0, 256, (256, 3)))
    elif case in ("offset_fill", "offset_transparency"):
        small = rng.integers(0, 16, (10, 12))
        write_gif(path, small, screen=(30, 20), offset=(5, 3), gtab=pal[:16], min_size=4,
                  transparency=9 if case == "offset_transparency" else None)
    elif case == "oversized":  # the first image reaches past the logical screen
        write_gif(path, rng.integers(0, 16, (10, 12)), screen=(10, 5), offset=(5, 3),
                  gtab=pal[:16], min_size=4)
    elif case == "deferred_clear":  # noise fills the 4096 codes; no clear follows
        write_gif(path, rng.integers(0, 256, (120, 200)), gtab=pal)
    elif case == "short_palette":  # indices past a 16-entry table
        write_gif(path, idx, gtab=pal[:16])
    elif case == "grey_table":  # entry i = (i, i, i): PIL opens mode L
        write_gif(path, idx, gtab=np.repeat(np.arange(256)[:, None], 3, axis=1))
        assert Image.open(path).mode == "L"
    elif case == "no_table":
        write_gif(path, idx)
    else:
        write_gif(path, idx, screen=(60, 40), offset=(3, 2), gtab=pal[:4], min_size=8,
                  ltab=pal, interlace=True, transparency=200)
    _check(path)


def test_gif_truncated_or_corrupt_raises_as_pil(tmp_path):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 256, (37, 53))
    pal = rng.integers(0, 256, (256, 3))
    data = open(write_gif(str(tmp_path / "a.gif"), idx, gtab=pal), "rb").read()
    for n in (20, 800, 1500, len(data) - 3):
        cut = str(tmp_path / f"cut{n}.gif")
        open(cut, "wb").write(data[:n])
        _both_raise(cut)
    flat = idx.astype(np.uint8).reshape(-1).tobytes()
    short = gif_lzw(flat, 8, end=False)
    for name, stream in (("ends early", short[:len(short) // 2]),
                         ("end code early", gif_lzw(flat[:1000], 8)),
                         ("code past the table", (256 | (300 << 9) | (257 << 18)).to_bytes(4,
                                                                                   "little"))):
        path = write_gif(str(tmp_path / "s.gif"), idx, gtab=pal, stream=stream)
        _both_raise(path)


# -------------------------------------------------------------------- BMP
def _bmp_rows(idx: np.ndarray, bits: int):
    """Each row packed high bits first and padded to 4 bytes."""
    out = []
    for r in np.asarray(idx):
        if bits >= 8:
            b = r.astype(np.uint8).tobytes()
        else:
            per = 8 // bits
            rr = np.pad(r, (0, -len(r) % per)).reshape(-1, per).astype(np.uint8)
            b = sum(rr[:, i] << (8 - bits * (i + 1)) for i in range(per)).astype(
                np.uint8).tobytes()
        out.append(b + bytes(-len(b) % 4))
    return out


def write_bmp(path, body, width, height, bits, hsize=40, compression=0, palette=None,
              colors=None, masks=None, top_down=False, offset=None):
    """A BMP of ``body`` (the pixel data as stored) with a header of
    ``hsize`` bytes, a palette of (r, g, b) entries and bitfield masks."""
    pal = b""
    if palette is not None:
        entry = 3 if hsize == 12 else 4
        pal = b"".join(bytes([b, g, r] + [0] * (entry - 3)) for r, g, b in palette)
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        n = colors if colors is not None else (len(palette) if palette is not None else 0)
        head = struct.pack("<IiiHHIIiiII", hsize, width, -height if top_down else height, 1,
                           bits, compression, 0, 2835, 2835, n, 0)
        if hsize >= 52:
            head += struct.pack("<IIII", *(list(masks or (0, 0, 0, 0)) + [0])[:4])[:hsize - 40]
            head += bytes(hsize - len(head))
        elif masks is not None:
            head += struct.pack("<III", *masks[:3])
    start = 14 + len(head) + len(pal) if offset is None else offset
    data = b"BM" + struct.pack("<IHHI", start + len(body), 0, 0, start) + head + pal
    with open(path, "wb") as f:
        f.write(data + bytes(max(0, start - len(data))) + body)
    return path


def rle8(idx: np.ndarray) -> bytes:
    """RLE8 of (h, w) indices, bottom-up: runs of 2 or more encoded, other
    stretches of 3 or more absolute (padded to 16 bits), end of line after
    each row, end of bitmap at the end."""
    out = bytearray()
    for row in np.asarray(idx)[::-1].tolist():
        i, w = 0, len(row)
        while i < w:
            j = i
            while j < w and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, row[i]])
                i = j
                continue
            k = i
            while k < w and k - i < 255 and not (k + 1 < w and row[k + 1] == row[k]):
                k += 1
            if k - i >= 3:
                out += bytes([0, k - i] + row[i:k]) + bytes((k - i) % 2)
            else:
                out += b"".join(bytes([1, v]) for v in row[i:max(k, i + 1)])
                k = max(k, i + 1)
            i = k
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_bmp_from_pil(tmp_path, mode):
    for h, w in ((1, 1), (31, 45), (64, 97)):
        img = Image.fromarray(_pattern(h, w, noise=0.3))
        img = img.quantize(50) if mode == "P" else img.convert(mode)
        path = str(tmp_path / "a.bmp")
        img.save(path)
        _check(path)


@pytest.mark.parametrize("hsize", [12, 40, 108, 124])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palettes_and_headers(tmp_path, bits, hsize):
    rng = np.random.default_rng(bits * 1000 + hsize)
    h, w = 13, 21
    idx = rng.integers(0, 1 << bits, (h, w))
    for colors in (None, 3):  # biClrUsed 0 means 2^bits; 3 leaves indices past the palette
        pal = rng.integers(0, 256, (colors or 1 << bits, 3))
        n = 0 if colors is None else colors
        _check(write_bmp(str(tmp_path / "a.bmp"), b"".join(_bmp_rows(idx, bits)[::-1]), w, h,
                         bits, hsize, palette=pal, colors=n))
        if hsize != 12:
            _check(write_bmp(str(tmp_path / "t.bmp"), b"".join(_bmp_rows(idx, bits)), w, h,
                             bits, hsize, palette=pal, colors=n, top_down=True))


BMP_DIRECT = [(16, 0, None), (16, 3, (0xF800, 0x7E0, 0x1F)), (16, 3, (0x7C00, 0x3E0, 0x1F)),
              (24, 0, None), (32, 0, None), (32, 3, (0xFF0000, 0xFF00, 0xFF, 0)),
              (32, 3, (0xFF000000, 0xFF0000, 0xFF00, 0)), (32, 3, (0xFF, 0xFF00, 0xFF0000,
                                                                   0xFF000000)),
              (32, 3, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)), (32, 3, (0, 0, 0, 0))]


@pytest.mark.parametrize("bits,compression,masks", BMP_DIRECT)
def test_bmp_direct_colour(tmp_path, bits, compression, masks):
    rng = np.random.default_rng(bits)
    h, w = 11, 19
    stride = ((w * bits + 31) >> 3) & ~3
    body = rng.integers(0, 256, h * stride).astype(np.uint8).tobytes()
    for hsize in ((40, 124) if masks is None or len(masks) == 3 or not masks[3] else (124,)):
        if hsize == 40 and masks is not None and any(masks[3:]):
            continue
        _check(write_bmp(str(tmp_path / "a.bmp"), body, w, h, bits, hsize, compression,
                         masks=masks))
        _check(write_bmp(str(tmp_path / "t.bmp"), body, w, h, bits, hsize, compression,
                         masks=masks, top_down=True))
    if bits == 24:
        _check(write_bmp(str(tmp_path / "o.bmp"), body, w, h, 24, 12))


RLE_CASES = {
    # RLE8: encoded runs, an odd absolute run (padded), end of line, end of bitmap
    "rle8": (False, [3, 5, 0, 5, 1, 2, 3, 4, 5, 0, 2, 7, 0, 0] * 9 + [0, 1]),
    "rle8_even_absolute": (False, [0, 4, 1, 2, 3, 4, 0, 0] * 9 + [0, 1]),
    "rle8_run_past_the_row": (False, [20, 3, 0, 0] * 9 + [0, 1]),
    "rle8_delta": (False, [4, 1, 0, 2, 3, 1, 9, 9, 2, 2] + [0, 0] * 9 + [0, 1]),
    "rle4": (True, [5, 0x3A, 0, 5, 0x12, 0x34, 0x50, 0, 4, 0x9F, 0, 0] * 9 + [0, 1]),
    "rle4_odd_absolute": (True, [0, 3, 0x12, 0x34, 0, 0] * 9 + [0, 1]),
    "rle4_even_absolute": (True, [5, 0x3A, 0, 4, 0x12, 0x34, 0, 0] * 9 + [0, 1]),
    "rle8_ends_early": (False, [4, 1, 0, 0, 0, 1]),
    "rle4_delta": (True, [4, 1, 0, 2, 3, 1, 1, 0, 2, 2] + [0, 0] * 9 + [0, 1]),
}


@pytest.mark.parametrize("case", sorted(RLE_CASES))
def test_bmp_rle(tmp_path, case):
    """RLE4/RLE8 with every escape, as PIL's BmpRleDecoder runs them (its
    delta reads two bytes it ignores; a stream that leaves pixels unset
    fails in PIL and raises here)."""
    rle4, body = RLE_CASES[case]
    pal = np.random.default_rng(1).integers(0, 256, (16, 3))
    path = write_bmp(str(tmp_path / "r.bmp"), bytes(body), 14, 9, 4 if rle4 else 8,
                     compression=2 if rle4 else 1, palette=pal)
    try:
        _pil(path)
    except ValueError:
        _both_raise(path)
        return
    _check(path)
    if case == "rle8":
        _check(write_bmp(str(tmp_path / "t.bmp"), bytes(body), 14, 9, 8, compression=1,
                         palette=pal, top_down=True))


def test_bmp_rle8_of_an_image(tmp_path):
    img = Image.fromarray(_pattern(40, 61)).quantize(200)
    idx = np.asarray(img)
    pal = np.asarray(img.getpalette()[:600]).reshape(-1, 3)
    _check(write_bmp(str(tmp_path / "r.bmp"), rle8(idx), 61, 40, 8, compression=1,
                     palette=pal))


def test_bmp_truncated_or_unsupported_raises_as_pil(tmp_path):
    path = str(tmp_path / "a.bmp")
    Image.fromarray(_pattern(31, 45)).save(path)
    data = open(path, "rb").read()
    for n in (30, 100, len(data) - 10):
        open(tmp_path / "c.bmp", "wb").write(data[:n])
        _both_raise(str(tmp_path / "c.bmp"))
    body = bytes(2 * 8 * 11)
    _both_raise(write_bmp(str(tmp_path / "m.bmp"), body, 7, 11, 16, compression=3,
                          masks=(0xF00, 0xF0, 0xF)))


# ------------------------------------------------------------------- TIFF
def tiff_lzw(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW: most significant bit first with the early change, or the
    old least-significant-bit-first codes; a clear code first and before
    the table fills."""
    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = reset()
    codes = [(256, width)]
    cur = b""
    for b in data:
        c = bytes([b])
        if cur + c in table:
            cur += c
            continue
        codes.append((table[cur], width))
        table[cur + c] = nxt
        nxt += 1
        if width < 12 and (nxt - 1 == 1 << width if old else nxt == 1 << width):
            width += 1
        cur = c
        if nxt >= 4093:
            codes.append((256, width))
            table, nxt, width = reset()
    if cur:
        codes.append((table[cur], width))
    codes.append((257, width))
    out, acc, nbits = bytearray(), 0, 0
    for c, s in codes:
        if old:
            acc |= c << nbits
            nbits += s
            while nbits >= 8:
                out.append(acc & 255)
                acc >>= 8
                nbits -= 8
        else:
            acc = (acc << s) | c
            nbits += s
            while nbits >= 8:
                nbits -= 8
                out.append((acc >> nbits) & 255)
                acc &= (1 << nbits) - 1
    if nbits:
        out.append(acc & 255 if old else (acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
        else:
            k = min(len(data), i + 128)
            out += bytes([k - i - 1]) + data[i:k]
            i = k
    return bytes(out)


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 8: "h", 9: "i", 10: "i", 11: "f",
          12: "d", 16: "Q", 17: "q", 18: "Q"}


def layout(blocks, tags, order="<", big=False, tiled=False) -> bytes:
    """A TIFF (or BigTIFF) of already encoded strips or tiles and the tags
    {tag: (type, values or bytes)}; the offsets and byte counts are added."""
    hsize = 16 if big else 8
    body, offsets = b"", []
    for b in blocks:
        offsets.append(hsize + len(body))
        body += b + bytes(len(b) % 2)
    kind = 16 if big else 4
    tags = dict(tags)
    tags.update({324: (kind, offsets), 325: (kind, [len(b) for b in blocks])} if tiled else
                {273: (kind, offsets), 279: (kind, [len(b) for b in blocks])})
    nsize, esize, inline = (8, 20, 8) if big else (2, 12, 4)
    ifd = hsize + len(body)
    spill_at = ifd + nsize + esize * len(tags) + inline
    entries, spill = b"", b""
    for tag in sorted(tags):
        t, vals = tags[tag]
        if isinstance(vals, (bytes, bytearray)):
            packed, n = bytes(vals), len(vals)
        else:
            flat = [x for v in vals for x in v] if t in (5, 10) else list(vals)
            packed, n = struct.pack(order + _CODES[t] * len(flat), *flat), len(vals)
        entries += struct.pack(order + ("HHQ" if big else "HHI"), tag, t, n)
        if len(packed) <= inline:
            entries += packed.ljust(inline, b"\0")
        else:
            entries += struct.pack(order + ("Q" if big else "I"), spill_at + len(spill))
            spill += packed + bytes(len(packed) % 2)
    magic = {(False, "<"): b"II*\x00", (False, ">"): b"MM\x00*", (True, "<"): b"II+\x00",
             (True, ">"): b"MM\x00+"}[big, order]
    head = magic + (struct.pack(order + "HHQ", 8, 0, ifd) if big else struct.pack(order + "I",
                                                                                   ifd))
    count = struct.pack(order + ("Q" if big else "H"), len(tags))
    return head + body + count + entries + bytes(inline) + spill


def compress(raw: bytes, comp: int, old_lzw: bool = False) -> bytes:
    return {1: lambda x: x, 5: lambda x: tiff_lzw(x, old_lzw), 8: zlib.compress,
            32946: lambda x: zlib.compress(x, 9), 32773: packbits}[comp](raw)


def sample_bytes(px, bits, order, fmt=1, predictor=1) -> bytes:
    """(rows, cols, spp) samples -> the rows' bytes, with the predictor's
    differences (2: per sample, modulo 2^bits; 3: libtiff's byte planes)."""
    r, c, s = px.shape
    if bits == 12:
        v = px.astype(np.int64).reshape(r, -1)
        bitsarr = ((v[:, :, None] >> np.arange(11, -1, -1)) & 1).reshape(r, -1)
        pad = (-bitsarr.shape[1]) % 8
        return np.packbits(np.pad(bitsarr, ((0, 0), (0, pad))).astype(np.uint8), axis=1).tobytes()
    if bits < 8:
        v = px.astype(np.int64).reshape(r, -1)
        bitsarr = ((v[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(r, -1)
        pad = (-bitsarr.shape[1]) % 8
        return np.packbits(np.pad(bitsarr, ((0, 0), (0, pad))).astype(np.uint8), axis=1).tobytes()
    dt = {1: "u", 2: "i", 3: "f"}[fmt] + str(bits // 8)
    a = np.asarray(px).astype(order + dt)
    if predictor == 3:
        be = a.astype(">" + dt).view(np.uint8).reshape(r, c * s, bits // 8)
        planes = be.transpose(0, 2, 1).reshape(r, -1).astype(np.int64)
        d = planes.reshape(r, -1, s)
        d = np.concatenate([d[:, :1], np.diff(d, axis=1)], axis=1) & 255
        return d.astype(np.uint8).tobytes()
    if predictor == 2:
        u = a.view(order + "u" + str(bits // 8)).astype(np.int64)
        u = np.concatenate([u[:, :1], np.diff(u, axis=1)], axis=1) & ((1 << bits) - 1)
        a = u.astype(order + "u" + str(bits // 8))
    return a.tobytes()


def write(path, px, bits, photo, order="<", comp=1, fmt=1, predictor=1, planar=1, tile=None,
          rows=None, more=None, big=False, raw_blocks=None, fill=1, old_lzw=False):
    """A TIFF of (h, w, spp) samples: strips of ``rows`` rows or ``tile``
    (width, length) tiles, chunky or planar, compressed, with a predictor,
    sample format ``fmt``, FillOrder ``fill`` (2: the stored bytes' bits
    reversed) and the extra tags ``more``; ``raw_blocks``, where given, are
    the strips' or tiles' bytes before compression; ``old_lzw``, LZW's old
    least-significant-bit-first codes."""
    h, w, spp = px.shape
    blocks = []
    if raw_blocks is not None:
        blocks = [compress(b, comp, old_lzw) for b in raw_blocks]
    else:
        for plane in ([px] if planar == 1 else [px[:, :, i:i + 1] for i in range(spp)]):
            if tile:
                tw, th = tile
                for y in range(0, h, th):
                    for x in range(0, w, tw):
                        b = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                        part = plane[y:y + th, x:x + tw]
                        b[:part.shape[0], :part.shape[1]] = part
                        blocks.append(compress(sample_bytes(b, bits, order, fmt, predictor),
                                               comp, old_lzw))
            else:
                step = rows or h
                blocks += [compress(sample_bytes(plane[y:y + step], bits, order, fmt, predictor),
                                    comp, old_lzw) for y in range(0, h, step)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [comp]),
            262: (3, [photo]), 277: (3, [spp]), 284: (3, [planar])}
    if fmt != 1:
        tags[339] = (3, [fmt] * spp)
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]])})
    else:
        tags[278] = (4, [rows or h])
    if fill == 2:
        tags[266] = (3, [2])
        blocks = [b.translate(_REVERSED) for b in blocks]
    tags.update(more or {})
    with open(path, "wb") as f:
        f.write(layout(blocks, tags, order, big, tiled=bool(tile)))
    return str(path)


def write_tiff(path, px, bits, photo, order="<", comp=1, predictor=1, planar=1, tile=None,
               rows=None, extra=(), cmap=None, old_lzw=False, orientation=1):
    """A TIFF of (h, w, spp) samples through ``write``, with extra samples,
    a colormap and an Orientation tag."""
    more = {274: (3, [orientation])}
    if extra:
        more[338] = (3, list(extra))
    if cmap is not None:
        more[320] = (3, list(cmap))
    return write(path, px, bits, photo, order, comp, predictor=predictor, planar=planar, tile=tile,
                 rows=rows, more=more, old_lzw=old_lzw)


@pytest.mark.parametrize("compression", ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate",
                                         "tiff_deflate"])
def test_tiff_from_pil(tmp_path, compression):
    rng = np.random.default_rng(0)
    img = Image.fromarray(_pattern(33, 47))
    images = {"RGB": img, "RGBA": img.convert("RGBA"), "L": img.convert("L"),
              "1": img.convert("1"), "P": img.quantize(40),
              "I;16": Image.fromarray(rng.integers(0, 600, (33, 47)).astype(np.uint16))}
    for name, im in images.items():
        for info in ({}, {317: 2}):
            if info and name in ("1", "P"):
                continue
            path = str(tmp_path / "a.tif")
            im.save(path, compression=compression, tiffinfo=info)
            _check(path)


TIFF_SAMPLES = [(1, 8, 1, ()), (0, 8, 1, ()), (1, 1, 1, ()), (0, 1, 1, ()), (1, 4, 1, ()),
                (0, 2, 1, ()), (1, 16, 1, ()), (0, 16, 1, ()), (2, 8, 3, ()), (2, 16, 3, ()),
                (2, 8, 4, (2,)), (2, 8, 4, (1,)), (2, 8, 4, (0,)), (2, 16, 4, (2,)),
                (2, 16, 4, (1,)), (1, 8, 2, (2,)), (2, 8, 4, ()), (2, 8, 5, (1, 0))]


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
def test_tiff_built_by_hand(tmp_path, comp, order):
    """Every photometric, depth and extra-sample case, in strips, tiles and
    planes, with predictor 2 where libtiff applies it; where PIL has no
    mode or mis-reads, both raise."""
    rng = np.random.default_rng(comp)
    path = str(tmp_path / "a.tif")
    for photo, bits, spp, extra in TIFF_SAMPLES:
        px = rng.integers(0, 1 << bits, (19, 27, spp))
        px.reshape(-1)[:3] = [0, (1 << bits) - 1, min(255, (1 << bits) - 1)]
        if extra[:1] == (1,):  # premultiplied: colour at most alpha
            px[:, :, :3] = np.minimum(px[:, :, :3], px[:, :, 3:4])
        for kw in ({}, {"predictor": 2}, {"planar": 2}, {"tile": (16, 16)}, {"rows": 5}):
            if kw.get("predictor") and (bits < 8 or comp not in (5, 8)):
                continue
            if kw.get("planar") and spp == 1:
                continue
            write_tiff(path, px, bits, photo, order, comp, extra=extra, **kw)
            try:
                _pil(path)
            except Exception:
                _both_raise(path)
                continue
            try:
                _check(path)
            except ValueError as e:  # a planar file PIL mis-reads: the port refuses it
                assert "planar" in str(e) and kw.get("planar"), (photo, bits, spp, extra, kw)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_tiff_palette(tmp_path, bits):
    rng = np.random.default_rng(bits)
    for order in "<>":
        px = rng.integers(0, 1 << bits, (19, 27, 1))
        cmap = rng.integers(0, 65536, 3 * (1 << bits))
        _check(write_tiff(str(tmp_path / "p.tif"), px, bits, 3, order, 5, cmap=cmap))
        _check(write_tiff(str(tmp_path / "t.tif"), px, bits, 3, order, 8, cmap=cmap,
                          tile=(16, 32)))
    if bits == 8:
        two = np.concatenate([px, rng.integers(0, 256, (19, 27, 1))], -1)
        _check(write_tiff(str(tmp_path / "pa.tif"), two, 8, 3, comp=8, cmap=cmap, extra=(2,)))


def test_tiff_sixteen_bit_rules(tmp_path):
    """16-bit greyscale opens as I;16 and clamps at 255 (0, 771, 1542 ->
    0, 255, 255); 16-bit RGB keeps the high byte; the colormap its high
    byte: all on PIL's own decode."""
    grey = np.array([[0, 1, 255, 256, 771, 1542, 65535]])[:, :, None]
    for order in "<>":
        path = write_tiff(str(tmp_path / "g.tif"), grey, 16, 1, order, 5)
        assert tio.read_image(path)[0, :, 0].tolist() == [0, 1, 255, 255, 255, 255, 255] == \
            _pil(path)[0, :, 0].tolist()
        path = write_tiff(str(tmp_path / "c.tif"), np.repeat(grey, 3, axis=2), 16, 2, order, 8,
                          predictor=2)
        assert tio.read_image(path)[0, :, 0].tolist() == [0, 0, 0, 1, 3, 6, 255] == \
            _pil(path)[0, :, 0].tolist()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(tmp_path, orientation):
    """PIL turns the image by its Orientation tag on load. For 5-8 it misreads
    a single-block uncompressed file in a mode it memory-maps (L, I;16,
    RGBA), taking it at the swapped size: the port raises there."""
    rng = np.random.default_rng(orientation)
    for photo, bits, spp, extra in ((2, 8, 3, ()), (1, 8, 1, ()), (1, 16, 1, ()), (2, 8, 4, (2,)),
                                    (1, 8, 2, (2,))):
        px = rng.integers(0, 1 << bits, (19, 27, spp))
        mapped = spp in (1, 4)
        for comp in (1, 5):
            for kw in ({}, {"rows": 5}, {"tile": (32, 32)}, {"tile": (16, 16)}):
                path = write_tiff(str(tmp_path / "o.tif"), px, bits, photo, "<", comp,
                                  extra=extra, orientation=orientation, **kw)
                one_block = kw in ({}, {"tile": (32, 32)})
                if orientation >= 5 and comp == 1 and one_block and mapped:
                    with pytest.raises(ValueError, match=f"Orientation {orientation} on an "
                                                         f"uncompressed single-strip"):
                        tio.read_image(path)
                else:
                    _check(path)


def test_tiff_old_style_lzw_and_large_tables(tmp_path):
    rng = np.random.default_rng(9)
    big = rng.integers(0, 256, (120, 160, 3))
    for old in (False, True):
        _check(write_tiff(str(tmp_path / "o.tif"), big, 8, 2, comp=5, old_lzw=old, rows=40))


def test_tiff_truncated_raises_as_pil(tmp_path):
    path = str(tmp_path / "a.tif")
    Image.fromarray(_pattern(40, 50, noise=0.3)).save(path, compression="tiff_lzw")
    data = open(path, "rb").read()
    for n in (6, 40, len(data) // 2):
        open(tmp_path / "c.tif", "wb").write(data[:n])
        _both_raise(str(tmp_path / "c.tif"))


# ------------------------------------------------------------------- WebP
@pytest.mark.parametrize("kind", ["RGB", "RGBA", "palette_3", "palette_12", "palette_100"])
def test_lossless_webp(tmp_path, kind):
    rng = np.random.default_rng(4)
    for h, w in ((1, 1), (7, 13), (64, 96)):
        img = _pattern(h, w)
        if kind == "RGBA":
            im = Image.fromarray(np.concatenate([img, rng.integers(0, 256, (h, w, 1)).astype(
                np.uint8)], -1))
        elif kind.startswith("palette"):
            im = Image.fromarray(img).quantize(int(kind.split("_")[1])).convert("RGB")
        else:
            im = Image.fromarray(img)
        for method in (0, 4, 6):
            path = str(tmp_path / "a.webp")
            im.save(path, lossless=True, method=method)
            _check(path)
            np.testing.assert_array_equal(image_webp.read_webp_rgba(path),
                                          np.asarray(Image.open(path).convert("RGBA")))


@pytest.mark.parametrize("quality", [0, 20, 75, 95, 100])
@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "alpha"])
def test_lossy_webp(tmp_path, quality, alpha):
    """Lossy WebP from PIL, the alpha (compressed, filtered as libwebp's
    encoder picks) against PIL's RGBA too: the colour under transparent
    pixels is kept."""
    rng = np.random.default_rng(quality)
    for h, w in ((2, 3), (17, 33), (97, 130)):
        img = _pattern(h, w, noise=0.2, seed=h)
        a = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        a[:h // 2] = 0
        src = np.concatenate([img, a], -1) if alpha else img
        for method in (0, 4, 6):
            path = str(tmp_path / "a.webp")
            Image.fromarray(src).save(path, quality=quality, method=method,
                                      alpha_quality=100 if method else 50)
            _check(path)
            np.testing.assert_array_equal(image_webp.read_webp_rgba(path),
                                          np.asarray(Image.open(path).convert("RGBA")))


def _riff(*chunks) -> bytes:
    body = b"WEBP" + b"".join(tag + struct.pack("<I", len(d)) + d + bytes(len(d) % 2)
                              for tag, d in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8_chunk(img: np.ndarray, quality: int = 80) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", quality=quality)
    data = buf.getvalue()
    assert data[12:16] == b"VP8 "
    return data[20:20 + struct.unpack("<I", data[16:20])[0]]


def _filter_alpha(a: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's forward alpha filters: the first row from the left (its
    first pixel as is), each later row's first pixel from above."""
    if filt == 0:
        return a
    a = a.astype(np.int64)
    out = a.copy()
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    if filt == 1:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        out[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif filt == 2:
        out[1:] = a[1:] - a[:-1]
    else:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        grad = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
        out[1:, 1:] = a[1:, 1:] - grad
    return (out & 255).astype(np.uint8)


@pytest.mark.parametrize("filt", [0, 1, 2, 3], ids=["none", "horizontal", "vertical",
                                                     "gradient"])
def test_webp_vp8x_with_raw_alpha(tmp_path, filt):
    """A VP8X file built here: canvas, ICCP and EXIF chunks, a raw ALPH
    chunk under each filter, then PIL's VP8 chunk."""
    h, w = 37, 51
    img = _pattern(h, w, seed=filt)
    rng = np.random.default_rng(filt)
    alpha = np.clip(np.add.outer(np.arange(h) * 5, np.arange(w) * 3) + rng.integers(-20, 20, (
        h, w)), 0, 255).astype(np.uint8)
    alpha[:5, :7] = 0
    vp8x = bytes([0x10 | 0x20 | 0x08, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")
    alph = bytes([filt << 2]) + _filter_alpha(alpha, filt).tobytes()
    path = str(tmp_path / "x.webp")
    with open(path, "wb") as f:
        f.write(_riff((b"VP8X", vp8x), (b"ICCP", b"not a real profile"), (b"ALPH", alph),
                      (b"VP8 ", _vp8_chunk(img)), (b"EXIF", b"Exif\x00\x00junk")))
    _check(path)
    rgba = image_webp.read_webp_rgba(path)
    np.testing.assert_array_equal(rgba, np.asarray(Image.open(path).convert("RGBA")))
    np.testing.assert_array_equal(rgba[:, :, 3], alpha)


def test_webp_metadata_chunks_from_pil(tmp_path):
    path = str(tmp_path / "m.webp")
    img = Image.fromarray(_pattern(30, 41))
    img.save(path, quality=70, exif=b"Exif\x00\x00II*\x00\x08\x00\x00\x00\x00\x00",
             xmp=b"<x:xmpmeta/>")
    assert open(path, "rb").read()[12:16] == b"VP8X"
    _check(path)
    img.save(path, lossless=True, icc_profile=b"\x00" * 128)
    _check(path)


def _yuv(path):
    data = open(path, "rb").read()
    return image_vp8.decode_vp8_yuv(data[20:20 + struct.unpack("<I", data[16:20])[0]])


def test_fancy_upsampler_is_libwebps(tmp_path):
    """libwebp's 9-3-3-1 upsampler in its two rounded steps gives PIL's
    pixels; one rounded step, or the nearest chroma sample, does not."""
    path = str(tmp_path / "u.webp")
    Image.fromarray(_pattern(41, 58, noise=0.4)).save(path, quality=90)
    y, u, v = _yuv(path)
    h, w = y.shape
    want = _pil(path)
    got = image_vp8.yuv_to_rgb(y, image_vp8.fancy_upsample(u, h, w),
                               image_vp8.fancy_upsample(v, h, w))
    np.testing.assert_array_equal(got, want)

    def one_step(c):
        c = np.pad(c.astype(np.int64), 1, mode="edge")
        out = np.empty((h, w), np.int64)
        for yy in range(h):
            n, f = (yy + 1) // 2, (yy + 1) // 2 + (1 if yy % 2 else -1)
            for xx in range(w):
                cn, cf = (xx + 1) // 2, (xx + 1) // 2 + (1 if xx % 2 else -1)
                out[yy, xx] = (9 * c[n, cn] + 3 * c[n, cf] + 3 * c[f, cn] + c[f, cf] + 8) >> 4
        return out

    def nearest(c):
        return np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)[:h, :w]

    for other in (one_step, nearest):
        assert not np.array_equal(image_vp8.yuv_to_rgb(y, other(u), other(v)), want), other


def test_yuv_to_rgb_is_libwebps_fixed_point(tmp_path):
    """Flat colours through libwebp: its 14-bit fixed point gives PIL's
    pixels exactly; BT.601 in floating point does not."""
    colours = np.random.default_rng(2).integers(0, 256, (24, 3))
    img = np.repeat(np.repeat(colours[None], 16, axis=0), 16, axis=1).astype(np.uint8)
    path = str(tmp_path / "f.webp")
    Image.fromarray(img).save(path, quality=100)
    y, u, v = _yuv(path)
    h, w = y.shape
    uu, vv = image_vp8.fancy_upsample(u, h, w), image_vp8.fancy_upsample(v, h, w)
    want = _pil(path)
    np.testing.assert_array_equal(image_vp8.yuv_to_rgb(y, uu, vv), want)
    yf, uf, vf = y - 16.0, uu - 128.0, vv - 128.0
    float601 = np.stack([1.164 * yf + 1.596 * vf, 1.164 * yf - 0.392 * uf - 0.813 * vf,
                         1.164 * yf + 2.017 * uf], -1)
    assert not np.array_equal(np.clip(np.round(float601), 0, 255).astype(np.uint8), want)


def test_webp_truncated_or_corrupt_raises_as_pil(tmp_path):
    img = _pattern(40, 56, noise=0.3)
    for kw in ({"lossless": True}, {"quality": 60}):
        path = str(tmp_path / "a.webp")
        Image.fromarray(np.concatenate([img, img[:, :, :1]], -1)).save(path, **kw)
        data = open(path, "rb").read()
        for n in (10, 30, len(data) // 3, len(data) - 5):
            open(tmp_path / "c.webp", "wb").write(data[:n])
            _both_raise(str(tmp_path / "c.webp"))
        # a RIFF size that fits but a chunk whose payload is cut short
        cut = bytearray(data[:len(data) // 2])
        cut[4:8] = struct.pack("<I", len(cut) - 8)
        open(tmp_path / "r.webp", "wb").write(bytes(cut))
        _both_raise(str(tmp_path / "r.webp"))


# ---------------------------------------------------------- CMYK/YCCK JPEG
def _adobe_patched(src: str, dst: str, transform) -> str:
    """``src`` with its Adobe APP14 transform byte set, or the segment
    removed (transform None)."""
    data = bytearray(open(src, "rb").read())
    i = data.index(b"Adobe")
    if transform is None:
        n = (data[i - 2] << 8) | data[i - 1]
        data = data[:i - 4] + data[i - 2 + n:]
    else:
        data[i + 11] = transform
    open(dst, "wb").write(bytes(data))
    return dst


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("quality", [10, 80, 100])
def test_cmyk_and_ycck_jpeg(tmp_path, quality, progressive):
    for h, w in ((1, 1), (9, 17), (45, 31), (120, 161)):
        src = str(tmp_path / "c.jpg")
        Image.fromarray(_pattern(h, w)).convert("CMYK").save(
            src, quality=quality, progressive=progressive, restart_marker_blocks=3)
        assert Image.open(src).mode == "CMYK"
        _check(src)
        _check(_adobe_patched(src, str(tmp_path / "y.jpg"), 2))
        _check(_adobe_patched(src, str(tmp_path / "n.jpg"), None))


# --------------------------------------------------------- through load_image
@pytest.mark.parametrize("fmt", ["gif", "bmp", "tiff", "webp_lossless", "webp_lossy",
                                 "webp_alpha", "cmyk_jpeg", "ycck_jpeg"])
def test_load_image_matches_jax(tmp_path, fmt):
    img = _pattern(90, 130)
    suffix = {"gif": "gif", "bmp": "bmp", "tiff": "tif"}.get(fmt, "jpg" if "jpeg" in fmt
                                                               else "webp")
    path = str(tmp_path / f"a.{suffix}")
    im = Image.fromarray(img)
    if fmt == "gif":
        im.quantize(200).save(path, interlace=True)
    elif fmt == "bmp":
        im.save(path)
    elif fmt == "tiff":
        write_tiff(path, img, 8, 2, ">", 5, predictor=2, tile=(48, 32))
    elif fmt == "webp_lossless":
        im.save(path, lossless=True)
    elif fmt == "webp_lossy":
        im.save(path, quality=85)
    elif fmt == "webp_alpha":
        Image.fromarray(np.concatenate([img, img[:, :, 1:2]], -1)).save(path, quality=85)
    else:
        im.convert("CMYK").save(path, quality=90, progressive=True)
        if fmt == "ycck_jpeg":
            path = _adobe_patched(path, str(tmp_path / "y.jpg"), 2)
    want = jio.load_image(path, left=3, top=2, resize=(64, 64))
    got = tio.load_image(path, left=3, top=2, resize=(64, 64))
    assert got.shape == want.shape == (1, 3, 64, 64)
    np.testing.assert_array_equal(got, want)
