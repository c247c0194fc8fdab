"""The port's Netpbm, TGA and ICO/CUR readers (utils/image_pnm.py,
image_tga.py, image_ico.py) against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

- Netpbm: what PIL writes (P4, P5 at 8 and 16 bits, P6, Pf), and files
  built here for every magic PIL opens (P1-P6, Pf, P0CMYK, PyP, PyRGBA,
  PyCMYK), plain and binary, maxvals from 1 to 65535 (P5 above 255 opens as
  ``I`` and clamps), comments in the header and the plain data, a comment
  inside a header token; P7 and PF, which PIL does not open, raise.
- TGA: what PIL writes (L, LA, P, RGB, RGBA, raw and RLE, both origins),
  and files built here: image types 1, 2, 3, 9, 10, 11 at 1, 8, 16, 24 and
  32 bits, 16- and 24-bit colour maps with a first index, an image-ID
  field, all four origins, literal RLE packets that run from row to row;
  headers PIL does not take for a TGA, depths and colour maps it fails on
  and run packets across a row's end raise.
- ICO/CUR: what PIL writes (PNG entries, and DIB entries with
  ``bitmap_format="bmp"``), and files built here: DIB entries at 1, 4, 8,
  24 and 32 bits with their AND masks, several sizes and depths (PIL's
  choice: the largest, then the lowest depth), a 256-pixel entry, CUR with
  several cursors; a PNG cursor and a cut mask raise, as in PIL.
- Every case compares; each function counts the cases it checked.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_image_codecs import _both_raise, _bmp_rows, _check
from test_torch_image_formats import _pattern


# ------------------------------------------------------------------ Netpbm
@pytest.mark.parametrize("mode", ["1", "L", "RGB", "I;16", "F"])
def test_netpbm_from_pil(tmp_path, mode):
    rng = np.random.default_rng(0)
    img = Image.fromarray(_pattern(23, 37, noise=0.3))
    im = {"1": img.convert("1"), "L": img.convert("L"), "RGB": img,
          "I;16": Image.fromarray(rng.integers(0, 65536, (23, 37)).astype(np.uint16)),
          "F": Image.fromarray((rng.standard_normal((23, 37)) * 200 + 100).astype(
              np.float32))}[mode]
    path = str(tmp_path / "a.pnm")
    im.save(path, format="PPM")
    _check(path)


def _pnm(magic, w, h, maxval, body, comment=b""):
    head = magic + b"\n" + comment + b"%d %d\n" % (w, h)
    if maxval is not None:
        head += b"%s\n" % (maxval if isinstance(maxval, bytes) else b"%d" % maxval)
    return head + body


def test_netpbm_built_by_hand(tmp_path):
    """Every magic, plain and binary, at several maxvals."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "p.pnm")
    checked = 0
    w, h = 7, 5
    for magic, bands in ((b"P2", 1), (b"P3", 3), (b"P5", 1), (b"P6", 3), (b"P0CMYK", 4),
                         (b"PyCMYK", 4), (b"PyRGBA", 4), (b"PyP", 1)):
        for maxval in (1, 15, 100, 255, 256, 1000, 65535):
            v = rng.integers(0, maxval + 1, (h, w, bands))
            v.reshape(-1)[:2] = [0, maxval]
            if magic in (b"P2", b"P3"):
                body = b"\n".join(b" ".join(b"%d" % x for x in row.reshape(-1)) for row in v)
            else:
                body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            open(path, "wb").write(_pnm(magic, w, h, maxval, body, b"# a comment\n"))
            _check(path)
            checked += 1
    bits = rng.integers(0, 2, (h, w))
    open(path, "wb").write(_pnm(b"P1", w, h, None, b"".join(b"%d" % x for x in bits.reshape(
        -1))))
    _check(path)
    open(path, "wb").write(_pnm(b"P1", w, h, None, b" \n".join(b"%d" % x for x in bits.reshape(
        -1)) + b"\n# trailing comment"))
    _check(path)
    open(path, "wb").write(_pnm(b"P4", w, h, None, np.packbits(bits, axis=1).tobytes()))
    _check(path)
    for scale in (b"-1.0", b"2.5"):
        f = (rng.standard_normal((h, w)) * 200 + 100).astype(np.float32)
        f[0, :4] = [np.nan, np.inf, -np.inf, 254.99]
        open(path, "wb").write(_pnm(b"Pf", w, h, scale, f.astype(
            "<f4" if scale.startswith(b"-") else ">f4").tobytes()))
        _check(path)
    assert checked == 56


def test_netpbm_header_quirks(tmp_path):
    """Comments between and inside header tokens, tabs and CRs, samples
    above maxval (clamped in binary data), comments in plain data."""
    path = str(tmp_path / "q.pnm")
    rng = np.random.default_rng(2)
    v = rng.integers(0, 256, (4, 6, 3)).astype(np.uint8)
    cases = [b"P6\t6\r4 #c\n255\n", b"P6 #x\n 6#y\n 4 2#z\n55 ", b"P6\n6 4\n2#w\n55\n",
             b"P6 6 4 255\r"]
    for head in cases:
        open(path, "wb").write(head + v.tobytes())
        _check(path)
    open(path, "wb").write(b"P5 6 4 100\n" + rng.integers(0, 256, 24).astype(np.uint8).tobytes())
    _check(path)
    open(path, "wb").write(b"P5 6 4 1000\n" + rng.integers(0, 2000, 24).astype(">u2").tobytes())
    _check(path)
    open(path, "wb").write(b"P2 3 2 9 # c\n1 2 3 #x\n 4 5 6 7 junk")
    _check(path)


def test_netpbm_refused_and_truncated(tmp_path):
    """PAM, colour PFM, a value above maxval in plain data, a bad token,
    maxval 0 and short files: PIL fails, the port raises."""
    path = str(tmp_path / "r.pnm")
    rng = np.random.default_rng(3)
    raster = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    for data in (b"P7\nWIDTH 4\nHEIGHT 4\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n" + raster,
                 b"PF\n4 4\n-1.0\n" + bytes(192), b"P2 2 2 9\n1 2 3 10", b"P2 2 2 9\n1 2 x 3",
                 b"P5 4 4 0\n" + raster[:16], b"P6 4 4 255\n" + raster[:40],
                 b"P3 2 2 255\n1 2 3 4", b"P1 3 3\n0102", b"P5 4 4", b"Pf 2 2 0\n" + bytes(16),
                 b"P5 4 4 255\n" + raster[:10], b"P6 4 4 1000\n" + raster):
        open(path, "wb").write(data)
        _both_raise(path)


# --------------------------------------------------------------------- TGA
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_tga_from_pil(tmp_path, rle):
    img = Image.fromarray(_pattern(23, 37, noise=0.3))
    path = str(tmp_path / "a.tga")
    checked = 0
    for im in (img, img.convert("L"), img.convert("LA"), img.convert("RGBA"), img.quantize(50)):
        for orientation in (1, -1):
            im.save(path, compression="tga_rle" if rle else None, orientation=orientation,
                    id_section=b"made by the test")
            _check(path)
            checked += 1
    assert checked == 10


def tga(itype, depth, pixels: bytes, w, h, cmap=None, cmap_start=0, cmap_depth=24, flags=0x20,
        ident=b""):
    """A TGA file: header, image ID, colour map bytes, pixel bytes."""
    n = 0 if cmap is None else len(cmap) // (cmap_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap is not None else 0, itype,
                       cmap_start, n, cmap_depth if cmap is not None else 0, 0, 0, w, h, depth,
                       flags)
    return head + ident + (cmap or b"") + pixels


def tga_rle(raw: bytes, bpp: int, row: int = 0) -> bytes:
    """Run-length packets over a whole image's pixels, literals crossing
    rows; runs cut at the end of each row of ``row`` pixels (where PIL
    fails on them), or not where ``row`` is 0."""
    px = [raw[i:i + bpp] for i in range(0, len(raw), bpp)]
    out, i = bytearray(), 0
    while i < len(px):
        j = i
        while j < len(px) and j - i < 128 and px[j] == px[i] and (not row or j == i
                                                                   or j % row):
            j += 1
        if j - i >= 2:
            out += bytes([0x80 | (j - i - 1)]) + px[i]
            i = j
        else:
            k = i + 1
            while k < len(px) and k - i < 128 and (k + 1 >= len(px) or px[k] != px[k + 1]):
                k += 1
            out += bytes([k - i - 1]) + b"".join(px[i:k])
            i = k
    return bytes(out)


def test_tga_built_by_hand(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "t.tga")
    w, h = 13, 7
    checked = 0
    for itype, depth in ((2, 16), (2, 24), (2, 32), (3, 8), (3, 16), (3, 1), (1, 8)):
        stride = (w * depth + 7) // 8
        raw = rng.integers(0, 256, stride * h).astype(np.uint8)
        if depth > 1:  # long runs, also across rows
            raw.reshape(h, stride)[2:4] = raw.reshape(h, stride)[2, :(depth + 7) // 8].tolist() * (
                stride // ((depth + 7) // 8))
        raw = raw.tobytes()
        for cmap_depth, start in ((24, 0), (16, 3), (24, 56)):
            cmap = None
            if itype == 1:
                cmap = rng.integers(0, 256, 200 * cmap_depth // 8).astype(np.uint8).tobytes()
            elif (cmap_depth, start) != (24, 0):
                continue
            for flags in (0x00, 0x10, 0x20, 0x30):
                for rle in (False, True):
                    if rle and depth == 1:
                        continue
                    body = tga_rle(raw, (depth + 7) // 8, w) if rle else raw
                    open(path, "wb").write(tga(itype | (8 if rle else 0), depth, body, w, h, cmap,
                                               start, cmap_depth, flags, b"id!"))
                    _check(path)
                    checked += 1
    assert checked == 68


def test_tga_refused_and_truncated(tmp_path):
    """Headers PIL does not take for a TGA (unknown formats in the port),
    colour-mapped without a map, depths without a raw mode, RLE at 1 bit,
    cut files, a run packet across a row's end: PIL fails, the port
    raises."""
    path = str(tmp_path / "r.tga")
    px = bytes(range(256)) * 4
    cases = [tga(2, 15, px, 8, 4), tga(2, 24, px, 0, 4), tga(4, 8, px, 8, 4),
             tga(1, 8, px, 8, 4), tga(2, 8, px, 8, 4), tga(3, 24, px, 8, 4),
             tga(1, 16, px, 8, 4, cmap=bytes(30)), tga(11, 1, b"\x83\xff" * 8, 8, 4),
             tga(2, 24, px[:50], 8, 4), tga(10, 24, tga_rle(px[:96], 3)[:20], 8, 4),
             tga(1, 8, px[:32], 8, 4, cmap=bytes(30), cmap_depth=8),
             tga(10, 24, b"\x85" + bytes(3) + b"\x85" + bytes(3) + b"\x83" + bytes(3), 4, 4),
             tga(1, 8, px[:32], 8, 4, cmap=bytes(40), cmap_depth=32),
             tga(1, 8, px[:32], 8, 4, cmap=bytes(30), cmap_start=250)]
    for data in cases:
        open(path, "wb").write(data)
        _both_raise(path)


# ----------------------------------------------------------------- ICO/CUR
def test_ico_from_pil(tmp_path):
    img = Image.fromarray(_pattern(64, 64, noise=0.3))
    path = str(tmp_path / "a.ico")
    checked = 0
    for im in (img, img.convert("RGBA"), img.convert("P"), img.convert("L")):
        for fmt in ("png", "bmp"):
            im.save(path, sizes=[(16, 16), (48, 48), (32, 32)], bitmap_format=fmt)
            _check(path)
            checked += 1
    assert checked == 8


def _dib(idx_or_rgb, bits, palette=None):
    """A DIB (40-byte header, height doubled) with its AND mask."""
    h, w = idx_or_rgb.shape[:2]
    rows = _bmp_rows(idx_or_rgb[::-1], bits)
    body = b"".join(rows)
    colors = 0 if palette is None else len(palette)
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, len(body), 0, 0, colors, 0)
    pal = b"" if palette is None else b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    mask_stride = (w + 31) // 32 * 4
    mask = np.random.default_rng(w).integers(0, 256, mask_stride * h).astype(np.uint8).tobytes()
    return head + pal + body + mask


def ico(entries, cur=False):
    """An ICO or CUR of (width byte, height byte, colours, bpp, payload)."""
    out = struct.pack("<HHH", 0, 2 if cur else 1, len(entries))
    offset = 6 + 16 * len(entries)
    dirs, blobs = b"", b""
    for wb, hb, ncolor, bpp, payload in entries:
        dirs += struct.pack("<BBBBHHII", wb, hb, ncolor, 0, 1, bpp, len(payload),
                            offset + len(blobs))
        blobs += payload
    return out + dirs + blobs


def test_ico_built_by_hand(tmp_path):
    """DIB entries at each depth, several of one size at other depths (PIL
    takes the lowest), a 256-pixel PNG entry, CUR picks."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "i.ico")
    checked = 0
    dibs = {}
    for bits in (1, 4, 8, 24, 32):
        if bits <= 8:
            pal = rng.integers(0, 256, (1 << bits, 3))
            dibs[bits] = _dib(rng.integers(0, 1 << bits, (20, 24)), bits, pal)
        else:
            dibs[bits] = _dib(rng.integers(0, 256, (20, 24, bits // 8)), bits)
    for bits, dib in dibs.items():
        open(path, "wb").write(ico([(24, 20, 0, bits, dib)]))
        _check(path)
        checked += 1
    for order in ([32, 8, 24], [24, 4, 1], [1, 32]):
        open(path, "wb").write(ico([(24, 20, 0, b, dibs[b]) for b in order]
                                   + [(16, 16, 0, 32, _dib(rng.integers(0, 256, (16, 16, 4)),
                                                             32))]))
        _check(path)
        checked += 1
    big = io.BytesIO()
    Image.fromarray(_pattern(256, 256)).save(big, "PNG")
    open(path, "wb").write(ico([(24, 20, 0, 8, dibs[8]), (0, 0, 0, 32, big.getvalue())]))
    _check(path)
    for entries in ([(24, 20, 0, 8, dibs[8]), (24, 20, 0, 24, dibs[24])],
                    [(24, 20, 0, 4, dibs[4]), (16, 30, 0, 24, dibs[24]), (30, 30, 0, 1, dibs[1])]):
        open(path, "wb").write(ico(entries, cur=True))
        _check(path)
        checked += 1
    assert checked == 10


def test_ico_refused_and_truncated(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "r.ico")
    dib = _dib(rng.integers(0, 256, (20, 24, 3)), 24)
    png = io.BytesIO()
    Image.fromarray(_pattern(16, 16)).save(png, "PNG")
    for data in (ico([(24, 20, 0, 24, dib)])[:-30], ico([(16, 16, 0, 32, png.getvalue())],
                                                           cur=True),
                 ico([(24, 20, 0, 24, dib)])[:100], b"\x00\x00\x01\x00\x05\x00" + bytes(20)):
        open(path, "wb").write(data)
        _both_raise(path)


# --------------------------------------------------------------------- DIB
def test_dib_from_pil_and_by_hand(tmp_path):
    """A DIB file (a BMP without its 14-byte file header, PIL's
    DibImageFile): PIL's BMPs at each mode cut so, and hand-built DIBs."""
    img = Image.fromarray(_pattern(23, 37, noise=0.3))
    path = str(tmp_path / "a.dib")
    checked = 0
    for im in (img, img.convert("L"), img.convert("1"), img.quantize(40)):
        buf = io.BytesIO()
        im.save(buf, "BMP")
        with open(path, "wb") as f:
            f.write(buf.getvalue()[14:])
        _check(path)
        checked += 1
    rng = np.random.default_rng(8)
    for bits in (4, 8, 24):
        px = rng.integers(0, 1 << min(bits, 8), (11, 19) if bits <= 8 else (11, 19, 3))
        dib = _dib(px, bits, rng.integers(0, 256, (1 << bits, 3)) if bits <= 8 else None)
        head = bytearray(dib[:40])
        head[8:12] = struct.pack("<i", 11)  # the height of the bitmap alone
        with open(path, "wb") as f:
            f.write(bytes(head) + dib[40:])
        _check(path)
        checked += 1
    assert checked == 7
