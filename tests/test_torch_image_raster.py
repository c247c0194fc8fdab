"""The port's QOI, PCX/DCX, SGI, Sun raster, MSP, XBM, XPM and IM readers
(utils/image_qoi.py, image_pcx.py, image_sgi.py, image_sun.py,
image_msp.py, image_xbm.py, image_xpm.py, image_im.py) against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

- What PIL writes, in every mode it writes: QOI (RGB, RGBA), PCX (1, L, P,
  RGB), SGI (L, RGB, RGBA at 8 and 16 bits), MSP version 1, XBM (with and
  without a hot spot), IM (1, L, LA, P, PA, I, I;16, I;16L, I;16B, F, RGB,
  RGBA, RGBX, CMYK, YCbCr).
- Files built here from the formats' layouts for what PIL does not write:
  PCX planes of 1 bit with the header's palette, an 8-bit grey PCX with and
  without a trailing palette, odd strides, a window off the origin; DCX;
  SGI RLE at 8 and 16 bits in 1, 3 and 4 channels, rows that end early and
  a last packet that stops PIL; Sun raster types 0-5 at 1, 4, 8, 24 and 32
  bits with colour maps and RLE runs across rows; MSP version 2 with blank
  rows and rows of other lengths; XBM with one-digit hex; XPM of 1 and 2
  characters a pixel, more than 256 colours, ``None``; IM types PIL reads
  but does not write (the bit decoder's widths, 2- and 4-bit palettes,
  three whole planes, signed samples, Luts it ignores).
- Refused files: PIL fails on each (asserted), and the port's ValueError
  names PIL failing.
- Random files (QOI op streams, PCX and SGI headers and bodies): equal to
  PIL where both read, both fail otherwise.
"""

import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_formats import _pattern

# PIL's opener order in a fresh interpreter: preinit()'s six, then init()'s
FRESH = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR", "CUR", "PCX", "DCX",
         "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO",
         "IM", "IMT", "IPTC", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI",
         "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")


def pil(path):
    """PIL's ``convert("RGB")`` of the file, opened in the fresh order."""
    with Image.open(path, formats=FRESH) as im:
        return np.asarray(im.convert("RGB"))


def check(path, fmt=None):
    """The port reads the file as PIL does, bit for bit (and as ``fmt``)."""
    want = pil(path)
    got = tio.read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if fmt is not None:
        assert tio.format_name(path) == fmt
    return 1


def both_fail(path, names):
    """PIL fails on the file; the port raises a ValueError naming PIL."""
    with pytest.raises(Exception):
        pil(path)
    with pytest.raises(ValueError, match=names):
        tio.read_image(path)
    return 1


def same_or_both_fail(path):
    """One random file: 'equal' or 'both fail'."""
    try:
        want = pil(path)
    except Exception:
        want = None
    try:
        got = tio.read_image(path)
    except ValueError as e:
        assert want is None, f"PIL reads it; the port raises {e}"
        return "both fail"
    assert want is not None, "the port reads a file PIL fails on"
    np.testing.assert_array_equal(got, want)
    return "equal"


def put(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


# --------------------------------------------------------------- writers
def pcx(version, bits, planes, w, h, body, stride=None, pal16=None, x0=0, y0=0, tail=b""):
    """A PCX: the 128-byte header, the body as given, then ``tail``."""
    st = (w * bits + 7) // 8
    stride = st + st % 2 if stride is None else stride
    pal16 = bytes(range(48)) if pal16 is None else pal16
    head = (bytes([10, version, 1, bits]) + struct.pack("<6H", x0, y0, x0 + w - 1, y0 + h - 1,
                                                        72, 72)
            + pal16 + b"\0" + bytes([planes]) + struct.pack("<H", stride) + b"\0" * 60)
    return head + body + tail


def pcx_rle(lines: bytes, line: int) -> bytes:
    """PCX run-length packets, runs within each line of ``line`` bytes."""
    out = bytearray()
    for y in range(0, len(lines), line):
        row = lines[y:y + line]
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 63 and row[j] == row[i]:
                j += 1
            if j - i > 1 or row[i] >= 0xC0:
                out += bytes([0xC0 | (j - i), row[i]])
                i = j
            else:
                out.append(row[i])
                i += 1
    return bytes(out)


def sgi(comp, bpc, dim, w, h, z, body):
    return struct.pack(">hBBHHHH", 474, comp, bpc, dim, w, h, z) + bytes(500) + body


def sgi_rle(planes: np.ndarray, bpc: int, runs=(1, 127), rng=None, end=True) -> bytes:
    """SGI RLE of (z, h, w) samples, rows as stored (bottom first): the
    offset and length tables, then each row's packets and a 0 packet."""
    rng = rng or np.random.default_rng(0)
    z, h, w = planes.shape
    rows = []
    for c in range(z):
        for y in range(h):
            row, out, x = planes[c, y].tolist(), bytearray(), 0
            while x < w:
                n = int(min(w - x, rng.integers(*runs)))
                same = len(set(row[x:x + n])) == 1
                vals = row[x:x + 1] if same else row[x:x + n]
                out += (bytes([0, n if same else 0x80 | n]) if bpc == 2
                        else bytes([n if same else 0x80 | n]))
                out += b"".join(int(v).to_bytes(bpc, "big") for v in vals)
                x += n
            rows.append(bytes(out) + (bytes(bpc) if end else b""))
    n = z * h
    starts, off = [], 512 + 8 * n
    for r in rows:
        starts.append(off)
        off += len(r)
    return (struct.pack(f">{n}I", *starts) + struct.pack(f">{n}I", *map(len, rows))
            + b"".join(rows))


def sun(w, h, depth, ftype, body, cmap=b"", cmap_type=1):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       cmap_type if cmap else 0, len(cmap)) + cmap + body


def sun_rle(raw: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 256:
            j += 1
        if j - i >= 3 or raw[i] == 0x80:
            out += b"\x80\x00" if (j - i == 1) else bytes([0x80, j - i - 1, raw[i]])
            i = j if not (j - i == 1) else i + 1
        else:
            out.append(raw[i])
            i += 1
    return bytes(out)


def msp2(w, h, rows, checksum=True):
    words = [0x694C, 0x536E, w, h, 1, 1, 1, 1, w, h, 0, 0, 0, 0, 0, 0]
    if checksum:
        for v in words[:12] + words[13:]:
            words[12] ^= v
    return (struct.pack("<16H", *words) + struct.pack(f"<{h}H", *map(len, rows))
            + b"".join(rows))


def msp_row(raw: bytes, rng) -> bytes:
    out, i = bytearray(), 0
    while i < len(raw):
        n = int(min(len(raw) - i, rng.integers(1, 6)))
        if len(set(raw[i:i + n])) == 1:
            out += bytes([0, n, raw[i]])
        else:
            out += bytes([n]) + raw[i:i + n]
        i += n
    return bytes(out)


def xbm(w, h, values, lead="", hotspot=False, fmt="0x%02x"):
    hot = "#define im_x_hot 3\n#define im_y_hot 4\n" if hotspot else ""
    body = ", ".join(fmt % v for v in values)
    return (f"{lead}#define im_width {w}\n#define im_height {h}\n{hot}"
            f"static char im_bits[] = {{\n{body}\n}};\n").encode()


def xpm(w, h, colours, rows, cpp=1, pixels_comment=False):
    lines = ["/* XPM */", "static char *image[] = {", "/* w h colours cpp */",
             f'"{w} {h} {len(colours)} {cpp}",']
    lines += [f'"{k} c {c}",' for k, c in colours]
    if pixels_comment:
        lines.append("/* pixels */")
    lines += [f'"{r}",' for r in rows]
    return ("\n".join(lines) + "\n};\n").encode()


def im(kind, w, h, body, lut=None, extra=(), sep="\r\n"):
    """An IM file: ``Image type: {kind} image`` and size, padded to 512
    bytes with a final ``\\x1a``, then a 768-byte Lut if given, the body."""
    lines = [f"Image type: {kind} image", f"Image size (x*y): {w}*{h}", *extra]
    if lut is not None:
        lines.append("Lut: 1")
    head = (sep.join(lines) + sep).encode()
    return head + b"\0" * (511 - len(head)) + b"\x1a" + (lut or b"") + body


# ------------------------------------------------------------------ QOI
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi_from_pil(tmp_path, mode):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "a.qoi")
    checked = 0
    for h, w, noise in ((1, 1, 0), (23, 37, 0.3), (40, 64, 0.02)):
        img = _pattern(h, w, noise=noise)
        if noise == 0.02:
            img = img // 32 * 32  # runs and index hits
        a = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        a[: h // 2] = 255
        Image.fromarray(np.concatenate([img, a], -1) if mode == "RGBA" else img).save(path)
        checked += check(path, "QOI")
    assert checked == 3


def test_qoi_built_by_hand(tmp_path):
    """Channels other than 3 open as RGBA; an INDEX of an empty slot gives
    (0, 0, 0, 0) and is put back in the index; a run past the end and no
    end marker are fine; a file that ends inside the ops raises."""
    path = str(tmp_path / "b.qoi")

    def qoi(w, h, ops, channels=3):
        return b"qoif" + struct.pack(">II", w, h) + bytes([channels, 0]) + bytes(ops)

    cases = [qoi(4, 1, [0x05, 0xFE, 10, 20, 30, 0x35, 0xC4]),
             qoi(3, 2, [0xFF, 1, 2, 3, 4, 0x6A, 0xA0, 0x88, 0x00, 0xC0, 0x07], channels=0),
             qoi(2, 2, [0xFE, 200, 100, 50, 0x54, 0xC3, 0, 0, 0, 0, 0, 0, 0, 1], channels=4)]
    checked = sum(check(put(path, data), "QOI") for data in cases)
    failed = sum(both_fail(put(path, data), r"truncated QOI data")
                 for data in (cases[0][:16], qoi(5, 5, [0xFE, 1, 2]), qoi(2, 1, [0xFF, 1, 2, 3])))
    assert (checked, failed) == (3, 3)


def test_random_qoi_streams_match_pil(tmp_path):
    """300 random op streams (headers of 3, 4 and 0 channels): equal where
    both read, both fail otherwise."""
    rng = np.random.default_rng(2)
    path = str(tmp_path / "r.qoi")
    outcome = {"equal": 0, "both fail": 0}
    for _ in range(300):
        w, h = (int(v) for v in rng.integers(1, 9, 2))
        ops = rng.integers(0, 256, int(rng.integers(0, 50))).astype(np.uint8).tobytes()
        put(path, b"qoif" + struct.pack(">II", w, h) + bytes([int(rng.choice([3, 4, 0])), 1]) + ops)
        outcome[same_or_both_fail(path)] += 1
    assert outcome["equal"] > 200 and outcome["both fail"] > 20, outcome


# ------------------------------------------------------------------ PCX
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_pcx_from_pil(tmp_path, mode):
    path = str(tmp_path / "a.pcx")
    checked = 0
    for h, w in ((1, 2), (17, 23), (30, 64)):  # PIL fails on its own RGB PCX 1 pixel wide
        img = Image.fromarray(_pattern(h, w, noise=0.3))
        img = {"1": img.convert("1"), "L": img.convert("L"), "P": img.quantize(60),
               "RGB": img}[mode]
        img.save(path, format="PCX")
        checked += check(path, "PCX")
    assert checked == 3


def test_pcx_built_by_hand(tmp_path):
    """1-bit planes (2 and 4) with the header's palette at their stride and
    at another one; 8-bit grey without a trailing palette, with a grey-ramp
    one (L) and with a colour one (P); a window off the origin; RGB with an
    odd stride the header states; DCX's first page, its palette at the
    file's end."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "b.pcx")
    checked = 0
    for planes in (2, 4):
        for w, stride in ((13, None), (13, 2), (16, 3), (3, 2)):
            st = (w + 7) // 8
            line = planes * (stride if stride is not None else st + st % 2)
            raw = rng.integers(0, 256, line * 5).astype(np.uint8).tobytes()
            data = pcx(int(rng.choice([0, 2, 5])), 1, planes, w, 5, pcx_rle(raw, line), stride,
                       pal16=rng.integers(0, 256, 48).astype(np.uint8).tobytes())
            checked += check(put(path, data), "PCX")
    raw = rng.integers(0, 256, 10 * 30).astype(np.uint8).tobytes()
    ramp = b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    colour = b"\x0c" + rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    for tail in (bytes(800), ramp, colour):
        checked += check(put(path, pcx(5, 8, 1, 30, 10, pcx_rle(raw, 30), tail=tail,
                                       x0=7, y0=3)), "PCX")
    raw = rng.integers(0, 256, 3 * 8 * 4).astype(np.uint8).tobytes()
    for stride in (7, 8, 9):
        body = pcx_rle(rng.integers(0, 256, 3 * stride * 4).astype(np.uint8).tobytes(),
                       3 * stride)
        checked += check(put(path, pcx(5, 8, 3, 7, 4, body, stride)), "PCX")
    page = pcx(5, 8, 1, 6, 3, pcx_rle(raw[:18], 6))
    dcx = struct.pack("<III", 0x3ADE68B1, 16, 16 + len(page)) + b"\0\0\0\0" + page + page
    checked += check(put(path, dcx + colour), "DCX")
    assert checked == 15


def test_pcx_refused_as_pil_fails(tmp_path):
    """2- and 4-bit single planes, 8 bits in 4 planes, 8 bits outside
    version 5, a run past a line's end, an 8-bit file shorter than its
    palette and a file that ends early: PIL fails on each."""
    path = str(tmp_path / "c.pcx")
    body = bytes(range(1, 100)) * 12
    cases = {r"unknown PCX mode": [pcx(5, 2, 1, 8, 4, body), pcx(5, 4, 1, 8, 4, body),
                                   pcx(5, 8, 4, 8, 4, body), pcx(3, 8, 1, 8, 4, body)],
             r"PCX run past a line's end": [pcx(5, 8, 3, 6, 2, b"\xff\x01" + bytes(900))],
             r"shorter than its palette": [pcx(5, 8, 1, 6, 2, bytes(12))],
             r"truncated PCX data": [pcx(5, 8, 3, 60, 40, bytes(1000))]}
    failed = sum(both_fail(put(path, d), names) for names, ds in cases.items() for d in ds)
    Image.new("RGB", (1, 3), (9, 99, 199)).save(path, format="PCX")  # stride 2 for 1 byte
    failed += both_fail(path, r"truncated PCX data")
    assert failed == 8


def test_random_pcx_match_pil(tmp_path):
    """400 PCX and DCX files drawn over versions, bits and planes, strides
    and bodies (RLE or not, cut short or not): equal where both read, both
    fail otherwise."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / "r.pcx")
    outcome = {"equal": 0, "both fail": 0}
    for i in range(400):
        bits, planes = [(1, 1), (1, 2), (1, 4), (8, 1), (8, 3), (4, 1), (8, 4)][i % 7]
        w, h = (int(v) for v in rng.integers(1, 20, 2))
        st = (w * bits + 7) // 8
        stride = int(rng.choice([st, st + st % 2, st + 1]))
        raw = rng.integers(0, 256, planes * stride * h).astype(np.uint8).tobytes()
        body = pcx_rle(raw, planes * stride) if rng.random() < 0.8 else raw[:len(raw) // 2]
        tail = b""
        if rng.random() < 0.5:
            tail = b"\x0c" + rng.integers(0, 256, 768).astype(np.uint8).tobytes()
        data = pcx(int(rng.choice([0, 2, 3, 5])), bits, planes, w, h, body, stride, tail=tail)
        if rng.random() < 0.15:
            data = data[:int(rng.integers(0, len(data)))]
        if rng.random() < 0.1:
            data = struct.pack("<III", 0x3ADE68B1, 12, 0) + data
        outcome[same_or_both_fail(put(path, data))] += 1
    assert outcome["equal"] > 120 and outcome["both fail"] > 40, outcome


# ------------------------------------------------------------------ SGI
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_sgi_from_pil(tmp_path, mode, bpc):
    path = str(tmp_path / "a.sgi")
    checked = 0
    for h, w in ((1, 1), (1, 9), (17, 23)):
        img = Image.fromarray(_pattern(h, w, noise=0.3)).convert(mode)
        img.save(path, format="SGI", bpc=bpc)
        checked += check(path, "SGI")
    assert checked == 3


@pytest.mark.parametrize("bpc", [1, 2])
def test_sgi_rle_built_by_hand(tmp_path, bpc):
    """RLE in 1 (dimensions 1 and 2), 3 and 4 channels with runs and
    copies, the high byte of 16-bit samples; rows whose 0 packet comes
    before the width keep the previous row's samples in PIL's buffer; a row
    whose last allowed packet is not 0 stops PIL's whole image there."""
    rng = np.random.default_rng(5 + bpc)
    path = str(tmp_path / "b.sgi")
    checked = 0
    for dim, z in ((1, 1), (2, 1), (3, 3), (3, 4)):
        h = 1 if dim == 1 else 6
        planes = rng.integers(0, 1 << (8 * bpc), (z, h, 11))
        planes[:, :, 3:7] = planes[:, :, 3:4]
        checked += check(put(path, sgi(1, bpc, dim, 11, h, z, sgi_rle(planes, bpc, rng=rng))),
                         "SGI")
    planes = rng.integers(0, 1 << (8 * bpc), (1, 4, 8))
    data = bytearray(sgi(1, bpc, 2, 8, 4, 1, sgi_rle(planes, bpc, runs=(8, 9), rng=rng)))
    row2 = struct.unpack_from(">I", data, 512 + 8)[0]
    data[row2 + bpc - 1] = 3  # row 2 ends after 3 pixels: the rest stays from row 1
    data[row2 + 3 * bpc - 1] = 0  # the next packet: the row's end
    checked += check(put(path, bytes(data)), "SGI")
    data = bytearray(sgi(1, bpc, 2, 8, 4, 1, sgi_rle(planes, bpc, runs=(8, 9), rng=rng)))
    struct.pack_into(">I", data, 512 + 16 + 4 * 2, 1)  # row 2's length: one packet
    checked += check(put(path, bytes(data)), "SGI")
    assert checked == 6


def test_sgi_refused_as_pil_fails(tmp_path):
    path = str(tmp_path / "c.sgi")
    planes = np.arange(2 * 3 * 4).reshape(2, 3, 4)
    cases = {r"unsupported SGI image mode": [sgi(0, 1, 3, 4, 3, 2, bytes(24)),
                                             sgi(0, 1, 3, 4, 3, 1, bytes(12))],
             r"SGI storage 2": [sgi(2, 1, 2, 4, 3, 1, bytes(12))],
             r"buffer overrun": [sgi(1, 1, 2, 4, 3, 1, bytes(12)),
                                 sgi(1, 1, 2, 4, 3, 1, struct.pack(">6I", 0, 0, 0, 1, 1, 1))],
             r"truncated SGI data": [sgi(0, 2, 2, 4, 3, 1, bytes(20))]}
    failed = sum(both_fail(put(path, d), names) for names, ds in cases.items() for d in ds)
    del planes
    assert failed == 6


def test_random_sgi_match_pil(tmp_path):
    """500 SGI files over storage, depth, dimension and channels, with RLE
    tables broken at random and files cut short: equal where both read,
    both fail otherwise."""
    rng = np.random.default_rng(6)
    path = str(tmp_path / "r.sgi")
    outcome = {"equal": 0, "both fail": 0}
    for i in range(500):
        bpc = int(rng.choice([1, 2]))
        dim, z = [(1, 1), (2, 1), (3, 3), (3, 4), (3, 2)][i % 5]
        w, h = (int(v) for v in rng.integers(1, 12, 2))
        planes = rng.integers(0, 1 << (8 * bpc), (z, h, w))
        comp = int(rng.choice([0, 1, 1, 2]))
        if comp == 1:
            body = bytearray(sgi_rle(planes, bpc, rng=rng, end=rng.random() < 0.8))
            for _ in range(int(rng.integers(0, 3))):
                k = int(rng.integers(0, 8 * z * h))
                body[k] = int(rng.integers(0, 256))
            body = bytes(body)
        else:
            body = b"".join(int(v).to_bytes(bpc, "big") for v in planes.reshape(-1))
        data = sgi(comp, bpc, dim, w, h, z, body)
        if rng.random() < 0.15:
            data = data[:int(rng.integers(0, len(data)))]
        outcome[same_or_both_fail(put(path, data))] += 1
    assert outcome["equal"] > 120 and outcome["both fail"] > 50, outcome


# ------------------------------------------------------------- Sun raster
@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
def test_sun_built_by_hand(tmp_path, depth):
    """Types 0-5 (raw rows padded to 16 bits; type 2 RLE, unpadded, runs
    across rows, an escaped 0x80; type 3 RGB order), with a colour map of
    several lengths at 4 and 8 bits."""
    rng = np.random.default_rng(7 + depth)
    path = str(tmp_path / "a.ras")
    checked = 0
    w, h = 13, 5
    for ftype in range(6):
        line = (w * depth + 7) // 8 if ftype == 2 else (w * depth + 15) // 16 * 2
        raw = rng.integers(0, 256, line * h).astype(np.uint8)
        raw[1:len(raw) // 3] = 0x80
        raw[len(raw) // 2:] = raw[-1]
        body = sun_rle(raw.tobytes()) if ftype == 2 else raw.tobytes()
        maps = [b""] + ([rng.integers(0, 256, n).astype(np.uint8).tobytes() for n in (6, 48, 768)]
                        if depth in (4, 8) else [])
        for cmap in maps:
            checked += check(put(path, sun(w, h, depth, ftype, body, cmap)), "SUN")
    assert checked == (24 if depth in (4, 8) else 6)


def test_sun_refused_or_passed_on(tmp_path):
    """A colour map at 24 bits: PIL fails; a truncated raster: PIL fails;
    type 6, depth 16, a map of type 2: PIL passes the file on and nothing
    else takes it."""
    path = str(tmp_path / "b.ras")
    body = bytes(range(200)) * 3
    failed = both_fail(put(path, sun(4, 4, 24, 1, body, b"\0" * 6)), r"SUN colour map at 24")
    failed += both_fail(put(path, sun(40, 4, 24, 1, body[:300])), r"truncated SUN data")
    failed += both_fail(put(path, sun(40, 4, 8, 2, b"\x80\x05")), r"truncated SUN RLE")
    for data in (sun(4, 4, 8, 6, body), sun(4, 4, 16, 1, body), sun(4, 4, 8, 1, body, b"\0" * 6,
                                                                        cmap_type=2)):
        failed += both_fail(put(path, data), r"cannot identify")
    assert failed == 6


# ------------------------------------------------------------------ MSP
def test_msp_v1_from_pil_and_v2_built_by_hand(tmp_path):
    """PIL's version 1; version 2 with runs and literals, blank (0-length)
    rows, rows that decode to more or fewer bytes than a row (the rows
    after them shift, as in PIL)."""
    rng = np.random.default_rng(9)
    path = str(tmp_path / "a.msp")
    checked = 0
    for h, w in ((1, 1), (17, 23), (30, 64)):
        Image.fromarray(_pattern(h, w, noise=0.3)).convert("1").save(path, format="MSP")
        checked += check(path, "MSP")
    for w, h in ((23, 9), (64, 5), (5, 12)):
        stride = (w + 7) // 8
        rows = [msp_row(rng.integers(0, 256, stride).astype(np.uint8).tobytes(), rng)
                for _ in range(h)]
        rows[1] = b""
        checked += check(put(path, msp2(w, h, rows)), "MSP")
        rows[2] = rows[2] + bytes([2, 7, 9])
        rows[3] = bytes([1, 0xAB])
        rows[-1] = rows[-1] + bytes([0, 30, 5])
        checked += check(put(path, msp2(w, h, rows)), "MSP")
    assert checked == 9


def test_msp_refused_as_pil_fails(tmp_path):
    path = str(tmp_path / "b.msp")
    rows = [bytes([2, 1, 2])] * 4
    failed = both_fail(put(path, msp2(16, 4, rows)[:-2]), r"truncated MSP file")
    failed += both_fail(put(path, msp2(16, 4, rows)[:36]), r"row map")
    failed += both_fail(put(path, msp2(16, 4, [bytes([1, 2])] * 4)), r"truncated MSP data")
    failed += both_fail(put(path, msp2(16, 4, [bytes([0, 1])] * 4)), r"corrupted MSP file")
    assert failed == 4


# ------------------------------------------------------------------ XBM
@pytest.mark.parametrize("hotspot", [False, True])
def test_xbm_from_pil(tmp_path, hotspot):
    path = str(tmp_path / "a.xbm")
    checked = 0
    for h, w in ((1, 1), (17, 23), (30, 64)):
        img = Image.fromarray(_pattern(h, w, noise=0.3)).convert("1")
        img.save(path, format="XBM", **({"hotspot": (1, 2)} if hotspot else {}))
        checked += check(path, "XBM")
    assert checked == 3


def test_xbm_built_by_hand(tmp_path):
    """Leading whitespace; upper-case hex digits; one-digit values (PIL
    takes the character after the digit as a 0 digit); an XBM whose values
    run out, or written ``0X`` (PIL looks for a lower-case x), raises as PIL
    fails; without ``_bits[]`` PIL passes the file on."""
    rng = np.random.default_rng(10)
    path = str(tmp_path / "b.xbm")
    vals = rng.integers(0, 256, 2 * 7)
    checked = check(put(path, xbm(13, 7, vals, lead=" \n\t")), "XBM")
    checked += check(put(path, xbm(13, 7, vals, fmt="0x%02X")), "XBM")
    checked += check(put(path, xbm(13, 7, vals % 16, fmt="0x%x")), "XBM")
    failed = both_fail(put(path, xbm(13, 7, vals[:-3])), r"truncated XBM data")
    failed += both_fail(put(path, xbm(13, 7, vals, fmt="0X%02x")), r"truncated XBM data")
    failed += both_fail(put(path, xbm(13, 7, vals).replace(b"_bits", b"_bats")),
                        r"cannot identify")
    assert (checked, failed) == (3, 3)


# ------------------------------------------------------------------ XPM
def test_xpm_built_by_hand(tmp_path):
    """One and two characters a pixel, ``s`` keys before ``c``, ``None``
    (unused), #rgb and #rrrrggggbbbb values, a ``/* pixels */`` line, rows
    split across lines, and 300 colours (RGB)."""
    rng = np.random.default_rng(11)
    path = str(tmp_path / "a.xpm")
    colours = [(".", "None"), ("a", "#ff0000"), ("b", "#0f8"), ("c", "#123456789abc"),
               ("d s name", "#00ff00")]
    rows = ["abcd" * 3, "dcba" * 3, "abab" * 3]
    checked = check(put(path, xpm(12, 3, colours, rows, pixels_comment=True)), "XPM")
    checked += check(put(path, xpm(12, 3, colours, ["abcdabcdabcdabcd", "abcdabcd",
                                                    "dddddddddddd"])), "XPM")
    keys = [chr(48 + i // 60) + chr(60 + i % 60) for i in range(300)]
    cols = [(k, "#%06x" % int(rng.integers(0, 1 << 24))) for k in keys]
    rows = ["".join(rng.choice(keys, 9)) for _ in range(6)]
    checked += check(put(path, xpm(9, 6, cols, rows, cpp=2)), "XPM")
    assert checked == 3


def test_xpm_refused_as_pil_fails(tmp_path):
    path = str(tmp_path / "b.xpm")
    colours = [(".", "None"), ("a", "#ff0000")]
    failed = both_fail(put(path, xpm(2, 1, [("a", "red")], ["aa"])), r"not #rgb hex or None")
    failed += both_fail(put(path, xpm(2, 1, colours, ["a."])), r"not in the palette")
    failed += both_fail(put(path, xpm(3, 2, colours, ["aaa"])), r"not enough image data")
    failed += both_fail(put(path, xpm(2, 1, [("a", "#zz")], ["aa"])), r"XPM colour")
    assert failed == 4


# ------------------------------------------------------------------- IM
IM_FROM_PIL = ["1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B", "F", "RGB", "RGBA",
               "RGBX", "CMYK", "YCbCr"]


@pytest.mark.parametrize("mode", IM_FROM_PIL)
def test_im_from_pil(tmp_path, mode):
    rng = np.random.default_rng(12)
    path = str(tmp_path / "a.im")
    checked = 0
    for h, w in ((1, 1), (17, 23)):
        img = Image.fromarray(_pattern(h, w, noise=0.3))
        if mode in ("P", "PA"):
            img = img.quantize(40).convert(mode)
        elif mode == "I":
            img = Image.fromarray(rng.integers(-300, 600, (h, w)).astype(np.int32))
        elif mode.startswith("I;16"):
            img = Image.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16)).convert(mode)
        elif mode == "F":
            img = Image.fromarray((rng.standard_normal((h, w)) * 200 + 100).astype(np.float32))
        else:
            img = img.convert(mode)
        img.save(path, format="IM")
        checked += check(path, "IM")
    assert checked == 2


def test_im_built_by_hand(tmp_path):
    """Types PIL reads but does not write: the bit decoder at 4, 12 and 24
    bits, signed and unsigned 8/16/32-bit floats, 2- and 4-bit palettes
    with and without a Lut, whole planes (RGB3), a grey non-linear Lut it
    ignores, a colour Lut on RGB it ignores, LF line ends, a comment."""
    rng = np.random.default_rng(13)
    path = str(tmp_path / "b.im")
    w, h = 7, 5
    checked = 0
    for kind, nbytes in (("L*4", 20), ("L*12", 55), ("L*24", 105), ("L 8S", 35), ("L 16S", 70),
                         ("L 32", 140), ("L 32 S", 140), ("B2", 10), ("B4", 20), ("RGB3", 105),
                         ("X 24", 105), ("L 32F", 140)):
        body = rng.integers(0, 256, nbytes + 3).astype(np.uint8)
        if kind == "L 32F":
            body = (rng.standard_normal(38) * 300).astype("<f4").view(np.uint8)
        checked += check(put(path, im(kind, w, h, body.tobytes())), "IM")
        if kind in ("B2", "B4"):  # a colour Lut makes PIL read 8-bit P samples
            lut = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
            checked += check(put(path, im(kind, w, h, bytes(range(w * h)), lut=lut)), "IM")
    grey = bytes(np.tile(rng.integers(0, 256, 256).astype(np.uint8), 3))
    body = rng.integers(0, 256, 3 * w * h).astype(np.uint8).tobytes()
    checked += check(put(path, im("Greyscale", w, h, body, lut=grey, sep="\n",
                                  extra=("Comment: made here",))), "IM")
    checked += check(put(path, im("RGB", w, h, body, lut=bytes(range(256)) * 3)), "IM")
    assert checked == 16


def test_im_refused_as_pil_fails(tmp_path):
    path = str(tmp_path / "c.im")
    body = bytes(200)
    failed = both_fail(put(path, im("PA", 4, 4, body)), r"PA image without a colour Lut")
    failed += both_fail(put(path, im("RLB", 4, 4, body)), r"no unpacker")
    failed += both_fail(put(path, im("foo", 4, 4, body)), r"fails to load it")
    failed += both_fail(put(path, im("RGB", 40, 4, body)), r"truncated IM data")
    failed += both_fail(put(path, im("L*12", 40, 40, body)), r"truncated IM data")
    failed += both_fail(put(path, im("L", 4, 4, body, extra=("Scale (x,y): a",))),
                        r"not a number")
    assert failed == 6
