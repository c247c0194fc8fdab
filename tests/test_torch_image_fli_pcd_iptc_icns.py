"""The port's FLI/FLC, Photo CD, IPTC/NAA and ICNS readers
(utils/image_fli.py, image_pcd.py, image_iptc.py, image_icns.py), and the
ICO opener's pass-on (utils/image_ico.py::open_entry), against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

- FLI: hand-built files (PIL writes none) whose first frame holds each
  sub-chunk type (colours of 8 and 6 bits, BRUN, LC, SS2 with its flag
  words, black, copy, postage stamp), a prefix chunk, a grey ramp without
  colours, and random chunk streams: equal to PIL where both read, both
  fail otherwise.
- PCD: random base images in all four orientations; a file cut short.
- IPTC: raw data in L and as a band of RGB and CMYK (the band numbers,
  0 meaning the last), JPEG data as an L image (in its own mode and size)
  and as a band; the failures PIL has.
- ICNS: PNG entries as PIL writes them, packed ``it32``, ``is32``,
  ``il32`` and ``ih32`` entries, raw and run-length coded, with masks,
  the entry PIL picks among several; a JPEG 2000 entry (read since the port
  reads JPEG 2000); broken channels and masks fail as in PIL.
- ICO: an entry whose load PIL takes for "not this format" passes the
  file on: to TGA (which PIL opens and fails to load, as the port does)
  or to PCD (which both read).
- ``make_fli_pcd_iptc_icns_inputs`` writes the committed FLC, PCD, IPTC
  and ICNS inputs of ``test_torch_image_formats.CHIP_INPUTS``.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_formats import _pattern
from test_torch_image_raster import both_fail, check, put, same_or_both_fail


# ------------------------------------------------------------------- FLI
def fli(width, height, frames, magic=0xAF12, prefix=None):
    """An FLC file: the 128-byte header, an optional prefix chunk, then the
    frames (each a list of (type, data) sub-chunks)."""
    body = b""
    if prefix is not None:
        body += struct.pack("<IHH", 8 + len(prefix), 0xF100, 0) + prefix
    for subs in frames:
        chunks = b"".join(struct.pack("<IH", 6 + len(d), t) + d for t, d in subs)
        body += struct.pack("<IHHHHHH", 16 + len(chunks), 0xF1FA, len(subs), 0, 0, 0, 0) + chunks
    head = struct.pack("<IHHHHHHI", 128 + len(body), magic, len(frames), width, height, 8, 0, 5)
    return head.ljust(128, b"\0") + body


def colours(packets, bits=8):
    """A COLOR_256 (or, with bits 6, COLOR_64) body: (skip, [(r, g, b)])."""
    out = struct.pack("<H", len(packets))
    for skip, rgb in packets:
        out += bytes([skip, len(rgb) & 255]) + bytes(np.asarray(rgb, np.uint8).reshape(-1))
    return out


def brun(rows: np.ndarray) -> bytes:
    """A BRUN body: per row a packet count byte, then runs of 3 or more
    equal bytes (positive counts) and literal stretches (negative)."""
    out = bytearray()
    for row in rows:
        line, i, n = bytearray([0]), 0, len(row)
        while i < n:
            j = i
            while j < n and row[j] == row[i] and j - i < 127:
                j += 1
            if j - i >= 3:
                line += bytes([j - i, row[i]])
                i = j
                continue
            j = i
            while j < n and j - i < 127 and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            line += bytes([256 - (j - i)]) + bytes(row[i:j])
            i = j
        out += line
    return bytes(out)


def lc(rows: np.ndarray, first: int) -> bytes:
    """An LC body over ``rows`` from line ``first``: per line the changed
    stretches as (skip, literal) packets, with one run packet per line."""
    out = bytearray(struct.pack("<HH", first, len(rows)))
    for row in rows:
        packets = [(2, bytes(row[2:6])), (3, None), (1, bytes(row[12:14]))]
        out.append(len(packets))
        x = 0
        for skip, lit in packets:
            if lit is None:
                out += bytes([skip, 256 - 4, row[x + skip]])
                x += skip + 4
            else:
                out += bytes([skip, len(lit)]) + lit
                x += skip + len(lit)
    return bytes(out)


def ss2(rows: np.ndarray) -> bytes:
    """An SS2 body: a line skip word, a last-byte word, word packets."""
    out = bytearray(struct.pack("<H", len(rows)))
    for k, row in enumerate(rows):
        if k == 1:
            out += struct.pack("<H", 0x10000 - 1)  # skip one line
        out += struct.pack("<H", 0x8000 | int(row[-1]))  # the line's last byte
        out += struct.pack("<H", 2) + bytes([2, 2]) + bytes(row[2:6])
        out += bytes([0, 256 - 2]) + bytes(row[6:8])
    return bytes(out)


def _fli_cases():
    rng = np.random.default_rng(20)
    w, h = 17, 9
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    img[:, 5:12] = 77  # runs
    pal = [(0, rng.integers(0, 256, (256, 3)))]
    pal6 = [(3, rng.integers(0, 64, (40, 3))), (10, rng.integers(0, 64, (5, 3)))]
    return {
        "BRUN, 8-bit colours": fli(w, h, [[(4, colours(pal)), (15, brun(img))]]),
        "BRUN, 6-bit colours": fli(w, h, [[(11, colours(pal6, 6)), (15, brun(img))]]),
        "copy, no colours (grey ramp)": fli(w, h, [[(16, img.tobytes())]]),
        "black then LC": fli(w, h, [[(4, colours(pal)), (13, b""), (12, lc(img[2:6], 2))]]),
        "copy then SS2": fli(w, h, [[(4, colours(pal)), (16, img.tobytes()),
                                     (7, ss2(img[:4, ::-1]))]]),
        "postage stamp and colours after BRUN": fli(w, h, [[(18, bytes(30)), (15, brun(img)),
                                                            (4, colours(pal))]]),
        "two frames, delta second": fli(w, h, [[(4, colours(pal)), (15, brun(img))],
                                               [(12, lc(img[::-1][:3], 1))]], magic=0xAF11),
        "colour packets past entry 255": fli(w, h, [[(4, colours([(250, [(1, 2, 3)] * 10)])),
                                                      (16, img.tobytes())]]),
        "prefix chunk": fli(w, h, [[(16, img.tobytes())]], prefix=bytes(20)),
        "unknown sub-chunk": fli(w, h, [[(16, img.tobytes()), (99, bytes(8))]]),
        "BRUN cut short": fli(w, h, [[(15, brun(img)[:-20])]]),
        "LC past the last line": fli(w, h, [[(12, lc(img[:4], 7))]]),
    }


FLI_CASES = _fli_cases()


@pytest.mark.parametrize("case", sorted(FLI_CASES))
def test_fli_first_frame_as_pil_reads_it(tmp_path, case):
    path = put(str(tmp_path / "f.flc"), FLI_CASES[case])
    outcome = same_or_both_fail(path)
    if case in ("prefix chunk", "unknown sub-chunk", "BRUN cut short", "LC past the last line"):
        assert outcome == "both fail"
    elif case == "colour packets past entry 255":  # PIL passes the file on: nothing takes it
        both_fail(path, "cannot identify image file")
    else:
        assert outcome == "equal" and tio.format_name(path) == "FLI"


def test_random_fli_chunks_match_pil_or_both_fail(tmp_path):
    rng = np.random.default_rng(21)
    outcomes = {"equal": 0, "both fail": 0}
    for i in range(150):
        w, h = int(rng.integers(1, 12)), int(rng.integers(1, 8))
        subs = []
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.choice([4, 7, 11, 12, 13, 15, 16, 18]))
            body = rng.integers(0, 256, int(rng.integers(0, 60)), dtype=np.uint8).tobytes()
            if kind == 15 and rng.random() < 0.5:
                body = brun(rng.integers(0, 4, (h, w), dtype=np.uint8))
            elif kind == 16 and rng.random() < 0.7:
                body = rng.integers(0, 256, w * h, dtype=np.uint8).tobytes()
            elif kind in (7, 12) and rng.random() < 0.5:
                body = struct.pack("<HH", 0, 1) + bytes([1, 0, 1, 5])
            subs.append((kind, body))
        path = put(str(tmp_path / f"{i}.flc"), fli(w, h, [subs]))
        outcomes[same_or_both_fail(path)] += 1
    assert outcomes["equal"] > 20 and outcomes["both fail"] > 20


# ------------------------------------------------------------------- PCD
def pcd(body: bytes, orientation=0) -> bytes:
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + body


def pcd_body(img: np.ndarray) -> bytes:
    """Row pairs of a 512 x 768 (H, W, 3) image: both rows' first channel
    as luma, then the second and third channel of the pair's first row at
    every other column as chroma."""
    out = bytearray()
    for k in range(256):
        pair = img[2 * k:2 * k + 2]
        out += pair[0, :, 0].tobytes() + pair[1, :, 0].tobytes()
        out += pair[0, ::2, 1].tobytes() + pair[0, ::2, 2].tobytes()
    return bytes(out)


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 0x81, 0xFE])
def test_pcd_base_image_in_each_orientation(tmp_path, orientation):
    rng = np.random.default_rng(22 + orientation)
    body = rng.integers(0, 256, 256 * 2304, dtype=np.uint8).tobytes()
    path = put(str(tmp_path / "f.pcd"), pcd(body, orientation))
    assert check(path, "PCD")
    assert tio.read_image(path).shape == ((768, 512, 3) if orientation & 1 else (512, 768, 3))


def test_pcd_cut_short_fails_as_in_pil(tmp_path):
    both_fail(put(str(tmp_path / "f.pcd"), pcd(bytes(2304 * 100))), "image file is truncated")


# ------------------------------------------------------------------ IPTC
def field(rec, tag, data: bytes, extended=False) -> bytes:
    if extended:  # a 4-byte size after the header
        return bytes([0x1C, rec, tag, 0x84, 0]) + struct.pack(">I", len(data)) + data
    return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data


def iptc(width, height, layers, component, compression, payload, band=None, split=1,
         extra=b""):
    out = (field(2, 5, b"a caption") + field(3, 60, bytes([layers, component]))
           + field(3, 20, struct.pack(">H", width)) + field(3, 30, struct.pack(">H", height))
           + field(3, 120, bytes([compression])) + extra)
    if band is not None:
        out += field(3, 65, bytes([band]))
    step = max(1, -(-len(payload) // split))
    for i in range(0, len(payload), step):  # the image data over several (8, 10) fields
        out += field(8, 10, payload[i:i + step], extended=i > 0)
    return out


def _jpeg(img, **kw) -> bytes:
    out = io.BytesIO()
    img.save(out, "JPEG", **kw)
    return out.getvalue()


def test_iptc_raw_and_jpeg_data_as_pil_reads_them(tmp_path):
    rng = np.random.default_rng(23)
    raw = rng.integers(0, 256, 7 * 5 + 9, dtype=np.uint8).tobytes()
    photo = Image.fromarray(_pattern(30, 44, noise=0.05, seed=24))
    rgbj, greyj = _jpeg(photo, quality=80), _jpeg(photo.convert("L"), quality=80)
    files = {"raw L": iptc(7, 5, 1, 0, 1, raw, split=3),
             "raw band of RGB (default 1)": iptc(7, 5, 3, 1, 1, raw),
             "raw band 2 of RGB": iptc(7, 5, 3, 1, 1, raw, band=2),
             "raw band 0 (the last) of RGB": iptc(7, 5, 3, 1, 1, raw, band=0),
             "raw band 3 of CMYK": iptc(7, 5, 4, 1, 1, raw, band=3),
             "raw band 4 of CMYK": iptc(7, 5, 4, 1, 1, raw, band=4),
             "RGB JPEG as L, its own size": iptc(7, 5, 1, 0, 5, rgbj, split=2),
             "grey JPEG as L": iptc(44, 30, 1, 0, 5, greyj),
             "grey JPEG as band 2 of RGB": iptc(44, 30, 3, 1, 5, greyj, band=2),
             "grey JPEG as band 1 of CMYK": iptc(44, 30, 4, 1, 5, greyj, band=1)}
    for name, data in files.items():
        assert check(put(str(tmp_path / "f.iim"), data), "IPTC"), name
    fails = {"truncated": iptc(7, 5, 1, 0, 1, raw[:30]),
             "mode mismatch": iptc(44, 30, 3, 1, 5, rgbj),
             "band 5": iptc(7, 5, 3, 1, 1, raw, band=5),
             "unknown IPTC image compression": iptc(7, 5, 1, 0, 2, raw),
             "cannot load this image": iptc(7, 5, 1, 0, 1, b"") + bytes(5)}
    for names, data in fails.items():
        both_fail(put(str(tmp_path / "g.iim"), data), names)
    # no mode (two layers): PIL passes the file on and nothing takes it
    both_fail(put(str(tmp_path / "h.iim"), iptc(7, 5, 2, 1, 1, raw)), "cannot identify")


# ------------------------------------------------------------------ ICNS
def rle_channel(v: bytes) -> bytes:
    """ICNS run-length coding: runs of 3-130 as (0x80 + n - 3, byte),
    literal stretches of up to 128 as (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(v)
    while i < n:
        j = i
        while j < n and v[j] == v[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            out += bytes([0x80 + j - i - 3, v[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + v[i:j]
        i = j
    return bytes(out)


def packed(img: np.ndarray, rle=True, t=False) -> bytes:
    body = b"".join(rle_channel(img[:, :, c].tobytes()) for c in range(3)) if rle else (
        img.reshape(-1).tobytes())
    return (bytes(4) if t else b"") + body


def icns(blocks) -> bytes:
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d for t, d in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def _png(img) -> bytes:
    out = io.BytesIO()
    Image.fromarray(img).save(out, "PNG")
    return out.getvalue()


def test_icns_entries_as_pil_reads_them(tmp_path):
    rng = np.random.default_rng(25)
    p128 = _pattern(128, 128, noise=0.03, seed=26)
    p128[40:60] = 90  # runs
    p48, p32, p16 = (_pattern(s, s, noise=0.1, seed=s) for s in (48, 32, 16))
    mask128 = rng.integers(0, 256, 128 * 128, dtype=np.uint8).tobytes()
    pal_png = io.BytesIO()
    Image.fromarray(_pattern(256, 256, noise=0.05, seed=28)).quantize(50).save(
        pal_png, "PNG", transparency=3)
    files = {
        "it32 with its mask": icns([(b"it32", packed(p128, t=True)), (b"t8mk", mask128)]),
        "is32 raw": icns([(b"is32", packed(p16, rle=False)), (b"s8mk", bytes(256))]),
        "il32 over is32": icns([(b"is32", packed(p16)), (b"il32", packed(p32))]),
        "ih32 over ic12 (48 > 32)": icns([(b"ic12", _png(_pattern(64, 64, seed=3))),
                                          (b"ih32", packed(p48))]),
        "ic07 PNG wins over it32": icns([(b"it32", packed(p128, t=True)),
                                         (b"ic07", _png(p128[::-1]))]),
        "ic08 PNG, a palette": icns([(b"is32", packed(p16)), (b"ic08", pal_png.getvalue())]),
        "icp4 PNG of half the size": icns([(b"icp4", _png(p16[::2, ::2]))]),
    }
    path = str(tmp_path / "pil.icns")
    Image.fromarray(_pattern(64, 64, seed=27)).save(path)
    assert check(path, "ICNS")
    for name, data in files.items():
        assert check(put(str(tmp_path / "f.icns"), data), "ICNS"), name
    fails = {"channel": icns([(b"is32", packed(p16)[:-40])]),
             "signature": icns([(b"it32", b"\1\2\3\4" + packed(p128))]),
             "mask": icns([(b"is32", packed(p16)), (b"s8mk", bytes(100))]),
             "subimage format": icns([(b"ic07", b"not a picture at all")]),
             "only a mask": icns([(b"is32", packed(p16)), (b"t8mk", mask128)])}
    for names, data in fails.items():
        p = put(str(tmp_path / "g.icns"), data)
        with pytest.raises(Exception):
            Image.open(p).convert("RGB")
        with pytest.raises(ValueError, match=names):
            tio.read_image(p)
    both_fail(put(str(tmp_path / "h.icns"), icns([(b"zzzz", b"x")])), "cannot identify")


def test_icns_jpeg2000_entry_raises_by_name(tmp_path):
    """A JPEG 2000 entry, refused until the port read JPEG 2000, now reads
    as PIL reads it (more in test_torch_image_jpeg2000_streams.py)."""
    j2k = io.BytesIO()
    Image.fromarray(_pattern(32, 32, seed=29)).save(j2k, "JPEG2000")
    path = put(str(tmp_path / "f.icns"), icns([(b"is32", packed(_pattern(16, 16))),
                                               (b"icp5", j2k.getvalue())]))
    check(path, "ICNS")


# ------------------------------------------------------- ICO pass-on
def _ico(entry: bytes, bpp=24, size=None) -> bytes:
    size = len(entry) if size is None else size
    return b"\0\0\1\0\1\0" + bytes([4, 4, 0, 0]) + struct.pack("<HHII", 1, bpp, size, 22) + entry


def _dib(w, h, extra=bytes(200), bits=24, compression=0) -> bytes:
    return struct.pack("<IiiHHI", 40, w, h, 1, bits, compression) + bytes(20) + extra


def _chunk(t, body, crc=None):
    return struct.pack(">I", len(body)) + t + body + struct.pack(
        ">I", zlib.crc32(t + body) if crc is None else crc)


def test_ico_entry_that_fails_to_load_passes_the_file_on(tmp_path):
    """PIL's ICO opener loads its entry; an error ``Image.open`` takes for
    "not this format" sends the file to the next opener. Such an ICO's
    first 18 bytes are a TGA header of image type 1 without a colour map,
    which PIL opens as TGA and then fails to load (as the port does); with
    a PCD marker at byte 2048 and a base image, PCD reads it first."""
    size = 8 << 16 | 16  # as TGA: height 16, depth 8
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)
    bad = {"DIB of width 0": _ico(_dib(0, 8), size=size),
           "DIB of height 0": _ico(_dib(4, 0), size=size),
           "DIB bitfield masks past the file": _ico(_dib(4, 8, b"", compression=3), size=size),
           "PNG with a bad CRC": _ico(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr, crc=1),
                                      size=size),
           "PNG chunk name not a name": _ico(b"\x89PNG\r\n\x1a\n" + _chunk(b"IH R", ihdr),
                                             size=size),
           "PNG of no mode": _ico(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr[:8] + bytes(
               [3, 2, 0, 0, 0])), size=size)}
    body = np.random.default_rng(30).integers(0, 256, 256 * 2304, dtype=np.uint8).tobytes()
    for name, data in bad.items():
        path = put(str(tmp_path / "f.ico"), data)
        assert tio.format_name(path) == "TGA", name
        both_fail(path, "TGA")
        path = put(str(tmp_path / "g.ico"), data.ljust(2048, b"\0") + b"PCD_"
                   + pcd(body)[2052:])
        if name == "DIB bitfield masks past the file":  # the padding gives masks: a bad layout
            both_fail(path, "bitfields")
        else:
            assert check(path, "PCD"), name
    ends = {"Truncated File Read": _ico(_dib(4, 8)[:20]),
            "header of 20 bytes": _ico(struct.pack("<I", 20) + bytes(60)),
            "of 7 bits": _ico(_dib(4, 8, bits=7))}
    for names, data in ends.items():
        both_fail(put(str(tmp_path / "h.ico"), data), names)


# ------------------------------------------------------ committed inputs
def make_fli_pcd_iptc_icns_inputs(d: str) -> None:
    """Write these inputs of ``test_torch_image_formats.CHIP_INPUTS`` into ``d``."""
    quant = Image.fromarray(_pattern(200, 320, noise=0.0, seed=70)).quantize(256)
    idx = np.asarray(quant)
    pal = np.asarray(quant.getpalette()[:768], np.uint8).reshape(-1, 3)
    second = idx[::-1][:40]
    with open(os.path.join(d, "photo_brun.flc"), "wb") as f:
        f.write(fli(320, 200, [[(4, colours([(0, pal)])), (15, brun(idx))],
                               [(12, lc(second, 10))]]))
    img = _pattern(512, 768, noise=0.02, seed=71)
    with open(os.path.join(d, "photo_turned.pcd"), "wb") as f:
        f.write(pcd(pcd_body(img), orientation=1))
    jpeg = _jpeg(Image.fromarray(_pattern(120, 160, noise=0.02, seed=72)), quality=90)
    with open(os.path.join(d, "photo_jpeg.iim"), "wb") as f:
        f.write(iptc(160, 120, 1, 0, 5, jpeg, split=2))
    p128 = _pattern(128, 128, noise=0.0, seed=73)
    p128[::16] = 255  # runs
    mask = np.full(128 * 128, 200, np.uint8).tobytes()
    with open(os.path.join(d, "icon_it32.icns"), "wb") as f:
        f.write(icns([(b"icp4", _png(_pattern(16, 16, seed=74))),
                      (b"ic11", _png(_pattern(32, 32, seed=75))),
                      (b"it32", packed(p128, t=True)), (b"t8mk", mask)]))


def test_random_iptc_and_icns_files_match_pil_or_both_fail(tmp_path):
    rng = np.random.default_rng(31)
    outcomes = {"equal": 0, "both fail": 0}
    types = [b"is32", b"s8mk", b"il32", b"l8mk", b"ih32", b"h8mk", b"it32", b"t8mk", b"icp4",
             b"ic11", b"zzzz"]
    for i in range(200):
        if i % 2:
            blocks = []
            for _ in range(int(rng.integers(1, 4))):
                t = types[int(rng.integers(len(types)))]
                side = {b"is32": 16, b"s8mk": 16, b"il32": 32, b"l8mk": 32, b"ih32": 48,
                        b"h8mk": 48}.get(t, 128)
                if t.endswith(b"mk"):
                    d = bytes(side * side - int(rng.integers(0, 2)))
                elif t in (b"icp4", b"ic11"):
                    d = _png(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
                else:
                    d = packed(rng.integers(0, 4, (side, side, 3), dtype=np.uint8),
                               t=t == b"it32")
                    d = d[:len(d) - int(rng.integers(0, 3))]
                blocks.append((t, d))
            data = icns(blocks)
        else:
            w, h = (int(v) for v in rng.integers(0, 6, 2))
            payload = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
            band = None if rng.random() < 0.3 else int(rng.integers(0, 6))
            data = iptc(w, h, int(rng.choice([1, 3, 4, 2])), int(rng.integers(0, 2)),
                        int(rng.choice([1, 1, 5, 3])), payload, band=band,
                        split=int(rng.integers(1, 3)))
        outcomes[same_or_both_fail(put(str(tmp_path / f"{i}"), data))] += 1
    assert outcomes["equal"] > 30 and outcomes["both fail"] > 30


def test_png_image_data_as_pils_decoder_takes_it(tmp_path):
    """Random PNG data, whole, cut short, ending early or with junk after
    it, over one or two IDAT chunks, then IEND, a broken chunk header or
    nothing: the port's PNG reader (``image_io.inflate_idat``) reads what
    PIL reads, and the same data as an ICO entry goes where PIL sends it."""
    rng = np.random.default_rng(32)
    outcomes = {"equal": 0, "both fail": 0}
    for trial in range(160):
        w, h = int(rng.integers(1, 7)), int(rng.integers(1, 6))
        ctype, bits = [(0, 8), (2, 8), (0, 1), (6, 16), (3, 4), (4, 8)][trial % 6]
        interlace = int(rng.random() < 0.3)
        channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        rows = tio._png_rows(w, h, channels, bits, interlace)
        raw = bytearray(rng.integers(0, 256, sum(rows), dtype=np.uint8).tobytes())
        for start in np.cumsum([0] + rows[:-1]):
            raw[start] = int(rng.integers(0, 5))  # a filter type
        cut = int(rng.integers(0, len(raw) + 1)) if rng.random() < 0.6 else len(raw)
        body = zlib.compress(bytes(raw[:cut]))
        r = rng.random()
        body = body[:-int(rng.integers(1, 6))] if r < 0.25 else body + b"junk" if r < 0.35 else body
        png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype, 0,
                                                                0, interlace))
        if ctype == 3:
            png += _chunk(b"PLTE", rng.integers(0, 256, 48, dtype=np.uint8).tobytes())
        half = len(body) // 2 if rng.random() < 0.5 else len(body)
        png += _chunk(b"IDAT", body[:half]) + (_chunk(b"IDAT", body[half:]) if half < len(body)
                                               else b"")
        png += [_chunk(b"IEND", b""), b"\0\0\0\5!!", b"", b"\0\0"][trial % 4]
        for data in (png, _ico(png)):
            outcomes[same_or_both_fail(put(str(tmp_path / f"{trial}"), data))] += 1
    assert outcomes["equal"] > 60 and outcomes["both fail"] > 60
