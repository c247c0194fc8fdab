"""``read_image``'s choice of reader against PIL 12.1's ``Image.open``, and
the new inputs of the card's image phase, on the CPU.

- The opener table (``utils/image_identify.py::OPENERS``) is PIL's order in
  a fresh interpreter (asked of a fresh PIL here).
- For every committed input under ``tests/data/images`` and for headers
  built to be ambiguous, the port's ``format_name`` is PIL's ``format``
  (PIL opened in the fresh order), and the port reads what PIL reads or
  fails where it fails: an MSP whose checksum is bad, passed on to PCD; IM
  text in front of a TGA (passed on to TGA where the IM header breaks off,
  read as IM where it holds); TGAs that PCX's accept test takes (PIL's PCX
  opener fails on one, reads another); an empty ICO and CUR directory
  passed on to TGA; a 16-bit PSD, PNGs with a bad CRC or chunk name before
  their image data, and plain noise, which nothing opens ("cannot
  identify image file"); PAM, which keeps its Netpbm message.
- Formats PIL opens and the port does not read (the MPEG, BUFR, GRIB and
  HDF5 stubs PIL cannot load either): named as PIL names them, and refused
  naming them; IPTC and PCD, refused until the port read them, now read
  as PIL reads them.
- The port's ``load_image`` against the JAX ``load_image`` (PIL) on one
  committed file of each new format, exactly, as
  ``test_torch_image_formats.py`` compares them.
- ``make_raster_inputs`` writes those committed files (``python
  tests/test_torch_image_formats.py`` rewrites every card input).
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from audioeditingcode_tpu_torch.utils.image_identify import OPENERS
from test_torch_image_formats import CHIP_INPUTS, DATA, RASTER_INPUTS, _pattern
from test_torch_image_raster import (FRESH, both_fail, msp2, msp_row, pcx, pcx_rle, put,
                                     same_or_both_fail, sgi, sgi_rle, sun, sun_rle, xbm, xpm)


def pil_format(path):
    """PIL's ``format`` for the file (fresh order), or None where it fails."""
    try:
        with Image.open(path, formats=FRESH) as img:
            return img.format
    except Exception:
        return None


def port_format(path):
    try:
        return tio.format_name(path)
    except ValueError:
        return None


def test_openers_are_pils_fresh_order():
    code = ("from PIL import Image; Image.preinit(); a = list(Image.ID); Image.init(); "
            "print(' '.join(a + [i for i in Image.ID if i not in a]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == list(FRESH)
    assert [name for name, _, _ in OPENERS] == [{"XVTHUMB": "XVThumb"}.get(n, n) for n in out]


def test_committed_inputs_open_as_pil_opens_them():
    names = sorted(n for n in os.listdir(DATA) if n != "sha256.json")
    assert names == sorted(CHIP_INPUTS) and len(names) == 61
    for name in names:
        path = os.path.join(DATA, name)
        assert port_format(path) == pil_format(path) is not None, name


# ----------------------------------------------------------- ambiguity
def _tga(id_field: bytes, w=4, h=3, depth=24, itype=2, cmap_type=0, pixels=None) -> bytes:
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), cmap_type, itype, 0, 0, 0, 0, 0, w, h,
                       depth, 0x20)
    body = pixels if pixels is not None else bytes(range(40, 40 + w * h * depth // 8))
    return head + id_field + body


def _ambiguous():
    rng = np.random.default_rng(1)
    rows = [msp_row(bytes(rng.integers(0, 256, 2).astype(np.uint8)), rng) for _ in range(5)]
    bad_msp = msp2(16, 5, rows, checksum=False)
    bad_msp += bytes(2048 - len(bad_msp)) + b"PCD_" + bytes(1600)
    text = b"xx: yy\nImage size (x*y): 4*3\n"  # IM lines after the 18 header bytes
    # an ID field of 65 bytes: its length byte is "A", so IM reads the header as a line
    im_then_tga = _tga((text + b"#not a header line\n").ljust(65, b"."))
    im_that_holds = _tga((text + b"\x1a").ljust(65, b"."))
    pcx_fails = _tga(b"0123456789", w=8, h=4)  # ID length 10, map type 0: PCX's accept
    pcx_reads = bytearray(_tga(b"", w=8, h=4)[:18].ljust(140, b"\xff"))
    pcx_reads[:4], pcx_reads[65:68] = bytes([10, 0, 2, 1]), b"\1\2\0"  # 1 bit, 1 plane
    ico = b"\0\0\1\0\0\0" + _tga(b"")[6:]
    cur = b"\0\0\2\0\0\0" + _tga(b"")[6:]
    psd16 = (b"8BPS\0\1" + bytes(6) + struct.pack(">HIIHH", 3, 2, 2, 16, 3) + bytes(12)
             + b"\0\0" + bytes(24))
    png = bytearray(open(os.path.join(DATA, "adam7_rgb16.png"), "rb").read())
    bad_crc, bad_name = bytearray(png), bytearray(png)
    bad_crc[29] ^= 1  # the IHDR's CRC
    bad_name[12:16] = b"IH R"
    return {"MSP, bad checksum, PCD marker": (bad_msp, "PCD"),
            "IM text that breaks off, then a TGA": (im_then_tga, "TGA"),
            "IM text that holds, in a TGA's ID field": (im_that_holds, "IM"),
            "TGA that PCX takes and fails on": (pcx_fails, None),
            "PCX header over a TGA's": (bytes(pcx_reads), "PCX"),
            "ICO with no entries, a TGA header": (ico, "TGA"),
            "CUR with no entries, a TGA header": (cur, "TGA"),
            "16-bit PSD": (psd16, None),
            "PNG with a bad IHDR CRC": (bytes(bad_crc), None),
            "PNG whose first chunk name is not a name": (bytes(bad_name), None),
            "noise": (bytes(rng.integers(0, 256, 300).astype(np.uint8)), None),
            "SGI of two channels": (sgi(0, 1, 3, 2, 2, 2, bytes(8)), None)}


AMBIGUOUS = _ambiguous()


@pytest.mark.parametrize("case", sorted(AMBIGUOUS))
def test_ambiguous_header_opens_as_pil_opens_it(tmp_path, case):
    data, fmt = AMBIGUOUS[case]
    path = put(str(tmp_path / "f"), data)
    assert pil_format(path) == fmt
    assert port_format(path) == fmt
    outcome = same_or_both_fail(path)
    if fmt in (None, "PCD"):
        assert outcome == "both fail"
    if fmt is None and case != "TGA that PCX takes and fails on" and case != "SGI of two channels":
        with pytest.raises(ValueError, match="cannot identify image file"):
            tio.read_image(path)


def test_pam_keeps_its_netpbm_message(tmp_path):
    path = put(str(tmp_path / "p.pam"), b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"
               + bytes(4))
    both_fail(path, r"Netpbm magic b'P7'")


# -------------------------------------------------- formats not read yet
def _iptc() -> bytes:
    def field(rec, tag, data):
        return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data
    return (field(3, 60, b"\1\0") + field(3, 20, b"\0\4") + field(3, 30, b"\0\3")
            + field(3, 120, b"\1") + field(8, 10, bytes(12)))


NOT_YET = {"IPTC": _iptc(),
           "PCD": bytes(2048) + b"PCD_" + bytes(95 * 2048 - 4) + bytes(range(256)) * 2304,
           "MPEG": b"\0\0\1\xb3\x04\x00\x30" + bytes(20),
           "BUFR": b"BUFR" + bytes(60),
           "GRIB": b"GRIB\0\0\0\1" + bytes(60),
           "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(60)}


@pytest.mark.parametrize("fmt", sorted(NOT_YET))
def test_formats_not_read_yet_are_named(tmp_path, fmt):
    path = put(str(tmp_path / "f"), NOT_YET[fmt])
    assert pil_format(path) == fmt == port_format(path)
    if fmt in ("IPTC", "PCD"):  # read since the port reads them
        assert same_or_both_fail(path) == "equal"
        return
    with pytest.raises(ValueError, match=f"{fmt} image, a format the port does not read yet"):
        tio.read_image(path)


# ---------------------------------------------------- committed inputs
def make_raster_inputs(d: str) -> None:
    """Write the files of ``test_torch_image_formats.RASTER_INPUTS`` into
    ``d``."""
    from test_torch_image_psd import psd, resource

    photo = _pattern(384, 512, noise=0.03, seed=30)
    with open(os.path.join(d, "photo_packbits.psd"), "wb") as f:
        f.write(psd(np.ascontiguousarray(photo.transpose(2, 0, 1)), 3, 8, 1,
                    resources=resource(1005, b"", bytes(16)) + resource(1061, b"cap", b"x" * 5),
                    layers=bytes(4) + b"\0" * 24))
    y, x = np.mgrid[0:120, 0:160]
    rgb16 = np.stack([(x * 400 + y * 37) % 65536, (y * 520) % 65536, (x * y * 3) % 65536])
    rgb16[:, 40:80, 20:120] = 30000  # runs
    with open(os.path.join(d, "rle16_rgb.sgi"), "wb") as f:
        f.write(sgi(1, 2, 3, 160, 120, 3, sgi_rle(rgb16[:, ::-1], 2,
                                                   rng=np.random.default_rng(31))))
    quant = Image.fromarray(_pattern(240, 320, noise=0.02, seed=32)).quantize(200)
    idx = np.asarray(quant)
    pal = bytes(quant.getpalette()[:768]).ljust(768, b"\0")
    with open(os.path.join(d, "palette_rle.pcx"), "wb") as f:
        f.write(pcx(5, 8, 1, 320, 240, pcx_rle(idx.tobytes(), 320), tail=b"\x0c" + pal))
    Image.fromarray(_pattern(192, 256, noise=0.02, seed=33)).save(os.path.join(d, "photo.qoi"))
    quant = Image.fromarray(_pattern(150, 200, noise=0.0, seed=34)).quantize(64)
    cmap = np.asarray(quant.getpalette()[:192], np.uint8).reshape(64, 3).T.tobytes()
    with open(os.path.join(d, "rle_cmap.ras"), "wb") as f:
        f.write(sun(200, 150, 8, 2, sun_rle(np.asarray(quant).tobytes()), cmap))
    bits = np.packbits(_pattern(200, 320, noise=0.0, seed=35).mean(-1) > 127, axis=1)
    rng = np.random.default_rng(36)
    with open(os.path.join(d, "rle_v2.msp"), "wb") as f:
        f.write(msp2(320, 200, [msp_row(r.tobytes(), rng) for r in bits]))
    vals = np.packbits(_pattern(48, 64, noise=0.1, seed=37).mean(-1) > 127, axis=1,
                       bitorder="little")
    with open(os.path.join(d, "icon.xbm"), "wb") as f:
        f.write(xbm(64, 48, vals.reshape(-1), hotspot=True))
    quant = Image.fromarray(_pattern(32, 48, noise=0.05, seed=38)).quantize(40)
    keys = [chr(65 + i // 26) + chr(97 + i % 26) for i in range(41)]
    colours = [(keys[0], "None")] + [(keys[i + 1], "#%02x%02x%02x" % tuple(c)) for i, c in
                                     enumerate(np.asarray(quant.getpalette()[:120]).reshape(40, 3))]
    rows = ["".join(keys[v + 1] for v in row) for row in np.asarray(quant)]
    with open(os.path.join(d, "icon.xpm"), "wb") as f:
        f.write(xpm(48, 32, colours, rows, cpp=2, pixels_comment=True))
    Image.fromarray(_pattern(120, 160, noise=0.05, seed=39)).quantize(100).save(
        os.path.join(d, "lut_palette.im"))
    pages = []
    for seed in (40, 41):
        q = Image.fromarray(_pattern(64, 96, noise=0.02, seed=seed)).quantize(50)
        pages.append(pcx(5, 8, 1, 96, 64, pcx_rle(np.asarray(q).tobytes(), 96)))
    last = b"\x0c" + bytes(q.getpalette()[:768]).ljust(768, b"\0")
    table = struct.pack("<IIII", 0x3ADE68B1, 16, 16 + len(pages[0]), 0)
    with open(os.path.join(d, "pages.dcx"), "wb") as f:
        f.write(table + pages[0] + pages[1] + last)


@pytest.mark.parametrize("name", sorted(RASTER_INPUTS))
def test_load_image_matches_jax(name):
    from audioeditingcode_tpu.utils import image_io as jio

    path = os.path.join(DATA, name)
    want = jio.load_image(path, left=3, top=2, resize=(64, 64))
    got = tio.load_image(path, left=3, top=2, resize=(64, 64))
    assert got.shape == want.shape == (1, 3, 64, 64)
    np.testing.assert_array_equal(got, want)
