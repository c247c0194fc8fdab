"""The JPEG-in-TIFF kinds PIL 12.1 reads through libtiff beyond those of
test_torch_image_tiff.py, each against PIL's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU:

- JPEG in planes (PlanarConfiguration 2), written by PIL's bundled
  libtiff (tests/pil_libs.py): every plane's strips or tiles one-component
  JPEG streams sharing JPEGTables, read as the other planar files are (the
  same refusals where PIL fails or misreads: an unspecified extra sample in
  strips, YCbCr subsampled in planes; four samples without ExtraSamples
  read as PIL reads them, the fourth an associated alpha);
- 12-bit greyscale, written by libtiff's 12-bit JPEG codec (optimised
  Huffman tables in the strip's stream, 16-bit quantisation tables at low
  quality), which PIL opens as ``I;16`` from libtiff's packed ``I;12``
  samples: one strip, and strips spliced from single-strip files.
  libtiff's own several-strip (or several-tile) 12-bit files are corrupt
  past the first block (it leaves the later ones' optimised tables out); PIL shows
  libjpeg's recovery and so does the port. Streams libtiff does not write,
  made here (restart intervals, SOF0, 16-bit tables). An odd width: libtiff
  leaves a row's last sample unwritten, PIL shows stale memory, the port
  raises. 12-bit RGB and a stand-alone 12-bit JPEG fail in PIL and raise;
- old-style JPEG (compression 6) with its tables in tags over several
  strips: PIL's JPEG with a restart marker every MCU row, split at the
  markers into strips, as libtiff's OJPEG codec joins them (an RST marker
  between strips, a restart interval of a strip's MCUs), strips shorter
  than their interval (libjpeg reads zero bits, then leaves grey), and
  strips holding restart markers of their own, and the refusals: strips
  not a whole number of MCU rows (libtiff fails), restart markers out of
  turn (libtiff's OJPEG source fails on libjpeg's resynchronisation).

Files libtiff writes are deterministic, so ``make_jpeg_kind_inputs`` writes
three of them for the card (tests/test_torch_image_formats.py)."""

import io
import os
import re
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from pil_libs import tiff_write
from test_torch_image_codecs import _both_raise, _check, layout
from test_torch_image_formats import _pattern, _pil
from test_torch_image_jpeg_processes import BitWriter, _segment

IMG = _pattern(48, 64, noise=0.2)
ODD = _pattern(37, 53, noise=0.2, seed=1)


def _extra(img, n=1):
    return np.concatenate([img, img[:, :, :n]], -1)


# ------------------------------------------------------------- in planes
PLANAR = {  # name: (samples, photometric, ExtraSamples, YCbCrSubsampling)
    "grey": (lambda a: a[:, :, 0], 1, (), None),
    "grey+alpha": (lambda a: a[:, :, :2], 1, (2,), None),
    "RGB": (lambda a: a, 2, (), None),
    "RGBA": (_extra, 2, (2,), None),
    "RGBa": (_extra, 2, (1,), None),
    "RGB+alpha+unspecified": (lambda a: _extra(a, 2), 2, (2, 0), None),
    "CMYK": (_extra, 5, (), None),
    "LAB": (lambda a: a, 8, (), None),
    "YCbCr 1x1": (lambda a: a, 6, (), (1, 1)),
}


@pytest.mark.parametrize("tile", [None, (16, 32)], ids=["strips", "tiles"])
@pytest.mark.parametrize("name", list(PLANAR))
def test_planar_jpeg_matches_pil(tmp_path, name, tile):
    """Each kind PIL opens in planes, in strips of 16 rows or in tiles cut
    at the edge, at two qualities and sizes."""
    make, photo, extra, sub = PLANAR[name]
    read = 0
    for img in (IMG, ODD):
        for quality in (30, 90):
            path = tiff_write(str(tmp_path / "p.tif"), make(img), photo, planar=2, rows=16,
                              tile=tile, extra=extra, sub=sub, quality=quality)
            assert Image.open(path).tag_v2[284] == 2
            if name == "RGB+alpha+unspecified" and not tile:
                _both_raise(path)  # PIL: decoder error -2 on the unspecified sample
                continue
            _check(path)
            read += 1
    assert read == (0 if name == "RGB+alpha+unspecified" and not tile else 4)


@pytest.mark.parametrize("tile", [None, (16, 32)], ids=["strips", "tiles"])
def test_planar_jpeg_refusals(tmp_path, tile):
    """An unspecified extra sample in strips: PIL fails (decoder error -2)
    and the port raises; in tiles both read it. Four samples without
    ExtraSamples: PIL divides the colour by the fourth sample as by an
    associated alpha, and so does the port. YCbCr subsampled in planes:
    libtiff's RGBA interface fails, and so does PIL."""
    path = str(tmp_path / "r.tif")
    tiff_write(path, _extra(IMG), 2, planar=2, rows=16, tile=tile, extra=(0,))
    if tile:
        _check(path)
    else:
        _both_raise(path)
    tiff_write(path, _extra(IMG), 2, planar=2, rows=16, tile=tile)
    _check(path)
    assoc = tiff_write(str(tmp_path / "a.tif"), _extra(IMG), 2, planar=2, rows=16, tile=tile,
                       extra=(1,))
    np.testing.assert_array_equal(_pil(path), _pil(assoc))
    path = str(tmp_path / "y.tif")
    with open(path, "wb") as f:  # libtiff will not write it: the planes of a strip by hand
        f.write(layout(_planar_blocks(IMG), {256: (4, [64]), 257: (4, [48]),
                                             258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]),
                                             277: (3, [3]), 278: (4, [16]), 284: (3, [2]),
                                             530: (3, [2, 2])}))
    with pytest.raises(ValueError, match=r"YCbCr TIFF with subsampling \(2, 2\) and planar"):
        tio.read_image(path)
    with pytest.raises(Exception):
        _pil(path)


@pytest.mark.parametrize("comp", [7, 5, 8], ids=["jpeg", "lzw", "deflate"])
@pytest.mark.parametrize("tile", [None, (16, 32)], ids=["strips", "tiles"])
def test_planar_four_samples_without_extrasamples(tmp_path, comp, tile):
    """Four 8-bit RGB samples in planes, compressed, no ExtraSamples: PIL
    reads the fourth as an associated alpha (the file reads as the same one
    with ExtraSamples 1), and so does the port."""
    path = tiff_write(str(tmp_path / "n.tif"), _extra(IMG), 2, comp=comp, planar=2, rows=16,
                      tile=tile)
    assoc = tiff_write(str(tmp_path / "a.tif"), _extra(IMG), 2, comp=comp, planar=2, rows=16,
                       tile=tile, extra=(1,))
    np.testing.assert_array_equal(_pil(path), _pil(assoc))
    _check(path)


def _planar_blocks(img):
    """Each plane's strips of 16 rows as whole one-component JPEG streams."""
    blocks = []
    for c in range(img.shape[2]):
        for y in range(0, img.shape[0], 16):
            buf = io.BytesIO()
            Image.fromarray(img[y:y + 16, :, c]).save(buf, "JPEG", quality=80)
            blocks.append(buf.getvalue())
    return blocks


# ---------------------------------------------------------------- 12 bits
RAMP = (np.arange(40 * 56).reshape(40, 56) * 3 % 4096).astype(np.uint16)
NOISE = np.random.default_rng(5).integers(0, 4096, (40, 56)).astype(np.uint16)


def _strips(path):
    """(JPEGTables, [strip streams]) of a TIFF."""
    with Image.open(path) as im, open(path, "rb") as f:
        data = f.read()
        return (bytes(im.tag_v2[347]), [data[o:o + n] for o, n in zip(im.tag_v2[273],
                                                                       im.tag_v2[279])])


def jpeg12_strips(path, img, rows, quality=75, tmp=None):
    """A 12-bit greyscale JPEG-in-TIFF in strips of ``rows`` rows, each
    strip the stream of a single-strip file libtiff wrote of those rows,
    JPEGTables from the first."""
    tmp = tmp or path + ".part.tif"
    tables, streams = None, []
    for y in range(0, img.shape[0], rows):
        t, (stream,) = _strips(tiff_write(tmp, img[y:y + rows], 1, bits=12, quality=quality))
        tables = tables or t
        streams.append(stream)
    os.remove(tmp)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(layout(streams, {256: (4, [w]), 257: (4, [h]), 258: (3, [12]), 259: (3, [7]),
                                 262: (3, [1]), 277: (3, [1]), 278: (4, [rows]),
                                 347: (7, tables)}))
    return path


@pytest.mark.parametrize("quality", [5, 30, 75, 95])
def test_12_bit_grey_jpeg_matches_pil(tmp_path, quality):
    """One strip, and strips spliced from libtiff's single-strip files
    (the last one shorter), of a ramp and of noise: PIL's I;16
    samples, clamped at 255 by its conversion. Quality 5 makes 16-bit
    quantisation tables."""
    path = str(tmp_path / "g.tif")
    for img in (RAMP, NOISE):
        tiff_write(path, img, 1, bits=12, quality=quality)
        im = Image.open(path)
        assert im.mode == "I;16" and im.tile[0].args[0] == "I;12"
        if img is RAMP:  # the samples are the ramp's, to within JPEG's loss
            assert np.abs(np.asarray(im, np.int64) - img).mean() < 0.05 * 4095
        _check(path)
        tables = bytes(im.tag_v2[347])
        assert (tables[tables.index(b"\xff\xdb") + 4] >> 4) == (quality == 5)
        for rows in (8, 16):
            _check(jpeg12_strips(path, img, rows, quality))


_ZIGZAG = [i for _, _, i in sorted((r + c, r if (r + c) % 2 else c, r * 8 + c)
                                    for r in range(8) for c in range(8))]


def jpeg12(img, quant, restart=0, sof=0xC1) -> bytes:
    """A one-component 12-bit Huffman JPEG, which libtiff does not write:
    a float DCT of (h, w) samples over ``quant`` (64 values in natural
    order; 16-bit DQT entries past 255), fixed-length codes (DC 5 bits, AC
    8 bits), a restart marker every ``restart`` MCUs, frame ``sof``."""
    h, w = img.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    k, n = np.mgrid[0:8, 0:8]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    p = np.pad(img.astype(np.float64) - 2048, ((0, ph - h), (0, pw - w)), mode="edge")
    blocks = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
    coef = np.rint(np.einsum("ij,abjk,lk->abil", c, blocks, c).reshape(-1, 64)
                   / np.asarray(quant, np.float64)).astype(np.int64)[:, _ZIGZAG]
    pq = int(max(quant) > 255)
    dqt = bytes([pq << 4]) + b"".join(struct.pack(">H" if pq else ">B", quant[i])
                                      for i in _ZIGZAG)
    ac = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 15)]
    code = {s: i for i, s in enumerate(ac)}
    dht = (bytes([0x00, 0, 0, 0, 0, 16] + [0] * 11) + bytes(range(16)) + bytes([0x10])
           + bytes([0] * 7 + [len(ac)] + [0] * 8) + bytes(ac))
    out = (b"\xff\xd8" + _segment(0xDB, dqt) + _segment(0xC4, dht)
           + _segment(sof, struct.pack(">BHHB", 12, h, w, 1) + bytes([1, 0x11, 0]))
           + (_segment(0xDD, struct.pack(">H", restart)) if restart else b"")
           + _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0])))
    bits, pred, data = BitWriter(), 0, b""
    for i, zz in enumerate(coef.tolist()):
        if restart and i and i % restart == 0:
            data += bits.flush() + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            pred = 0
        d, pred = zz[0] - pred, zz[0]
        bits.put(abs(d).bit_length(), 5)
        if d:
            bits.put(d if d > 0 else d - 1, abs(d).bit_length())
        last, run = max([j for j in range(1, 64) if zz[j]], default=0), 0
        for v in zz[1:last + 1]:
            if not v:
                run += 1
                continue
            while run > 15:
                bits.put(code[0xF0], 8)
                run -= 16
            bits.put(code[(run << 4) | abs(v).bit_length()], 8)
            bits.put(v if v > 0 else v - 1, abs(v).bit_length())
            run = 0
        if last < 63:
            bits.put(code[0x00], 8)
    return out + data + bits.flush() + b"\xff\xd9"


def _one_strip_12(path, stream, h, w):
    with open(path, "wb") as f:
        f.write(layout([stream], {256: (4, [w]), 257: (4, [h]), 258: (3, [12]),
                                  259: (3, [7]), 262: (3, [1]), 277: (3, [1]),
                                  278: (4, [h])}))
    return path


def test_12_bit_streams_libtiff_does_not_write(tmp_path):
    """Restart intervals of 1, 3 and 7 MCUs, 8- and 16-bit quantisation
    tables, SOF0 as well as SOF1, all tables in the strip's stream."""
    path = str(tmp_path / "h.tif")
    y, x = np.mgrid[0:37, 0:52]
    for img in (((x * 60 + y * 40) % 4096).astype(np.int64), NOISE[:37, :52]):
        for quant in ([2] * 64, list(range(1, 65)), [300] * 64):
            for restart in (0, 1, 3, 7):
                for sof in (0xC1, 0xC0):
                    _check(_one_strip_12(path, jpeg12(img, quant, restart, sof), 37, 52))
            if quant[0] == 2:  # the stream is the picture
                assert np.abs(np.asarray(Image.open(path), np.int64) - img).mean() < 1


def test_12_bit_refusals(tmp_path):
    """libtiff's own several-strip 12-bit file: PIL reads the later strips
    with the first strip's optimised Huffman tables, and libjpeg's recovery
    from the codes they lack (17 bits and the value 0 each), and so does
    the port. 12-bit RGB: PIL cannot
    identify it. A stand-alone 12-bit JPEG (the strip's stream with its
    tables): PIL cannot identify it either."""
    path = tiff_write(str(tmp_path / "m.tif"), NOISE, 1, bits=12, rows=16, quality=75)
    got = np.asarray(Image.open(path), np.int64)
    assert np.abs(got[:16] - NOISE[:16]).mean() < 40 < np.abs(got[16:] - NOISE[16:]).mean()
    _check(path)
    rgb = tiff_write(str(tmp_path / "c.tif"), np.stack([RAMP] * 3, -1), 2, bits=12)
    with pytest.raises(ValueError, match="PIL has no mode for it"):
        tio.read_image(rgb)
    with pytest.raises(Exception):
        _pil(rgb)
    tables, (stream,) = _strips(tiff_write(str(tmp_path / "o.tif"), RAMP, 1, bits=12))
    jpg = str(tmp_path / "s.jpg")
    with open(jpg, "wb") as f:
        f.write(b"\xff\xd8" + tables[2:-2] + stream[2:])
    with pytest.raises(Exception):
        _pil(jpg)
    with pytest.raises(ValueError, match="12-bit JPEG"):
        tio.read_image(jpg)
    odd = _one_strip_12(str(tmp_path / "w.tif"), jpeg12(NOISE[:37, :53], [2] * 64), 37, 53)
    _pil(odd)  # reads, partly from memory libtiff did not write
    with pytest.raises(ValueError, match="leaves the last of a row unwritten"):
        tio.read_image(odd)


# ------------------------------------------ old-style JPEG, several strips
def _tables(jp: bytes):
    """The quantisation and Huffman table bodies of a JPEG, as the
    JPEGQTables, JPEGDCTables and JPEGACTables tags point at them."""
    qt, dc, ac, pos = [], [], [], 2
    while jp[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", jp[pos + 2:pos + 4])
        body, k = jp[pos + 4:pos + 2 + n], 0
        while jp[pos + 1] == 0xDB and k < len(body):
            qt.append(body[k + 1:k + 65])
            k += 65
        while jp[pos + 1] == 0xC4 and k < len(body):
            total = sum(body[k + 1:k + 17])
            (dc if body[k] >> 4 == 0 else ac).append(body[k + 1:k + 17 + total])
            k += 17 + total
        pos += 2 + n
    return qt, dc, ac


def old_jpeg_strips(path, img, sub=2, strip_mcu_rows=1, rows=None, own_markers=False,
                    restart_tag=None, order="<"):
    """Old-style JPEG-in-TIFF with its tables in tags over several strips,
    from PIL's baseline JPEG of ``img`` with a restart marker every
    ``strip_mcu_rows`` MCU rows (``sub``: PIL's subsampling 0, 1 or 2,
    4:4:4, 4:2:2 or 4:2:0; a 2-D image one component): the scan split at
    its markers into strips, the markers dropped (``own_markers``: a marker
    every MCU row, those inside a strip kept); RowsPerStrip ``rows``
    (default the strips' own rows), JPEGRestartInterval ``restart_tag``;
    the tables after the image data."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, subsampling=sub,
                              restart_marker_rows=1 if own_markers else strip_mcu_rows)
    jp = buf.getvalue()
    sos = jp.index(b"\xff\xda")
    scan = jp[sos + 2 + struct.unpack(">H", jp[sos + 2:sos + 4])[0]:jp.rindex(b"\xff\xd9")]
    parts = re.split(rb"(\xff[\xd0-\xd7])", scan)
    intervals, markers = parts[0::2], parts[1::2] + [b""]
    group = strip_mcu_rows if own_markers else 1
    strips = [b"".join(intervals[k] + (markers[k] if k < min(i + group, len(intervals)) - 1
                                       else b"") for k in range(i, min(i + group,
                                                                       len(intervals))))
              for i in range(0, len(intervals), group)]
    hs, vs = ((1, 1), (2, 1), (2, 2))[sub] if spp == 3 else (1, 1)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]),
            262: (3, [6 if spp == 3 else 1]), 277: (3, [spp]),
            278: (4, [rows or 8 * vs * strip_mcu_rows]), 512: (3, [1])}
    if spp == 3:
        tags[530] = (3, [hs, vs])
    if restart_tag is not None:
        tags[515] = (3, [restart_tag])
    qt, dc, ac = _tables(jp)
    base = len(layout(strips, {**tags, 519: (4, [0] * spp), 520: (4, [0] * spp),
                               521: (4, [0] * spp)}, order))
    at = base
    for key, tables in ((519, qt), (520, dc), (521, ac)):
        offs = []
        for t in tables:
            offs.append(at)
            at += len(t)
        tags[key] = (4, (offs + offs[-1:] * spp)[:spp])
    data = layout(strips, tags, order)
    assert len(data) == base
    with open(path, "wb") as f:
        f.write(data + b"".join(qt + dc + ac))
    return path


@pytest.mark.parametrize("sub", [0, 1, 2, None], ids=["444", "422", "420", "grey"])
def test_old_jpeg_in_strips_matches_pil(tmp_path, sub):
    """One or two MCU rows a strip, even and odd sizes, a
    JPEGRestartInterval that libtiff overrides; and strips of
    fewer rows than RowsPerStrip says, so that each ends early in its
    restart interval: libjpeg decodes the MCU that runs out from zero bits,
    whose extreme values its SIMD IDCT saturates, and leaves the rest of
    the interval grey."""
    path = str(tmp_path / "o.tif")
    for img in (IMG, ODD):
        img = img[:, :, 0] if sub is None else img
        s = 0 if sub is None else sub
        mcu = 16 if s == 2 else 8
        _check(old_jpeg_strips(path, img, s))
        _check(old_jpeg_strips(path, img, s, restart_tag=5))
        _check(old_jpeg_strips(path, img, s, strip_mcu_rows=2))
        _check(old_jpeg_strips(path, img, s, rows=2 * mcu))  # a strip short of its interval


def test_old_jpeg_in_strips_refusals(tmp_path):
    """Strips not a whole number of MCU rows: libtiff fails, and PIL.
    Strips holding restart markers of their own: libjpeg takes a marker
    that comes in turn, and both read them alike; where one does not,
    libtiff's OJPEG data source fails on libjpeg's resynchronisation, and
    PIL shows the last strip's memory (it fails where that is not the last
    strip) while the port raises. The same strips big-endian: PIL reads the
    strips after the first otherwise than little-endian."""
    path = old_jpeg_strips(str(tmp_path / "r.tif"), IMG, 2, rows=8)
    with pytest.raises(ValueError, match="Incompatible vertical subsampling"):
        tio.read_image(path)
    with pytest.raises(Exception):
        _pil(path)
    path = old_jpeg_strips(str(tmp_path / "k.tif"), IMG, 2, strip_mcu_rows=2, own_markers=True)
    _check(path)
    _check(old_jpeg_strips(str(tmp_path / "k.tif"), IMG, 0, strip_mcu_rows=3, own_markers=True))
    path = old_jpeg_strips(str(tmp_path / "k.tif"), IMG, 0, strip_mcu_rows=2, own_markers=True)
    _pil(path)
    with pytest.raises(ValueError, match="fails on libjpeg's resynchronisation"):
        tio.read_image(path)
    _both_raise(old_jpeg_strips(str(tmp_path / "k.tif"), _pattern(64, 64, noise=0.2), 0,
                                strip_mcu_rows=2, own_markers=True))
    little = _pil(old_jpeg_strips(str(tmp_path / "l.tif"), IMG, 0))
    path = old_jpeg_strips(str(tmp_path / "b.tif"), IMG, 0, order=">")
    assert (_pil(path) != little).any(axis=2)[8:].any() and (_pil(path) == little)[:8].all()
    with pytest.raises(ValueError, match="big-endian old-style JPEG-in-TIFF"):
        tio.read_image(path)


# ------------------------------------------------------ the card's inputs
def make_jpeg_kind_inputs(d: str) -> None:
    photo = _pattern(192, 256, noise=0.05, seed=30)
    alpha = np.clip(np.arange(256)[None, :] + np.arange(192)[:, None], 0, 255).astype(np.uint8)
    tiff_write(os.path.join(d, "planar_jpeg_rgba.tif"),
               np.concatenate([photo, alpha[:, :, None]], -1), 2, planar=2, tile=(64, 64),
               extra=(2,), quality=80)
    y, x = np.mgrid[0:120, 0:160]
    grey = ((x * 25 + y * 7) % 4096).astype(np.uint16)
    jpeg12_strips(os.path.join(d, "jpeg12_grey_strips.tif"), grey, 32)
    old_jpeg_strips(os.path.join(d, "old_jpeg_strips_420.tif"),
                    _pattern(150, 200, noise=0.05, seed=31), 2)
