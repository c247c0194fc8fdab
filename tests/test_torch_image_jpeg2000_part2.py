"""JPEG 2000 Part 2 component-transform markers and mixed wavelets under
the Part 1 transform, as PIL 12.1 decodes them through OpenJPEG 2.5.4,
against PIL's ``np.array(Image.open(p).convert("RGB"))`` bit for bit.

OpenJPEG reads MCT, MCC and MCO (``j2k.c``) but runs no custom transform:
a COD that asks for one (MCT 2, what its own ``opj_set_MCT`` encoder
writes) fails. So the files here are PIL-written codestreams with the
markers put in by hand, in the main header or a tile-part header:

- MCO zeroes every component's DC level shift; its stage's MCC, looked up
  in the first MCC record only, sets them from its offset array (int16
  read unsigned, int32, float32 and float64 truncated, out of range the
  least int32), whatever the array's type; a decorrelation array is size
  checked and unused;
- the records OpenJPEG skips with a warning (records over several
  segments, several collections or stages, other transforms, shuffled
  components) and the ones it fails on (sizes, missing records);
- CBD, which sets the components' depth and sign after SIZ: the clamp,
  the 9/7 step sizes and PIL's unpack take it, the DC shift keeps SIZ's;
- COC giving components 1 or 2 (or 0) the other wavelet under the Part 1
  RCT or ICT: OpenJPEG runs component 0's transform on the three buffers
  as they are, float32 samples taken as int32 or the reverse."""

import io
import os
import struct

import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_codecs import _both_raise, _check
from test_torch_image_formats import _pattern

IMG = _pattern(32, 48, noise=0.1)
ODD = _pattern(37, 53, noise=0.3, seed=2)


def _seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def mct(index, array_type, element_type, values, z=0, y=0) -> bytes:
    """An MCT segment: Zmct, Imct (index, array type, element type), Ymct
    and the values big-endian."""
    code = ">" + "hifd"[element_type]
    imct = index | array_type << 8 | element_type << 10
    return _seg(0xFF74, struct.pack(">HHH", z, imct, y)
                + b"".join(struct.pack(code, v) for v in values))


def mcc(index, n, deco, offsets, xform=1, order=None, out_n=None, reversible=0) -> bytes:
    """An MCC segment of one collection: transform ``xform`` over the
    components ``order`` (default 0..n-1) in and out, its decorrelation and
    offset MCT indices."""
    order = list(range(n)) if order is None else order
    body = struct.pack(">HBHH", 0, index, 0, 1) + bytes([xform])
    body += struct.pack(">H", n) + bytes(order) + struct.pack(">H", out_n or n) + bytes(order)
    return _seg(0xFF75, body + (reversible << 16 | offsets << 8 | deco).to_bytes(3, "big"))


def mco(*stages) -> bytes:
    return _seg(0xFF77, bytes([len(stages)]) + bytes(stages))


def cbd(depths) -> bytes:
    return _seg(0xFF78, struct.pack(">H", len(depths)) + bytes(depths))


def with_markers(img, main=b"", tile=b"", cod_mct=None, **save) -> bytes:
    """PIL's J2K codestream of ``img`` with ``main`` put before its first
    SOT and ``tile`` after it (its Psot grown to hold them)."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **save)
    d = bytearray(buf.getvalue())
    if cod_mct is not None:
        d[d.index(b"\xff\x52") + 8] = cod_mct
    s = d.index(b"\xff\x90")
    (psot,) = struct.unpack(">I", d[s + 6:s + 10])
    if psot:
        d[s + 6:s + 10] = struct.pack(">I", psot + len(tile))
    return bytes(d[:s]) + main + bytes(d[s:s + 12]) + tile + bytes(d[s + 12:])


OFFSETS = [100, 20, 200]
READ = {  # main-header markers PIL reads: name -> markers
    "identity and the default offsets": mct(1, 1, 2, [1, 0, 0, 0, 1, 0, 0, 0, 1])
    + mct(2, 2, 1, [128] * 3) + mcc(1, 3, 1, 2) + mco(1),
    "a matrix, no offsets (shifts zeroed)": mct(1, 1, 2, [0.5, 0, 0, 0, 1, 0, 0, 0, 1])
    + mcc(1, 3, 1, 0) + mco(1),
    "int16 offsets, read unsigned": mct(2, 2, 0, [-5, 100, 300]) + mcc(1, 3, 0, 2) + mco(1),
    "int32 offsets": mct(2, 2, 1, [-5, 100, 300]) + mcc(1, 3, 0, 2) + mco(1),
    "float32 offsets, truncated": mct(2, 2, 2, [100.7, -3.9, 255.99]) + mcc(1, 3, 0, 2)
    + mco(1),
    "float64 offsets, one out of range": mct(2, 2, 3, [100.7, -3.9, 1e10]) + mcc(1, 3, 0, 2)
    + mco(1),
    "float64 NaN offset": mct(2, 2, 3, [float("nan"), 5, 6]) + mcc(1, 3, 0, 2) + mco(1),
    "int16 matrix and offsets": mct(1, 1, 0, [1, 0, 0, 0, 1, 0, 0, 0, 1])
    + mct(2, 2, 0, OFFSETS) + mcc(1, 3, 1, 2) + mco(1),
    "float64 matrix": mct(1, 1, 3, [1.0] * 9) + mct(2, 2, 1, OFFSETS) + mcc(1, 3, 1, 2)
    + mco(1),
    "MCO of an absent MCC": mct(2, 2, 1, OFFSETS) + mcc(1, 3, 0, 2) + mco(5),
    "MCO of no stage": mco(),
    "MCO of two stages (skipped)": mco(1, 2),
    "MCC of two components": mct(2, 2, 1, [1, 2]) + mcc(1, 2, 0, 2) + mco(1),
    "MCO before its MCC": mco(1) + mct(2, 2, 1, OFFSETS) + mcc(1, 3, 0, 2),
    "dependency array as the matrix": mct(1, 0, 2, [1.0] * 9) + mcc(1, 3, 1, 0) + mco(1),
    "offsets in a decorrelation array": mct(2, 1, 1, OFFSETS) + mcc(1, 3, 0, 2) + mco(1),
    "MCC of another transform (skipped)": mct(2, 2, 1, OFFSETS) + mcc(1, 3, 0, 2, xform=2)
    + mco(1),
    "MCC of shuffled components (skipped)": mct(2, 2, 1, OFFSETS)
    + mcc(1, 3, 0, 2, order=[1, 0, 2]) + mco(1),
    "MCC of other output components (skipped)": mct(2, 2, 1, OFFSETS)
    + mcc(1, 3, 0, 2, out_n=2) + mco(1),
    "MCT over segments (skipped)": mct(2, 2, 1, OFFSETS, z=1) + mco(1),
    "MCO of the second MCC (OpenJPEG looks at the first)": mct(2, 2, 1, OFFSETS)
    + mct(3, 2, 1, [50, 60, 70]) + mcc(1, 3, 0, 2) + mcc(2, 3, 0, 3) + mco(2),
    "MCC redefined": mct(2, 2, 1, OFFSETS) + mct(3, 2, 1, [50, 60, 70]) + mcc(1, 3, 0, 2)
    + mcc(1, 3, 0, 3) + mco(1),
    "MCT redefined": mct(2, 2, 1, OFFSETS) + mct(2, 2, 1, [50, 60, 70]) + mcc(1, 3, 0, 2)
    + mco(1),
    "CBD of the same depths": cbd([7] * 3),
    "CBD signed": cbd([0x87] * 3),
    "CBD of 10 bits": cbd([9] * 3),
    "CBD of 4 bits": cbd([3] * 3),
}
FAIL = {
    "a matrix of the wrong size": mct(1, 1, 2, [1.0, 0, 0]) + mcc(1, 3, 1, 0) + mco(1),
    "offsets of the wrong size": mct(2, 2, 1, [1, 2]) + mcc(1, 3, 0, 2) + mco(1),
    "MCC of an absent MCT": mcc(1, 3, 7, 0) + mco(1),
    "MCO of a wrong length": _seg(0xFF77, bytes([1])),
    "MCT too short": _seg(0xFF74, bytes(4)),
    "CBD of other components": cbd([7] * 2),
    "CBD of 32 bits": cbd([31] * 3),
}


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("name", list(READ))
def test_part2_markers_read_as_pil(tmp_path, name, irreversible):
    """Each in the main header, and (not CBD, a main-header marker) in the
    first tile-part's header, of two sizes."""
    path = str(tmp_path / "m.j2k")
    for img in (IMG, ODD):
        for where in (("main", "tile") if not name.startswith("CBD") else ("main",)):
            data = with_markers(img, irreversible=irreversible,
                                **{where: READ[name]})
            with open(path, "wb") as f:
                f.write(data)
            _check(path)


@pytest.mark.parametrize("name", list(FAIL))
def test_part2_markers_pil_fails_on(tmp_path, name):
    path = str(tmp_path / "f.j2k")
    with open(path, "wb") as f:
        f.write(with_markers(IMG, main=FAIL[name]))
    _both_raise(path)
    with pytest.raises(ValueError, match="PIL fails on it"):
        tio.read_image(path)


def test_a_custom_transform_fails_as_in_pil(tmp_path):
    """COD's multiple component transform 2, a custom one (what OpenJPEG's
    ``opj_set_MCT`` makes its encoder write), with its markers: OpenJPEG's
    reader refuses it."""
    path = str(tmp_path / "c.j2k")
    with open(path, "wb") as f:
        f.write(with_markers(IMG, main=READ["int32 offsets"], cod_mct=2))
    _both_raise(path)
    with pytest.raises(ValueError, match="Invalid multiple component transformation"):
        tio.read_image(path)


def mixed_wavelets(img, irreversible, comps) -> bytes:
    """PIL's three-component codestream under the Part 1 transform, with a
    COC giving each of ``comps`` the other wavelet."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", irreversible=irreversible, mct=1)
    d = buf.getvalue()
    i = d.index(b"\xff\x52")
    (n,) = struct.unpack(">H", d[i + 2:i + 4])
    scod, spcod = d[i + 4], d[i + 9:i + 2 + n]
    coc = b"".join(_seg(0xFF53, bytes([c, scod & 1]) + spcod[:4] + bytes([1 - spcod[4]])
                        + spcod[5:]) for c in comps)
    s = d.index(b"\xff\x90")
    return d[:s] + coc + d[s:]


@pytest.mark.parametrize("irreversible", [False, True], ids=["53 RCT", "97 ICT"])
@pytest.mark.parametrize("comps", [(1, 2), (1,), (2,), (0,)])
def test_mixed_wavelets_under_mct(tmp_path, irreversible, comps):
    path = str(tmp_path / "x.j2k")
    for img in (IMG, ODD):
        with open(path, "wb") as f:
            f.write(mixed_wavelets(img, irreversible, comps))
        _check(path)


# ------------------------------------------------------ the card's input
def make_part2_inputs(d: str) -> None:
    with open(os.path.join(d, "part2_mco_offsets.j2k"), "wb") as f:
        f.write(with_markers(_pattern(120, 160, noise=0.05, seed=50), irreversible=True,
                             main=mct(1, 1, 2, [1, 0, 0, 0, 1, 0, 0, 0, 1])
                             + mct(2, 2, 1, [100, 140, 90]) + mcc(1, 3, 1, 2) + mco(1)))
