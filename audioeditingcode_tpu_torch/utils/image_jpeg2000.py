"""JPEG 2000 decoding (JP2 files and raw J2K codestreams) for
``image_io.read_image``, numpy and the standard library only, bit-equal to
PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``, which decodes
through OpenJPEG 2.5.4 at full resolution with every quality layer.

- ``header``: PIL's ``Jpeg2KImageFile._open``. A codestream's mode comes
  from SIZ (Csiz 1: L, or I;16 past 8 bits; 2: LA; 3: RGB; 4: RGBA; more:
  passed on); a JP2 file's from the ``ihdr`` box inside ``jp2h`` (I;16
  past 9 bits there), ``colr`` enumcs 12 with four components making it
  CMYK and a ``pclr`` of at most 8 bits making L or LA into P or PA, its
  entries gathered as ``ImagePalette.getcolor`` gathers them. Boxes are
  walked as PIL's ``BoxReader`` walks them (XL lengths; a box that does
  not fit, or one of length 0 before ``jp2h``, passes the file on; a file
  that ends first fails).
- The decode is OpenJPEG's: the JP2 boxes as ``jp2.c`` reads them (the
  colour space from ``colr``: 16 sRGB, 17 grey, 18 sYCC, 24 eYCC, 12 CMYK;
  any other, an ICC profile or none leaves it unspecified), the main header (SIZ, COD, COC, QCD, QCC, RGN,
  POC, PPM, TLM, PLM, CRG, COM, and Part 2's MCT, MCC, MCO and CBD, which
  set DC level shifts and component depths and run no transform:
  ``_read_mco``; unknown markers skipped as ``read_unk`` does), tile-parts (SOT, with a tile split over several in order; COD,
  COC, QCD, QCC, RGN, POC, PPT, PLT and COM in their headers; SOD), tier-2
  (``tier2``: the five progression orders and POC, precincts, the two tag
  trees, pass counts, Lblock, segment lengths, SOP/EPH, packed headers
  from PPM or PPT; a missing EPH fails, a missing SOP does not), tier-1 (``image_j2k_t1``), dequantisation (5/3: C's
  integer half; 9/7: float32 times half the step 2**(prec - e) (1 +
  m / 2048) as OpenJPEG computes it; the scalar-derived steps of each
  level as ``j2k.c`` derives them), the inverse transforms
  (``image_j2k_dwt``), RCT or ICT where COD asks for it (run on the bits
  of a component of the other wavelet, as OpenJPEG does), and the DC level
  shift (9/7: rounded half to even, as ``lrintf``) clamped to the
  component's range. Where OpenJPEG fails (strict mode: a code-block
  segment past the data, a marker out of place, a bad SIZ), so does this,
  with a ``ValueError`` that names the cause.
- PIL's unpack of each tile into its mode (``Jpeg2KDecode.c``): the
  unpacker is picked by mode, colour space (unspecified: grey for 1-2
  components, sRGB for 3-4, sYCC where component 0 is full size and 1 or
  2 subsampled) and component count; each sample of a
  component of ``prec`` bits is stored as OpenJPEG stores it (1, 2 or 4
  bytes), offset by 2**(prec - 1) if signed and shifted to 8 bits (16 for
  I;16) with the half added before a right shift; subsampled components
  are read at (x // dx, y // dy) with PIL's row length w // dx and plane
  offsets (past a tile's data, zeros); sYCC goes
  through PIL's YCbCr -> RGB. Then ``convert("RGB")``: L and LA repeated,
  I;16 clamped, CMYK by ``image_io.cmyk_to_rgb``, P and PA through the
  palette (entries gathered as PIL gathers them, black past them).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .image_identify import PassOn, check_size
from .image_j2k_dwt import inverse_dwt, inverse_ict, inverse_rct
from .image_j2k_t1 import LAZY, TERMALL, decode_block

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
_GRAY, _SRGB, _SYCC, _EYCC, _CMYK, _UNSPECIFIED = "grey", "sRGB", "sYCC", "eYCC", "CMYK", \
    "unspecified"
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}
_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRP", "CPRL")


class _Fail(ValueError):
    """OpenJPEG (or PIL) fails on the data."""


# ------------------------------------------------------------ PIL's header
class _Boxes:
    """PIL's ``BoxReader`` over ``data[start:end]`` (``end`` None: a reader
    without a length, as the top level is)."""

    def __init__(self, data: bytes, pos: int, length: Optional[int] = None):
        self.data, self.pos, self.base = data, pos, pos
        self.length = length
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.length is not None and self.pos - self.base + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise PassOn("Not enough data in header")
        got = self.data[self.pos:self.pos + n]
        if self.length is None and len(got) < n:
            raise _Fail(f"Expected to read {n} bytes but only got {len(got)}")
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return got

    def fields(self, fmt: str):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def sub(self) -> "_Boxes":
        size = self.remaining
        start = self.pos
        self.read(size)
        return _Boxes(self.data[:start + size], start, size)

    def has_next(self) -> bool:
        if self.length is None:
            return True
        return self.pos - self.base + self.remaining < self.length

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise PassOn("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _palette(entries: List[Tuple[int, ...]], npc: int) -> Tuple[str, bytes]:
    """``ImagePalette.getcolor`` on each entry in turn (a colour already
    present is not added again): the palette's mode and bytes."""
    mode = "RGBA" if npc == 4 else "RGB"
    size = len(mode)
    colors: Dict[Tuple[int, ...], int] = {}
    pal = bytearray()
    for color in entries:
        if mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise _Fail("cannot add non-opaque RGBA color to RGB palette")
            color = color[:3]
        elif mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in colors:
            continue
        index = len(pal) // size
        if index >= 256:
            raise _Fail("JP2 palette of more than 256 colours (PIL fails on it: cannot allocate "
                        "more than 256 colors)")
        colors[color] = index
        pal += bytes(color)
    return mode, bytes(pal)


def _jp2_header(data: bytes) -> dict:
    """PIL's ``_parse_jp2_header`` after the signature box."""
    top = _Boxes(data, 12)
    header = None
    while top.has_next():
        tbox = top.next_type()
        if tbox == b"jp2h":
            header = top.sub()
            break
        if tbox == b"ftyp":
            top.fields(">4s")
    size = mode = nc = palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(
                nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                palette = _palette([header.fields(">" + "B" * npc) for _ in range(ne)], npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise PassOn("Malformed JP2 header")
    return {"size": size, "mode": mode, "palette": palette, "end": top.pos}


def _comments(data: bytes, pos: int) -> None:
    """PIL's ``_parse_comment``: markers walked up to SOT, EOC or COM."""
    while True:
        marker = data[pos:pos + 2]
        pos += len(marker)
        if not marker:
            return
        typ = marker[1]
        if typ in (0x90, 0xD9):
            return
        hdr = data[pos:pos + 2]
        pos += len(hdr)
        (length,) = struct.unpack(">H", hdr)
        if typ == 0x64:
            return
        pos += length - 2
        if pos < 0:
            raise _Fail("seek before the start of the file")


def header(data: bytes, path: str) -> dict:
    """PIL's ``Jpeg2KImageFile._open``: {"codec", "size", "mode",
    "palette"}; raises ``PassOn`` where PIL passes the file on."""
    try:
        return _header(data, path)
    except _Fail as e:
        raise ValueError(f"{path}: JPEG 2000 header PIL fails on ({e})") from None


def _header(data: bytes, path: str) -> dict:
    if data[:4] == J2K_SIGNATURE:
        (lsiz,) = struct.unpack(">H", data[4:6])
        end = 4 + lsiz if lsiz >= 2 else len(data)  # PIL reads Lsiz - 2 more bytes
        siz = data[4:end]
        _, _, xsiz, ysiz, xo, yo, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
        size = (xsiz - xo, ysiz - yo)
        if csiz == 1:
            mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise PassOn("unable to determine J2K image mode")
        _comments(data, end)
        head = {"codec": "j2k", "size": size, "mode": mode, "palette": None}
    elif data[:12] == JP2_SIGNATURE:
        jp2 = _jp2_header(data)
        head = {"codec": "jp2", "size": jp2["size"], "mode": jp2["mode"],
                "palette": jp2["palette"]}
        pos = jp2["end"]
        if data[pos:pos + 12].endswith(b"jp2c\xff\x4f\xff\x51"):
            (length,) = struct.unpack(">H", data[pos + 12:pos + 14])
            _comments(data, pos + 12 + length)
    else:
        raise PassOn("not a JPEG 2000 file")
    if head["size"][0] <= 0 or head["size"][1] <= 0:
        raise PassOn("size of 0")
    check_size(*head["size"], path)
    return head


# ------------------------------------------------------- OpenJPEG's JP2
def _jp2_boxes(data: bytes) -> Tuple[int, int, str]:
    """``opj_jp2_read_header_procedure``: (codestream start, end, colour
    space)."""
    pos, state, enumcs, has_ihdr, has_jp2h = 0, 0, 0, False, False
    while pos + 8 <= len(data):
        lbox, tbox = struct.unpack(">I4s", data[pos:pos + 8])
        hlen = 8
        if lbox == 1:
            if pos + 16 > len(data):
                break
            lbox, hlen = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        if tbox == b"jp2c":
            if not has_jp2h:
                raise _Fail("bad placed jpeg codestream")
            end = len(data) if lbox == 0 else min(len(data), pos + lbox)
            if not has_ihdr:
                raise _Fail("IHDR box missing")
            return pos + hlen, end, _ENUMCS.get(enumcs, _UNSPECIFIED)
        if lbox == 0:
            raise _Fail("Cannot handle box of undefined sizes")
        if lbox < hlen:
            raise _Fail(f"invalid box size {lbox}")
        body = data[pos + hlen:pos + lbox]
        if len(body) < lbox - hlen:
            raise _Fail(f"Invalid box size {lbox} for box {tbox!r}")
        if tbox == b"jP  ":
            if state != 0 or body != b"\x0d\x0a\x87\x0a":
                raise _Fail("The signature box must be the first box in the file")
            state = 1
        elif tbox == b"ftyp":
            if state != 1 or len(body) < 8 or (len(body) - 8) % 4:
                raise _Fail("Malformed JP2 file format: bad file type box")
            state = 2
        elif tbox == b"jp2h":
            if state != 2:
                raise _Fail("The jp2h box must come after the file type box")
            enumcs_seen, sub = False, 0
            while sub + 8 <= len(body):
                slen, stype = struct.unpack(">I4s", body[sub:sub + 8])
                if slen < 8 or slen > len(body) - sub:
                    raise _Fail("Stream error while reading JP2 Header box: box length is "
                                "inconsistent")
                sbody = body[sub + 8:sub + slen]
                if stype == b"ihdr" and not has_ihdr:
                    if len(sbody) != 14:
                        raise _Fail("Bad image header box (bad size)")
                    h, w, nc = struct.unpack(">IIH", sbody[:10])
                    if not h or not w or not nc or nc > 16384:
                        raise _Fail(f"Wrong values for: w({w}) h({h}) numcomps({nc}) (ihdr)")
                    has_ihdr = True
                elif stype == b"colr" and not enumcs_seen:
                    if len(sbody) < 3:
                        raise _Fail("Bad COLR header box (bad size)")
                    if sbody[0] == 1:
                        if len(sbody) < 7:
                            raise _Fail("Bad COLR header box (bad size)")
                        (enumcs,) = struct.unpack(">I", sbody[3:7])
                    enumcs_seen = True
                sub += slen
            if not has_ihdr:
                raise _Fail("Stream error while reading JP2 Header box: no 'ihdr' box")
            has_jp2h = True
        elif tbox in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef"):
            pass  # misplaced outside jp2h: ignored before it, read after it
        elif state < 2:
            raise _Fail("Malformed JP2 file format: the signature and file type boxes come "
                        "first")
        pos += lbox
    raise _Fail("JP2 file without a codestream box")


# ------------------------------------------------------ the codestream
class _Tccp:
    """A component's coding style and quantisation (OpenJPEG's tccp)."""

    def __init__(self):
        self.numres = 1
        self.cblkw = self.cblkh = 2
        self.cblksty = 0
        self.qmfbid = 0
        self.prcw = [15] * 33
        self.prch = [15] * 33
        self.qntsty = 0
        self.numgbits = 0
        self.steps = [(0, 0)] * 97
        self.roishift = 0
        self.dc_shift = None  # set by an MCO marker; None: the SIZ default

    def copy(self) -> "_Tccp":
        c = _Tccp()
        c.__dict__.update({k: (list(v) if isinstance(v, list) else v)
                           for k, v in self.__dict__.items()})
        return c


class _Tcp:
    """A tile's coding parameters (OpenJPEG's tcp)."""

    def __init__(self, ncomp: int):
        self.csty = 0
        self.prg = 0
        self.numlayers = 1
        self.mct = 0
        self.tccps = [_Tccp() for _ in range(ncomp)]
        self.pocs: List[tuple] = []
        self.ppt: Dict[int, bytes] = {}
        self.parts: List[bytes] = []
        self.nparts = 0
        # Part 2's MCT records [index, array type, element type, data] and MCC
        # records [index, components, decorrelation record, offset record]
        self.mct_records: List[list] = []
        self.mcc_records: List[list] = []

    def copy(self) -> "_Tcp":
        t = _Tcp(0)
        t.csty, t.prg, t.numlayers, t.mct = self.csty, self.prg, self.numlayers, self.mct
        t.tccps = [c.copy() for c in self.tccps]
        t.pocs = list(self.pocs)
        new = {id(r): list(r) for r in self.mct_records}
        t.mct_records = list(new.values())
        t.mcc_records = [[i, n, d and new[id(d)], o and new[id(o)]]
                         for i, n, d, o in self.mcc_records]
        return t


class _Stream:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def u16(self) -> int:
        if self.pos + 2 > self.end:
            raise _Fail("Stream too short")
        v = (self.data[self.pos] << 8) | self.data[self.pos + 1]
        self.pos += 2
        return v

    def segment(self) -> bytes:
        n = self.u16()
        if n < 2:
            raise _Fail("Invalid marker size")
        if self.pos + n - 2 > self.end:
            raise _Fail("Stream too short")
        body = self.data[self.pos:self.pos + n - 2]
        self.pos += n - 2
        return body


_MAIN = {0xFF52: "COD", 0xFF53: "COC", 0xFF5C: "QCD", 0xFF5D: "QCC", 0xFF5E: "RGN",
         0xFF5F: "POC", 0xFF60: "PPM", 0xFF55: "TLM", 0xFF57: "PLM", 0xFF63: "CRG",
         0xFF64: "COM", 0xFF50: "CAP", 0xFF74: "MCT", 0xFF75: "MCC", 0xFF77: "MCO",
         0xFF78: "CBD"}
_TILE = {0xFF52: "COD", 0xFF53: "COC", 0xFF5C: "QCD", 0xFF5D: "QCC", 0xFF5E: "RGN",
         0xFF5F: "POC", 0xFF61: "PPT", 0xFF58: "PLT", 0xFF64: "COM", 0xFF93: "SOD",
         0xFF74: "MCT", 0xFF75: "MCC", 0xFF77: "MCO"}
_KNOWN = set(_MAIN) | set(_TILE) | {0xFF4F, 0xFF51, 0xFF90, 0xFFD9, 0xFF91, 0xFF92}


class _Codestream:
    """A J2K codestream's headers and tile-parts, read as OpenJPEG's
    ``j2k.c`` reads them."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data = data
        s = _Stream(data, start, end)
        if s.u16() != 0xFF4F:
            raise _Fail("Expected a SOC marker")
        if s.u16() != 0xFF51:
            raise _Fail("the first marker after SOC is not SIZ")
        self._siz(s.segment())
        self.default = _Tcp(self.ncomp)
        self.ppm: Dict[int, bytes] = {}
        seen = set()
        marker = s.u16()
        while marker != 0xFF90:
            if marker < 0xFF00:
                raise _Fail(f"A marker ID was expected (0xff--) instead of {marker:#x}")
            if marker not in _MAIN:
                if marker in _KNOWN:
                    raise _Fail(f"marker {marker:#x} in the main header (not compliant with "
                                f"its position)")
                marker = self._unknown(s, _MAIN)
                continue
            body = s.segment()
            name = _MAIN[marker]
            seen.add(name)
            self._marker(name, body, self.default)
            marker = s.u16()
        for name in ("COD", "QCD"):
            if name not in seen:
                raise _Fail(f"required {name} marker not found in main header")
        self.ppm_data = self._merge_ppm() if self.ppm else None
        self.tiles: List[_Tcp] = [self.default.copy() for _ in range(self.tw * self.th)]
        self.order: List[int] = []
        self._tile_parts(s)

    def _siz(self, b: bytes) -> None:
        if len(b) < 36:
            raise _Fail("Error with SIZ marker size")
        (_, x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc) = struct.unpack(">HIIIIIIIIH", b[:36])
        if len(b) - 36 != nc * 3 or not 1 <= nc <= 16384:
            raise _Fail("Error with SIZ marker size")
        if x0 >= x1 or y0 >= y1:
            raise _Fail(f"Error with SIZ marker: negative or zero image size ({x1 - x0} x "
                        f"{y1 - y0})")
        if not tdx or not tdy:
            raise _Fail("Error with SIZ marker: invalid tile size")
        if tx0 > x0 or ty0 > y0 or tx0 + tdx <= x0 or ty0 + tdy <= y0:
            raise _Fail("Error with SIZ marker: illegal tile offset")
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.tdx, self.tdy, self.tx0, self.ty0 = tdx, tdy, tx0, ty0
        self.ncomp = nc
        self.comps = []
        for i in range(nc):
            ssiz, dx, dy = b[36 + 3 * i:39 + 3 * i]
            prec, sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
            if not dx or not dy:
                raise _Fail(f"Invalid values for comp = {i}: dx={dx} dy={dy}")
            if prec > 31:
                raise _Fail(f"component of {prec} bits (OpenJPEG supports up to 31)")
            self.comps.append({"prec": prec, "sgnd": sgnd, "dx": dx, "dy": dy,
                               "shift": 0 if sgnd else 1 << (prec - 1)})
        self.tw = -(-(x1 - tx0) // tdx)
        self.th = -(-(y1 - ty0) // tdy)
        if self.tw * self.th > 65535:
            raise _Fail(f"{self.tw * self.th} tiles (OpenJPEG allows 65535)")

    def _unknown(self, s: _Stream, allowed) -> int:
        """``opj_j2k_read_unk``: 16-bit words up to the next known marker."""
        while True:
            m = s.u16()
            if m >= 0xFF00 and m in _KNOWN:
                if m not in allowed and m not in (0xFF90, 0xFFD9):
                    raise _Fail("Marker is not compliant with its position")
                return m

    def _comp_index(self, b: bytes, pos: int) -> Tuple[int, int]:
        if self.ncomp <= 256:
            return b[pos], pos + 1
        return (b[pos] << 8) | b[pos + 1], pos + 2

    def _spcod(self, tccp: _Tccp, b: bytes, pos: int, precincts: bool) -> int:
        if len(b) < pos + 5:
            raise _Fail("Error reading SPCod SPCoc element")
        numres = b[pos] + 1
        if numres > 33:
            raise _Fail(f"{numres - 1} decomposition levels (OpenJPEG allows 32)")
        cblkw, cblkh, cblksty, qmfbid = b[pos + 1] + 2, b[pos + 2] + 2, b[pos + 3], b[pos + 4]
        if cblkw > 10 or cblkh > 10 or cblkw + cblkh > 12:
            raise _Fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination")
        if cblksty & 0x40:
            raise ValueError("JPEG 2000 with HT (Part 15) code-blocks, which the port does not "
                             "read")
        if cblksty & 0x80:
            raise _Fail("Error reading SPCod SPCoc element, Invalid code-block style found")
        if qmfbid > 1:
            raise _Fail("Error reading SPCod SPCoc element, Invalid transformation found")
        pos += 5
        tccp.numres, tccp.cblkw, tccp.cblkh = numres, cblkw, cblkh
        tccp.cblksty, tccp.qmfbid = cblksty, qmfbid
        if precincts:
            if len(b) < pos + numres:
                raise _Fail("Error reading SPCod SPCoc element")
            for r in range(numres):
                v = b[pos + r]
                if r and (not v & 15 or not v >> 4):
                    raise _Fail("Invalid precinct size")
                tccp.prcw[r], tccp.prch[r] = v & 15, v >> 4
            pos += numres
        else:
            tccp.prcw = [15] * 33
            tccp.prch = [15] * 33
        return pos

    def _sqcd(self, tccp: _Tccp, b: bytes, pos: int) -> int:
        if len(b) < pos + 1:
            raise _Fail("Error reading SQcd or SQcc element")
        tccp.qntsty, tccp.numgbits = b[pos] & 31, b[pos] >> 5
        pos += 1
        left = len(b) - pos
        if tccp.qntsty == 1:
            nb = 1
        elif tccp.qntsty == 0:
            nb = left
        else:
            nb = left // 2
        steps = [(0, 0)] * 97
        for i in range(nb):
            if tccp.qntsty == 0:
                v = b[pos]
                pos += 1
                if i < 97:
                    steps[i] = (v >> 3, 0)
            else:
                if pos + 2 > len(b):
                    raise _Fail("Error reading SQcd or SQcc element")
                v = (b[pos] << 8) | b[pos + 1]
                pos += 2
                if i < 97:
                    steps[i] = (v >> 11, v & 0x7FF)
        if tccp.qntsty == 1:
            e0, m0 = steps[0]
            steps = [(e0, m0)] + [(max(e0 - (i - 1) // 3, 0), m0) for i in range(1, 97)]
        tccp.steps = steps
        return pos

    def _marker(self, name: str, b: bytes, tcp: _Tcp) -> None:
        if name == "COD":
            if len(b) < 5:
                raise _Fail("Error reading COD marker")
            tcp.csty, tcp.prg, tcp.numlayers, tcp.mct = b[0], b[1], (b[2] << 8) | b[3], b[4]
            if tcp.prg > 4:
                raise _Fail("Unknown progression order in COD marker")
            if not tcp.numlayers:
                raise _Fail("Invalid number of layers in COD marker : 0")
            if tcp.mct > 1:
                raise _Fail("Invalid multiple component transformation")
            t0 = tcp.tccps[0]
            if self._spcod(t0, b, 5, bool(b[0] & 1)) != len(b):
                raise _Fail("Error reading COD marker")
            for t in tcp.tccps[1:]:
                t.numres, t.cblkw, t.cblkh = t0.numres, t0.cblkw, t0.cblkh
                t.cblksty, t.qmfbid = t0.cblksty, t0.qmfbid
                t.prcw, t.prch = list(t0.prcw), list(t0.prch)
        elif name == "COC":
            c, pos = self._comp_index(b, 0)
            if c >= self.ncomp:
                raise _Fail("Error reading COC marker (bad number of components)")
            tccp = tcp.tccps[c]
            if self._spcod(tccp, b, pos + 1, bool(b[pos] & 1)) != len(b):
                raise _Fail("Error reading COC marker")
        elif name == "QCD":
            t0 = tcp.tccps[0]
            if self._sqcd(t0, b, 0) != len(b):
                raise _Fail("Error reading QCD marker")
            for t in tcp.tccps[1:]:
                t.qntsty, t.numgbits, t.steps = t0.qntsty, t0.numgbits, list(t0.steps)
        elif name == "QCC":
            c, pos = self._comp_index(b, 0)
            if c >= self.ncomp:
                raise _Fail("Invalid component number in QCC marker")
            if self._sqcd(tcp.tccps[c], b, pos) != len(b):
                raise _Fail("Error reading QCC marker")
        elif name == "RGN":
            c, pos = self._comp_index(b, 0)
            if len(b) != pos + 2 or c >= self.ncomp:
                raise _Fail("Error reading RGN marker")
            tcp.tccps[c].roishift = b[pos + 1]
        elif name == "POC":
            room = 1 if self.ncomp <= 256 else 2
            step = 5 + 2 * room
            if len(b) < step or len(b) % step:
                raise _Fail("Error reading POC marker")
            for i in range(0, len(b), step):
                r0 = b[i]
                c0, p = self._comp_index(b, i + 1)
                l1 = min((b[p] << 8) | b[p + 1], tcp.numlayers)
                r1 = b[p + 2]
                c1, p = self._comp_index(b, p + 3)
                tcp.pocs.append((r0, c0, l1, r1, min(c1, self.ncomp), b[p]))
        elif name == "PPM":
            if not b:
                raise _Fail("Error reading PPM marker")
            if b[0] in self.ppm:
                raise _Fail(f"Zppm {b[0]} already read")
            self.ppm[b[0]] = b[1:]
        elif name == "PPT":
            if not b:
                raise _Fail("Error reading PPT marker")
            if self.ppm:
                raise _Fail("Error reading PPT marker: packet header have been previously "
                            "found in the main header (PPM marker)")
            if b[0] in tcp.ppt:
                raise _Fail(f"Zppt {b[0]} already read")
            tcp.ppt[b[0]] = b[1:]
        elif name == "MCT":
            _read_mct(b, tcp)
        elif name == "MCC":
            _read_mcc(b, tcp)
        elif name == "MCO":
            _read_mco(b, tcp, self.ncomp)
        elif name == "CBD":
            if len(b) != self.ncomp + 2 or (b[0] << 8 | b[1]) != self.ncomp:
                raise _Fail("Error reading CBD marker")
            for comp, depth in zip(self.comps, b[2:]):
                comp["sgnd"], comp["prec"] = depth >> 7, (depth & 0x7F) + 1
                if comp["prec"] > 31:
                    raise _Fail(f"component of {comp['prec']} bits in CBD (OpenJPEG supports "
                                f"up to 31)")

    def _merge_ppm(self) -> bytes:
        """``opj_j2k_merge_ppm``: the packet headers without their Nppm
        lengths, in Zppm order."""
        out, left = bytearray(), 0
        for z in sorted(self.ppm):
            d = self.ppm[z]
            if left >= len(d):
                left -= len(d)
                out += d
                continue
            out += d[:left]
            d = d[left:]
            left = 0
            while d:
                if len(d) < 4:
                    raise _Fail("Not enough bytes to read Nppm")
                (n,) = struct.unpack(">I", d[:4])
                d = d[4:]
                out += d[:n]
                if len(d) >= n:
                    d = d[n:]
                else:
                    left = n - len(d)
                    d = b""
        if left:
            raise _Fail("Corrupted PPM markers")
        return bytes(out)

    def _tile_parts(self, s: _Stream) -> None:
        """SOT, its tile-part header, SOD and the data, up to EOC, as
        ``opj_j2k_read_tile_header`` and ``opj_j2k_decode_tile`` read them
        for PIL: every tile-part in full, each followed by SOT or EOC (a
        stream that ends first fails, in PIL's tile-by-tile decode). A tile
        is decoded once its last tile-part is read; tiles whose number of
        tile-parts is not given, at EOC in tile order."""
        ntiles = self.tw * self.th
        seen_part = [-1] * ntiles
        while True:
            body = s.segment()
            if len(body) != 8:
                raise _Fail("Error reading SOT marker")
            tile, psot, tpsot, tnsot = struct.unpack(">HIBB", body)
            if tile >= ntiles:
                raise _Fail(f"Invalid tile number {tile}")
            if psot and psot < 14:
                raise _Fail(f"Psot value ({psot}) is not correct regards to the JPEG2000 norm")
            tcp = self.tiles[tile]
            if seen_part[tile] + 1 != tpsot:
                raise _Fail(f"Invalid tile part index for tile number {tile}")
            if tcp.nparts and tpsot >= tcp.nparts:
                raise _Fail(f"In SOT marker, TPSot ({tpsot}) is not valid regards to the "
                            f"current number of tile-part ({tcp.nparts})")
            if tnsot:
                if tcp.nparts and tcp.nparts != tnsot:
                    raise _Fail(f"Invalid number of tile-parts for tile number {tile}")
                tcp.nparts = tnsot
            seen_part[tile] = tpsot
            left = psot - 12 if psot else None
            marker = s.u16()
            while marker != 0xFF93:
                name = _TILE.get(marker)
                if name is None:
                    raise _Fail(f"marker {marker:#x} in a tile-part header (not compliant with "
                                f"its position)")
                b = s.segment()
                if left is not None:
                    if left < len(b) + 4:
                        raise _Fail("Sot length is less than marker size + marker ID")
                    left -= len(b) + 4
                self._marker(name, b, tcp)
                marker = s.u16()
            n = max(left - 2, 0) if left is not None else s.end - s.pos - 2
            if s.pos + n > s.end:
                raise _Fail("the data ends inside a tile-part")
            tcp.parts.append(self.data[s.pos:s.pos + n])
            s.pos += n
            if tcp.nparts and tpsot == tcp.nparts - 1:
                self.order.append(tile)
            if s.end - s.pos < 2:
                raise _Fail("Stream too short (no EOC)")
            marker = s.u16()
            if marker == 0xFFD9:
                break
            if marker != 0xFF90:
                raise _Fail(f"marker {marker:#x} after a tile-part (expected SOT or EOC)")
        for t in range(ntiles):
            if self.tiles[t].parts and t not in self.order:
                self.order.append(t)


# ------------------------------------------------------------- tier-2
def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceildivpow2(a: int, b: int) -> int:
    return -(-a >> b)


class _Bits:
    """OpenJPEG's packet header bit reader (``bio.c``): after 0xFF only 7
    bits of the next byte; past the end, zeros."""

    __slots__ = ("d", "pos", "end", "buf", "ct", "start")

    def __init__(self, d: bytes, pos: int, end: int):
        self.d, self.pos, self.end, self.start = d, pos, end, pos
        self.buf = self.ct = 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.d[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> bool:
        ok = True
        if (self.buf & 0xFF) == 0xFF:
            ok = self.pos < self.end
            self._bytein()
        self.ct = 0
        return ok


class _TagTree:
    """``tgt.c``: a tag tree over w x h leaves, decoded against thresholds."""

    def __init__(self, w: int, h: int):
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            pw, ph = sizes[-1]
            sizes.append(((pw + 1) // 2, (ph + 1) // 2))
        base = []
        n = 0
        for lw, lh in sizes:
            base.append(n)
            n += lw * lh
        parent = [-1] * n
        for lev in range(len(sizes) - 1):
            lw, lh = sizes[lev]
            nw = sizes[lev + 1][0]
            for y in range(lh):
                for x in range(lw):
                    parent[base[lev] + y * lw + x] = base[lev + 1] + (y // 2) * nw + x // 2
        self.parent = parent
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio: _Bits, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return int(value[node] < threshold)


class _Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "lenbits", "segs", "data")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.lenbits = 3
        self.segs: List[list] = []  # [length, passes, max passes]
        self.data = bytearray()


class _Band:
    def __init__(self, bandno, x0, y0, x1, y1, numbps, stepsize):
        self.bandno, self.x0, self.y0, self.x1, self.y1 = bandno, x0, y0, x1, y1
        self.numbps, self.stepsize = numbps, stepsize
        self.precincts: List[dict] = []

    def empty(self) -> bool:
        return self.x1 == self.x0 or self.y1 == self.y0


class _Res:
    def __init__(self, x0, y0, x1, y1, pdx, pdy):
        self.x0, self.y0, self.x1, self.y1, self.pdx, self.pdy = x0, y0, x1, y1, pdx, pdy
        self.pw = self.ph = 0
        self.bands: List[_Band] = []


def _resolutions(tc: Tuple[int, int, int, int], tccp: _Tccp, comp: dict) -> List[_Res]:
    """``opj_tcd_init_tile`` for one tile-component: resolutions, bands,
    precincts and code-blocks."""
    tcx0, tcy0, tcx1, tcy1 = tc
    out = []
    numres = tccp.numres
    for resno in range(numres):
        level = numres - 1 - resno
        r = _Res(_ceildivpow2(tcx0, level), _ceildivpow2(tcy0, level), _ceildivpow2(tcx1, level),
                 _ceildivpow2(tcy1, level), tccp.prcw[resno], tccp.prch[resno])
        pdx, pdy = r.pdx, r.pdy
        tlx, tly = (r.x0 >> pdx) << pdx, (r.y0 >> pdy) << pdy
        brx, bry = _ceildivpow2(r.x1, pdx) << pdx, _ceildivpow2(r.y1, pdy) << pdy
        r.pw = 0 if r.x0 == r.x1 else (brx - tlx) >> pdx
        r.ph = 0 if r.y0 == r.y1 else (bry - tly) >> pdy
        if resno == 0:
            cbgx, cbgy, cbgw, cbgh = tlx, tly, pdx, pdy
            bandnos = [0]
        else:
            cbgx, cbgy, cbgw, cbgh = _ceildivpow2(tlx, 1), _ceildivpow2(tly, 1), pdx - 1, pdy - 1
            bandnos = [1, 2, 3]
        cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
        for bandno in bandnos:
            if resno == 0:
                bx0, by0 = _ceildivpow2(tcx0, level), _ceildivpow2(tcy0, level)
                bx1, by1 = _ceildivpow2(tcx1, level), _ceildivpow2(tcy1, level)
            else:
                xb, yb = bandno & 1, bandno >> 1
                bx0 = _ceildivpow2(tcx0 - (xb << level), level + 1)
                by0 = _ceildivpow2(tcy0 - (yb << level), level + 1)
                bx1 = _ceildivpow2(tcx1 - (xb << level), level + 1)
                by1 = _ceildivpow2(tcy1 - (yb << level), level + 1)
            idx = 0 if resno == 0 else 3 * (resno - 1) + bandno
            expn, mant = tccp.steps[idx]
            rb = comp["prec"]  # OpenJPEG's 9/7 gain is 0 (its 2/K high-pass scale)
            step = np.float32((1.0 + mant / 2048.0) * 2.0 ** (rb - expn))
            band = _Band(bandno, bx0, by0, bx1, by1, expn + tccp.numgbits - 1, step)
            for precno in range(r.pw * r.ph):
                px0 = cbgx + (precno % r.pw) * (1 << cbgw)
                py0 = cbgy + (precno // r.pw) * (1 << cbgh)
                x0, y0 = max(px0, bx0), max(py0, by0)
                x1, y1 = min(px0 + (1 << cbgw), bx1), min(py0 + (1 << cbgh), by1)
                tcx, tcy = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                # C's unsigned counts (a precinct past its band's end wraps)
                cw = (((_ceildivpow2(x1, cbw) << cbw) - tcx) >> cbw) & 0xFFFFFFFF
                ch = (((_ceildivpow2(y1, cbh) << cbh) - tcy) >> cbh) & 0xFFFFFFFF
                n = (cw * ch) & 0xFFFFFFFF
                if n > 1 << 24:
                    raise _Fail(f"precinct of {n} code-blocks (OpenJPEG cannot allocate them)")
                cblks = []
                for k in range(n):
                    cx0 = tcx + (k % cw) * (1 << cbw)
                    cy0 = tcy + (k // cw) * (1 << cbh)
                    cblks.append(_Cblk(max(cx0, x0), max(cy0, y0), min(cx0 + (1 << cbw), x1),
                                       min(cy0 + (1 << cbh), y1)))
                band.precincts.append({"cw": cw, "ch": ch, "n": n, "cblks": cblks,
                                       "incl": _TagTree(cw, ch) if n else None,
                                       "imsb": _TagTree(cw, ch) if n else None})
            r.bands.append(band)
        out.append(r)
    return out


def _packets(cs: _Codestream, tcp: _Tcp, tile: Tuple[int, int, int, int], comps: List[dict],
             res: List[List[_Res]]):
    """``pi.c``: (layer, resolution, component, precinct) of each packet in
    the order the tile's progression (or its POC) gives, each once."""
    tx0, ty0, tx1, ty1 = tile
    nc = cs.ncomp
    maxres = max(t.numres for t in tcp.tccps)
    if tcp.pocs:
        progs = [(p[5], p[0], p[3], p[1], p[4], p[2]) for p in tcp.pocs]
    else:
        progs = [(tcp.prg, 0, maxres, 0, nc, tcp.numlayers)]
    done = set()

    def emit(l, r, c, p):
        key = (l, r, c, p)
        if key in done:
            return None
        done.add(key)
        return key

    def steps(compnos):
        dx = dy = 0
        for c in compnos:
            n = tcp.tccps[c].numres
            for r in range(n):
                rr = res[c][r]
                ex, ey = rr.pdx + n - 1 - r, rr.pdy + n - 1 - r
                if ex < 32:
                    v = comps[c]["dx"] << ex
                    dx = v if not dx else min(dx, v)
                if ey < 32:
                    v = comps[c]["dy"] << ey
                    dy = v if not dy else min(dy, v)
        return dx, dy

    def precinct_at(c, r, x, y):
        """The precinct of (c, r) that starts at position (x, y), or None."""
        comp, n = comps[c], tcp.tccps[c].numres
        if r >= n:
            return None
        rr = res[c][r]
        level = n - 1 - r
        trx0, try0 = _ceildiv(tx0, comp["dx"] << level), _ceildiv(ty0, comp["dy"] << level)
        trx1, try1 = _ceildiv(tx1, comp["dx"] << level), _ceildiv(ty1, comp["dy"] << level)
        rpx, rpy = rr.pdx + level, rr.pdy + level
        if not (y % (comp["dy"] << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (comp["dx"] << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if not rr.pw or not rr.ph or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceildiv(x, comp["dx"] << level) >> rr.pdx) - (trx0 >> rr.pdx)
        prcj = (_ceildiv(y, comp["dy"] << level) >> rr.pdy) - (try0 >> rr.pdy)
        return prci + prcj * rr.pw

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    for prg, r0, r1, c0, c1, l1 in progs:
        if c0 >= nc or c1 > nc:
            continue  # OpenJPEG ends this progression ("invalid compno0/compno1")
        if prg > 4:
            continue
        name = _PROGRESSIONS[prg]
        if name in ("LRCP", "RLCP"):
            if name == "LRCP":
                outer = ((l, r) for l in range(l1) for r in range(r0, r1))
            else:
                outer = ((l, r) for r in range(r0, r1) for l in range(l1))
            for l, r in outer:
                for c in range(c0, c1):
                    if r >= tcp.tccps[c].numres:
                        continue
                    rr = res[c][r]
                    for p in range(rr.pw * rr.ph):
                        if emit(l, r, c, p):
                            yield l, r, c, p
        elif name == "RPCL":
            dx, dy = steps(range(nc))
            if not dx or not dy:
                continue
            for r in range(r0, r1):
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(l1):
                            if emit(l, r, c, p):
                                yield l, r, c, p
        elif name == "PCRP":
            dx, dy = steps(range(nc))
            if not dx or not dy:
                continue
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, tcp.tccps[c].numres)):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(l1):
                            if emit(l, r, c, p):
                                yield l, r, c, p
        else:  # CPRL
            for c in range(c0, c1):
                dx, dy = steps([c])
                if not dx or not dy:
                    break
                for x, y in positions(dx, dy):
                    for r in range(r0, min(r1, tcp.tccps[c].numres)):
                        p = precinct_at(c, r, x, y)
                        if p is None:
                            continue
                        for l in range(l1):
                            if emit(l, r, c, p):
                                yield l, r, c, p


def _numpasses(bio: _Bits) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.bits(2)
    if n != 3:
        return 3 + n
    n = bio.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bio.bits(7)


def _init_seg(segs: List[list], sty: int, first: bool) -> None:
    if sty & TERMALL:
        maxp = 1
    elif sty & LAZY:
        maxp = 10 if first else (2 if segs[-1][2] in (1, 10) else 1)
    else:
        maxp = 109
    segs.append([0, 0, maxp])  # length, passes, max passes


class Tier2:
    """One tile's packets read as ``t2.c`` reads them (given ``spans``, each
    packet's (key, header span, body span) is appended to it)."""

    def __init__(self, cs: _Codestream, tcp: _Tcp, res: List[List[_Res]], data: bytes,
                 headers: Optional[list] = None, spans: Optional[list] = None):
        self.cs, self.tcp, self.res, self.data = cs, tcp, res, data
        self.pos = 0
        self.headers = headers  # [bytes, position] of PPM or PPT headers
        self.spans = spans

    def exhausted(self) -> bool:
        if self.headers is None:
            return self.pos >= len(self.data)
        return self.headers[1] >= len(self.headers[0])

    def packet(self, l: int, r: int, c: int, p: int) -> None:
        tcp, data = self.tcp, self.data
        rr = self.res[c][r]
        sty = tcp.tccps[c].cblksty
        if l == 0:
            for band in rr.bands:
                if not band.empty():
                    prc = band.precincts[p]
                    if prc["n"]:
                        prc["incl"] = _TagTree(prc["cw"], prc["ch"])
                        prc["imsb"] = _TagTree(prc["cw"], prc["ch"])
                    for cb in prc["cblks"]:
                        cb.segs = []
                        cb.data = bytearray()
        start = self.pos
        if tcp.csty & 2 and len(data) - self.pos >= 6 and data[self.pos:self.pos + 2] == \
                b"\xff\x91":
            self.pos += 6
        if self.headers is None:
            hd, hstart, hend = data, self.pos, len(data)
        else:
            hd, hstart = self.headers
            hend = len(hd)
        bio = _Bits(hd, hstart, hend)
        new = []
        present = bio.bit()
        if present:
            for band in rr.bands:
                if band.empty():
                    continue
                prc = band.precincts[p]
                for k, cb in enumerate(prc["cblks"]):
                    if not cb.segs:
                        included = prc["incl"].decode(bio, k, l + 1)
                    else:
                        included = bio.bit()
                    if not included:
                        continue
                    if not cb.segs:
                        i = 0
                        while not prc["imsb"].decode(bio, k, i):
                            i += 1
                        cb.numbps = band.numbps + 1 - i
                        cb.lenbits = 3
                    npasses = _numpasses(bio)
                    inc = 0
                    while bio.bit():
                        inc += 1
                    cb.lenbits += inc
                    segs = cb.segs
                    if not segs:
                        _init_seg(segs, sty, True)
                    elif segs[-1][1] == segs[-1][2]:
                        _init_seg(segs, sty, False)
                    seg = len(segs) - 1
                    lens = []
                    n = npasses
                    while True:
                        take = min(segs[seg][2] - segs[seg][1], n)
                        nbits = cb.lenbits + take.bit_length() - 1
                        if nbits > 32:
                            raise _Fail("packet header: a segment length of more than 32 bits")
                        lens.append((seg, bio.bits(nbits), take))
                        n -= take
                        if n <= 0:
                            break
                        seg += 1
                        _init_seg(segs, sty, False)
                    new.append((cb, lens))
        if not bio.align() and present:
            raise _Fail("packet header: the data ends inside its last byte")
        hpos = bio.pos
        if tcp.csty & 4:  # a missing SOP only warns, a missing EPH fails
            if hend - hpos < 2 or hd[hpos:hpos + 2] != b"\xff\x92":
                raise _Fail("Expected EPH marker")
            hpos += 2
        if self.headers is None:
            self.pos = hpos
        else:
            self.headers[1] = hpos
        body = self.pos
        for cb, lens in new:
            for seg, length, take in lens:
                if self.pos + length > len(data):
                    raise _Fail("read: segment too long for its code-block (the data ends "
                                "first; OpenJPEG's strict mode fails)")
                cb.data += data[self.pos:self.pos + length]
                self.pos += length
                cb.segs[seg][0] += length
                cb.segs[seg][1] += take
        if self.spans is not None:
            self.spans.append(((l, r, c, p), (start if self.headers is None else hstart, hpos),
                               (start if self.headers is not None else body, self.pos)))


def _tile_rect(cs: _Codestream, t: int) -> Tuple[int, int, int, int]:
    p, q = t % cs.tw, t // cs.tw
    return (max(cs.tx0 + p * cs.tdx, cs.x0), max(cs.ty0 + q * cs.tdy, cs.y0),
            min(cs.tx0 + (p + 1) * cs.tdx, cs.x1), min(cs.ty0 + (q + 1) * cs.tdy, cs.y1))


def _decode_tile(cs: _Codestream, t: int, ppm: Optional[list], spans: Optional[list] = None):
    """One tile's components as int64 arrays after the DC level shift and
    clamp (OpenJPEG's ``opj_tcd_decode_tile``)."""
    tcp = cs.tiles[t]
    tile = _tile_rect(cs, t)
    comps = cs.comps
    tcs, res = [], []
    for c, comp in enumerate(comps):
        tc = (_ceildiv(tile[0], comp["dx"]), _ceildiv(tile[1], comp["dy"]),
              _ceildiv(tile[2], comp["dx"]), _ceildiv(tile[3], comp["dy"]))
        tcs.append(tc)
        res.append(_resolutions(tc, tcp.tccps[c], comp))
    data = b"".join(tcp.parts)
    if ppm is not None:
        headers = ppm
    elif tcp.ppt:
        headers = [b"".join(tcp.ppt[z] for z in sorted(tcp.ppt)), 0]
    else:
        headers = None
    t2 = Tier2(cs, tcp, res, data, headers, spans)
    for l, r, c, p in _packets(cs, tcp, tile, comps, res):
        t2.packet(l, r, c, p)
        if t2.exhausted():
            break  # the headers read 0 from here on: every packet left is empty
    out = []
    for c, comp in enumerate(comps):
        tccp = tcp.tccps[c]
        tcx0, tcy0, tcx1, tcy1 = tcs[c]
        w, h = tcx1 - tcx0, tcy1 - tcy0
        rev = tccp.qmfbid == 1
        plane = np.zeros((h, w), np.int64 if rev else np.float32)
        rl = res[c]
        for resno, rr in enumerate(rl):
            for band in rr.bands:
                xoff = rl[resno - 1].x1 - rl[resno - 1].x0 if band.bandno & 1 else 0
                yoff = rl[resno - 1].y1 - rl[resno - 1].y0 if band.bandno & 2 else 0
                orient = band.bandno
                half = np.float32(band.stepsize) * np.float32(0.5)
                for prc in band.precincts:
                    for cb in prc["cblks"]:
                        cw, ch = cb.x1 - cb.x0, cb.y1 - cb.y0
                        if not cb.segs or cw <= 0 or ch <= 0:
                            continue
                        segs, pos = [], 0
                        for length, npasses, _ in cb.segs:
                            segs.append((bytes(cb.data[pos:pos + length]), npasses))
                            pos += length
                        v = decode_block(segs, cw, ch, orient, cb.numbps, tccp.cblksty,
                                         tccp.roishift)
                        x, y = cb.x0 - band.x0 + xoff, cb.y0 - band.y0 + yoff
                        if rev:
                            plane[y:y + ch, x:x + cw] = np.where(v < 0, -((-v) // 2), v // 2)
                        else:
                            plane[y:y + ch, x:x + cw] = v.astype(np.float32) * half
        if w and h:
            plane = inverse_dwt(plane, [(r.x0, r.y0, r.x1, r.y1) for r in rl], rev)
        out.append(plane)
    if tcp.mct and cs.ncomp >= 3:
        if out[0].shape != out[1].shape or out[0].shape != out[2].shape:
            raise _Fail("Tiles don't all have the same dimension. Skip the MCT step.")
        # OpenJPEG runs the transform of component 0's wavelet on the three
        # buffers as they are: a component of the other wavelet enters as the
        # bits of its samples (float32 taken as int32, or the reverse) and
        # leaves as the bits of the transform's output
        floats = [o.dtype == np.float32 for o in out[:3]]
        if tcp.tccps[0].qmfbid == 1:
            y, u, v = (o.view(np.int32).astype(np.int64) if f else o
                       for o, f in zip(out[:3], floats))
            out[:3] = [c.astype(np.int32).view(np.float32) if f else c
                       for c, f in zip(inverse_rct(y, u, v), floats)]
        else:
            y, u, v = (o if f else o.astype(np.int32).view(np.float32)
                       for o, f in zip(out[:3], floats))
            out[:3] = [c if f else c.view(np.int32).astype(np.int64)
                       for c, f in zip(inverse_ict(y, u, v), floats)]
    shifted = []
    for c, comp in enumerate(comps):
        prec, sgnd = comp["prec"], comp["sgnd"]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
        shift = tcp.tccps[c].dc_shift
        shift = comp["shift"] if shift is None else shift
        v = out[c]
        if v.dtype == np.float32:  # lrintf of NaN is the least long
            big = v > np.float32(2 ** 31 - 1)
            small = (v < np.float32(-2 ** 31)) | np.isnan(v)
            r = np.rint(np.where(big | small, 0, v)).astype(np.int64)
            v = np.where(big, hi, np.where(small, lo, np.clip(r + shift, lo, hi)))
        else:  # an int32 sum
            v = np.clip(((v + shift + (1 << 31)) & 0xFFFFFFFF) - (1 << 31), lo, hi)
        shifted.append(v.astype(np.int64))
    return tile, shifted


# ------------------------------------------------ Part 2 component transforms
# OpenJPEG 2.5.4 reads Part 2's MCT, MCC and MCO markers (``j2k.c``) but
# applies no custom transform: a COD asking for one (MCT 2) fails before it.
# What the markers do is the DC level shift: an MCO zeroes every component's
# and its stage's MCC sets them from its offset array.
_MCT_SIZES = (2, 4, 4, 8)  # int16, int32, float32, float64


def _read_mct(b: bytes, tcp: _Tcp) -> None:
    """``opj_j2k_read_mct``: one record of one segment, by its index."""
    if len(b) < 2:
        raise _Fail("Error reading MCT marker")
    if b[0] or b[1]:  # Zmct: records spanning segments are skipped
        return
    if len(b) <= 6:
        raise _Fail("Error reading MCT marker")
    imct, ymct = (b[2] << 8) | b[3], (b[4] << 8) | b[5]
    rec = next((r for r in tcp.mct_records if r[0] == imct & 0xFF), None)
    if rec is None:
        rec = [0, 0, 0, None]
        tcp.mct_records.append(rec)
    rec[:] = [imct & 0xFF, (imct >> 8) & 3, (imct >> 10) & 3, None]
    if not ymct:
        rec[3] = b[6:]


def _read_mcc(b: bytes, tcp: _Tcp) -> None:
    """``opj_j2k_read_mcc``: one collection of array-based decorrelation,
    its components in order in and out, its MCT records by index; anything
    else is skipped (OpenJPEG warns)."""
    if len(b) < 2:
        raise _Fail("Error reading MCC marker")
    if b[0] or b[1]:  # Zmcc: records spanning segments
        return
    if len(b) < 7:
        raise _Fail("Error reading MCC marker")
    if (b[3] << 8 | b[4]) or (b[5] << 8 | b[6]) > 1:  # Ymcc, more than one collection
        return
    rec, pos, left = [b[2], 0, None, None], 7, len(b) - 7

    def components(first: bool) -> bool:
        """Read Nmcc and Cmcc (``first``), or Mmcc and Wmcc: False where
        OpenJPEG skips the segment."""
        nonlocal pos, left
        n = (b[pos] << 8) | b[pos + 1]
        pos += 2
        size, n = 1 + (n >> 15), n & 0x7FFF
        if first:
            rec[1] = n
        elif n != rec[1]:
            return False
        if left < size * n + (2 if first else 3):
            raise _Fail("Error reading MCC marker")
        left -= size * n + (2 if first else 3)
        order = [int.from_bytes(b[pos + size * j:pos + size * (j + 1)], "big")
                 for j in range(n)]
        pos += size * n
        return order == list(range(n))

    for _ in range(b[5] << 8 | b[6]):
        if left < 3:
            raise _Fail("Error reading MCC marker")
        if b[pos] != 1:  # Xmcc: not array-based decorrelation
            return
        pos += 1
        left -= 3
        if not components(True) or not components(False):
            return
        t = int.from_bytes(b[pos:pos + 3], "big")
        pos += 3
        for slot, i in ((2, t & 0xFF), (3, (t >> 8) & 0xFF)):
            if i:
                rec[slot] = next((r for r in tcp.mct_records if r[0] == i), None)
                if rec[slot] is None:
                    raise _Fail("Error reading MCC marker")
    if left:
        raise _Fail("Error reading MCC marker")
    old = next((r for r in tcp.mcc_records if r[0] == rec[0]), None)
    if old is not None:
        old[:] = rec
    else:
        tcp.mcc_records.append(rec)


def _read_mco(b: bytes, tcp: _Tcp, ncomp: int) -> None:
    """``opj_j2k_read_mco`` and ``opj_j2k_add_mct``: one stage; its MCC is
    looked up, as OpenJPEG's loop does, in the first record only."""
    if not b:
        raise _Fail("Error reading MCO marker")
    if b[0] > 1:
        return
    if len(b) != b[0] + 1:
        raise _Fail("Error reading MCO marker")
    for tccp in tcp.tccps:
        tccp.dc_shift = 0
    if not b[0] or not tcp.mcc_records or tcp.mcc_records[0][0] != b[1]:
        return
    _, n, deco, offsets = tcp.mcc_records[0]
    if n != ncomp:
        return
    for rec, count in ((deco, n * n), (offsets, n)):
        if rec is not None and len(rec[3] or b"") != _MCT_SIZES[rec[2]] * count:
            raise _Fail("Error reading MCO marker")
    if offsets is not None:
        kind = ">" + "Hifd"[offsets[2]]
        for tccp, v in zip(tcp.tccps, np.frombuffer(offsets[3], kind)):
            tccp.dc_shift = _to_int32(v, offsets[2])


def _to_int32(v, element_type: int) -> int:
    """OpenJPEG's ``(OPJ_INT32)`` of an offset read as uint16, uint32,
    float32 or float64: C's truncation, x86's 0x80000000 out of range."""
    if element_type < 2:
        return int(np.int64(v).astype(np.uint32).astype(np.int32))
    f = float(v)
    return int(f) if f == f and -2.0 ** 31 < f < 2.0 ** 31 else -(1 << 31)


# -------------------------------------------------------------- PIL's unpack
_UNPACKERS = {("L", _GRAY, 1): "l", ("P", _SRGB, 1): "l", ("PA", _SRGB, 2): "la",
              ("I;16", _GRAY, 1): "i", ("LA", _GRAY, 2): "la",
              ("RGB", _GRAY, 1): "rgb_grey", ("RGB", _GRAY, 2): "rgb_grey",
              ("RGB", _SRGB, 3): "rgb", ("RGB", _SYCC, 3): "sycc", ("RGB", _SRGB, 4): "rgb",
              ("RGB", _SYCC, 4): "sycc", ("RGBA", _GRAY, 1): "rgb_grey",
              ("RGBA", _GRAY, 2): "la", ("RGBA", _GRAY, 4): "rgba",
              ("RGBA", _SRGB, 3): "rgb", ("RGBA", _SYCC, 3): "sycc",
              ("RGBA", _SRGB, 4): "rgba", ("RGBA", _SYCC, 4): "sycca",
              ("CMYK", _CMYK, 4): "rgba"}
_SUBSAMPLING = {"rgb", "sycc", "rgba", "sycca"}


def _to_bits(word: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """``j2ku_shift(offset + word, shift)`` stored in ``bits`` bits."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word + offset) & 0xFFFFFFFF
    x = x >> -shift if shift < 0 else (x << shift) & 0xFFFFFFFF
    return x & ((1 << bits) - 1)


def _unpack(kind: str, cs: _Codestream, tile, planes: List[np.ndarray], out: np.ndarray) -> None:
    """PIL's ``j2ku_*`` unpacker of one tile into ``out`` ((H, W, 4) of
    the image's mode: bytes, or uint16 for I;16). The unpackers read
    OpenJPEG's tile data (each component's samples in turn, as words of 1,
    2 or 4 bytes) with PIL's own offsets and row lengths, from a buffer of
    w * h times the components' byte sizes: a read past the tile's data
    (subsampled planes of odd sizes) sees zeros, as probed in PIL."""
    comps = cs.comps
    x0, y0 = tile[0] - cs.x0, tile[1] - cs.y0
    w, h = tile[2] - tile[0], tile[3] - tile[1]
    if not w or not h:
        return
    parts, sizes = [], []
    for c, v in enumerate(planes):
        csiz = (comps[c]["prec"] + 7) >> 3
        csiz = 4 if csiz == 3 else csiz
        sizes.append(csiz)
        parts.append((v & ((1 << (8 * csiz)) - 1)).astype(f"<u{csiz}").tobytes())
    data = b"".join(parts)
    buf = np.frombuffer(data + bytes(max(w * h * sum(sizes) - len(data), 0)), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]

    def read(c: int, start: int, bits: int = 8, sub: bool = False) -> np.ndarray:
        """Component c's samples from byte ``start``: word (y // dy) * (w //
        dx) + x // dx (dx = dy = 1 where the unpacker ignores them)."""
        dx, dy = (comps[c]["dx"], comps[c]["dy"]) if sub else (1, 1)
        csiz = sizes[c]
        off = start + csiz * ((yy // dy) * (w // dx) + xx // dx)
        word = np.zeros((h, w), np.int64)
        for i in range(csiz):
            word |= buf[off + i].astype(np.int64) << (8 * i)
        return _to_bits(word, comps[c]["prec"], comps[c]["sgnd"], bits)

    region = out[y0:y0 + h, x0:x0 + w]
    if kind == "l":
        region[..., 0] = read(0, 0)
    elif kind == "i":
        region[..., 0] = read(0, 0, 16)
    elif kind == "la":
        region[..., 0] = region[..., 1] = region[..., 2] = read(0, 0)
        region[..., 3] = read(1, sizes[0] * w * h)
    elif kind == "rgb_grey":
        region[..., 0] = region[..., 1] = region[..., 2] = read(0, 0)
    else:  # rgb, sycc (three components), rgba, sycca (four)
        n = 3 if kind in ("rgb", "sycc") else 4
        start = 0
        for c in range(n):
            region[..., c] = read(c, start, sub=True)
            start += sizes[c] * (w // comps[c]["dx"]) * (h // comps[c]["dy"])
        if n == 3:
            region[..., 3] = 255
    if kind in ("sycc", "sycca"):
        from .image_im import _ycbcr_to_rgb

        region[..., :3] = _ycbcr_to_rgb(region[..., :3].astype(np.uint8))


def _to_rgb(mode: str, px: np.ndarray, palette) -> np.ndarray:
    """PIL's ``convert("RGB")`` of the decoded image."""
    if mode in ("L", "LA"):
        return np.repeat(px[..., :1], 3, -1).astype(np.uint8)
    if mode == "I;16":
        return np.repeat(np.minimum(px[..., :1], 255), 3, -1).astype(np.uint8)
    if mode in ("RGB", "RGBA"):
        return px[..., :3].astype(np.uint8)
    if mode == "CMYK":
        from .image_io import cmyk_to_rgb

        v = px.astype(np.int64)
        return cmyk_to_rgb(v[..., 0], v[..., 1], v[..., 2], v[..., 3])
    pmode, pal = palette
    n = 4 if pmode == "RGBA" else 3
    table = np.zeros((256, 3), np.uint8)  # past the palette: black
    entries = np.frombuffer(pal, np.uint8)[:len(pal) // n * n].reshape(-1, n)[:256, :3]
    table[:len(entries)] = entries
    return table[px[..., 0].astype(np.int64) & 255]


def _decode(data: bytes, head: dict) -> np.ndarray:
    if head["codec"] == "jp2":
        start, _, space = _jp2_boxes(data)
    else:
        start, space = 0, _UNSPECIFIED
    cs = _Codestream(data, start, len(data))
    if not 1 <= cs.ncomp <= 4:
        raise _Fail(f"{cs.ncomp} components")
    subsampled = [(c["dx"], c["dy"]) != (1, 1) for c in cs.comps]
    if space == _UNSPECIFIED:
        space = _GRAY if cs.ncomp <= 2 else _SRGB
        if cs.ncomp >= 3 and not subsampled[0] and (subsampled[1] or subsampled[2]):
            space = _SYCC  # subsampled colour differences: read as sYCC, as PIL does
    subsampled = any(subsampled)
    mode = head["mode"]
    kind = _UNPACKERS.get((mode, space, cs.ncomp))
    if kind is None or (subsampled and kind not in _SUBSAMPLING):
        raise _Fail(f"no unpacker for mode {mode}, {space}, {cs.ncomp} components"
                    + (" subsampled" if subsampled else ""))
    width, height = head["size"]
    if (cs.x1 - cs.x0, cs.y1 - cs.y0) != (width, height):
        raise _Fail(f"image of {cs.x1 - cs.x0} x {cs.y1 - cs.y0} in a JP2 header of {width} x "
                    f"{height}")
    out = np.zeros((height, width, 4), np.uint16 if mode == "I;16" else np.uint8)
    ppm = [cs.ppm_data, 0] if cs.ppm_data is not None else None
    for t in cs.order:
        tile, planes = _decode_tile(cs, t, ppm)
        _unpack(kind, cs, tile, planes, out)
    return _to_rgb(mode, out, head["palette"])


def decode_jpeg2000(data: bytes, path: str) -> np.ndarray:
    """A JPEG 2000 file's bytes (JP2 or a raw codestream) as (H, W, 3)
    uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)  # its ValueErrors name the path
    except (PassOn, IndexError) as e:  # what PIL's opener passes on
        raise ValueError(f"{path}: not a JPEG 2000 file PIL opens ({e})") from None
    try:
        return _decode(data, head)
    except _Fail as e:
        raise ValueError(f"{path}: truncated or corrupt JPEG2000 data (PIL fails on it: {e})") \
            from None
    except IndexError as e:  # data that ends inside a field
        raise ValueError(f"{path}: truncated or corrupt JPEG2000 data ({e})") from None
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def packets(data: bytes) -> List[Tuple[int, bytes, list]]:
    """Each tile's packets as (tile, the tile's data, [((layer, resolution,
    component, precinct), header span, body span)]), the spans being
    offsets into the tile's data (with PPM or PPT, the header spans are
    offsets into the packed headers): what the tests re-serialise."""
    head = header(data, "")
    start = _jp2_boxes(data)[0] if head["codec"] == "jp2" else 0
    cs = _Codestream(data, start, len(data))
    ppm = [cs.ppm_data, 0] if cs.ppm_data is not None else None
    out = []
    for t in cs.order:
        spans: list = []
        _decode_tile(cs, t, ppm, spans)
        out.append((t, b"".join(cs.tiles[t].parts), spans))
    return out
