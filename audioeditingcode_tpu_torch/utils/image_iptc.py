"""IPTC/NAA decoding for ``image_io.read_image``, numpy and the standard
library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``IptcImagePlugin`` has no accept test: it reads 5-byte field
headers (0x1C, record, dataset, a 16-bit size, or an extended size of up
to 4 bytes; a field of zeros ends them) up to the first (8, 10) image data
field. A header that is not 0x1C and a known record passes the file on;
an extended size over 4 bytes ends ``Image.open``. The mode comes from
(3, 60): one layer without a component flag is L, three with it RGB, four
CMYK (any other passes the file on); the band from (3, 65) (1 if absent),
the size from (3, 20) and (3, 30), and the compression from (3, 120): 1
(raw) or 5 (JPEG), another ending ``Image.open``.

To load, PIL gathers the payloads of the consecutive (8, 10) fields and
opens them as an image file of their own: raw data behind a ``P5`` header
of the header's size, JPEG data as it is (here through
``image_io.decode_image``, PIL's choice of format on bytes). An L image
is that image itself, at its own size and in its own mode. Otherwise the
data must be an L image, placed as band (3, 65) - 1 (0 - 1 being the last)
of otherwise zero RGB or CMYK bands, then converted (CMYK by PIL's
``cmyk2rgb``). A file without an (8, 10) field, or data that ends early,
raises, as PIL fails on it; so does a band in data of another mode, and,
where the port cannot tell the mode of a band's data (any format but raw
data and JPEG), it raises naming that.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _be(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(data: bytes, pos: int, path: str):
    """PIL's ``IptcImageFile.field`` at ``pos``: (tag or None, size, data
    position)."""
    s = data[pos:pos + 5]
    pos += 5
    if not s.strip(b"\0"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise PassOn("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError(f"{path}: illegal field length in an IPTC/NAA file (PIL fails on it)")
    if size == 128:
        size = 0
    elif size > 128:
        size, pos = _be(data[pos:pos + s[3] - 128]), pos + s[3] - 128
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def header(data: bytes, path: str) -> dict:
    """PIL's ``IptcImageFile._open``: {"mode", "band", "size",
    "compression", "offset"} (offset: the first (8, 10) field's header, or
    None); ``PassOn`` (or ``IndexError``, ``TypeError``, ``KeyError``,
    ``struct.error``) where PIL passes the file on."""
    info, pos, offset = {}, 0, None
    while True:
        start = pos
        tag, size, pos = _field(data, pos, path)
        if not tag:
            break
        if tag == (8, 10):
            offset = start
            break
        tagdata = data[pos:pos + size] if size else None
        pos += size
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    width, height = _be(info[(3, 20)]), _be(info[(3, 30)])
    if (3, 120) not in info or _be(info[(3, 120)]) not in (1, 5):
        raise ValueError(f"{path}: unknown IPTC image compression (PIL fails on it)")
    if not mode or width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"mode": mode, "band": band, "size": (width, height), "offset": offset,
            "compression": _be(info[(3, 120)])}


def _payload(data: bytes, pos: int, path: str) -> bytes:
    """The consecutive (8, 10) fields' data from ``pos`` (cut at the file's
    end, as PIL reads it)."""
    out = []
    while True:
        tag, size, pos = _field(data, pos, path)
        if tag != (8, 10):
            return b"".join(out)
        out.append(data[pos:pos + size])
        pos += size


def _jpeg_components(stream: bytes) -> int:
    """The component count of a JPEG stream's frame header (0 without one)."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return stream[pos + 9] if pos + 9 < len(stream) else 0
        pos += 2 + struct.unpack_from(">H", stream, pos + 2)[0]
    return 0


def decode_iptc(data: bytes, path: str) -> np.ndarray:
    """An IPTC/NAA file's bytes as (H, W, 3) uint8 RGB (see the module
    docstring)."""
    from .image_io import _format_name, cmyk_to_rgb, decode_image

    try:
        head = header(data, path)
    except (PassOn, IndexError, TypeError, KeyError, struct.error) as e:
        raise ValueError(f"{path}: not an IPTC/NAA file PIL opens ({e})") from None
    if head["offset"] is None:
        raise ValueError(f"{path}: IPTC/NAA file without an image data field (8, 10) (PIL fails "
                         f"on it: cannot load this image)")
    try:
        stream = _payload(data, head["offset"], path)
    except PassOn as e:
        raise ValueError(f"{path}: broken IPTC/NAA field after the image data ({e})") from None
    width, height = head["size"]
    prefix = b"P5\n%d %d\n255\n" % (width, height) if head["compression"] == 1 else b""
    stream = prefix + stream
    name = f"{path} (IPTC image data)"
    if head["band"] is None:
        return decode_image(stream, name)
    kind = _format_name(stream, name)
    if prefix and kind == "PPM":
        if len(stream) - len(prefix) < width * height:
            raise ValueError(f"{path}: truncated IPTC/NAA raw data (PIL fails on it: image file "
                             f"is truncated)")
        band = np.frombuffer(stream, np.uint8, width * height, len(prefix)).reshape(height, width)
    elif kind == "JPEG":
        if _jpeg_components(stream) != 1:
            raise ValueError(f"{path}: IPTC/NAA {head['mode']} band in JPEG data of more than "
                             f"one component (PIL fails on it: mode mismatch)")
        band = decode_image(stream, name)[:, :, 0]
    else:
        raise ValueError(f"{path}: IPTC/NAA band in {kind} data: the port places a band only "
                         f"from raw or JPEG data")
    bands = [np.zeros_like(band)] * (3 if head["mode"] == "RGB" else 4)
    if not -len(bands) <= head["band"] < len(bands):
        raise ValueError(f"{path}: IPTC/NAA band {head['band'] + 1} of a {head['mode']} image "
                         f"(PIL fails on it)")
    bands[head["band"]] = band
    if head["mode"] == "RGB":
        return np.stack(bands, axis=-1)
    return cmyk_to_rgb(*(b.astype(np.int64) for b in bands))
