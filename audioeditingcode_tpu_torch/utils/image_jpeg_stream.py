"""How libjpeg-turbo 3.1 reads the bytes of a JPEG stream, as PIL 12.1 and
libtiff 4.7 hand them to it, for the JPEG decoders of ``image_io``,
``image_jpeg_arith`` and ``image_jpeg_lossless``; standard library only.

- ``Source``: the stream, libjpeg's position in it and its unread marker.
  Markers are found as ``next_marker`` finds them: any bytes before one are
  skipped (an FF followed by 00, or by FF bytes and then 00, is data), and
  the bit reader stops at the first one, whatever it is.
- PIL's ``ImageFile.load`` hands libjpeg the file 64 KiB at a time from
  its start, and libjpeg waits (suspends) where it needs a byte past what it
  was given. Past the end of the file PIL raises "image file is truncated"
  (``Truncated``), but once every scanline of a one-scan image is out,
  when it may go on. The arithmetic decoder cannot wait: a byte past the
  current 64 KiB is an error there (``Source.arith``). libtiff hands each
  strip or tile whole and gives an EOI marker wherever libjpeg reads past
  its end (``eoi_pad``); its OJPEG codec's data source fails where libjpeg
  would resynchronise on a restart marker (``resync``).
- ``Source.restart``: ``read_restart_marker`` with the default
  ``jpeg_resync_to_restart``: the expected RSTn is taken; one or two ahead,
  or any other marker from SOF0 up that is not a restart, is left in place
  (the interval after it reads as data that has run out); one or two
  behind, or a byte below SOF0, is passed over to the next marker and the
  choice made again; any other RSTn is taken as if it were the right one.
- ``intervals``: a Huffman-coded scan's restart intervals as libjpeg's
  ``decode_mcu`` walks them: each interval's data up to its marker, the
  out-of-data flag (``insufficient_data``) that the MCU which runs past the
  data sets and that leaves every MCU after it in the interval undecoded,
  reset at a restart marker but where the resynchronisation left the
  reader at a marker. ``Source.span`` tells the decoders where the data
  lies, for the two cases ``image_jpeg_exact`` reads byte for byte.
- ``STD_HUFFMAN``: the tables of T.81 K.3 that libjpeg's Huffman decoders
  take for tables 0 and 1 where the stream defines none (``std_huff_tables``).
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

# PIL's ImageFile.MAXBLOCK: the size of each read it hands the decoder
CHUNK = 65536
# a marker: FF bytes, then a byte that is neither 00 (stuffing) nor FF
MARKER = re.compile(rb"\xff+[^\x00\xff]")
STUFFED = re.compile(rb"\xff+\x00")
# FF bytes then 00: one FF to libjpeg's bit reader, a marker to its fast path
_FF_RUN = re.compile(rb"\xff\xff+\x00")
_EOI = b"\xff\xd9"
_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718"
    "191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475"
    "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125"
    "f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a7374"
    "75767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
    "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
# (class, table) -> (the code counts of lengths 1-16, the symbols)
STD_HUFFMAN = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), _AC_LUMA),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), _AC_CHROMA),
}


class Truncated(Exception):
    """libjpeg waits for data past the end of the file."""


class Source:
    """A JPEG stream as libjpeg's data source gives it: ``pos`` is the next
    byte libjpeg reads, ``unread`` the marker it has read and not acted on
    (0: none); ``top`` the end of what PIL has handed it so far."""

    def __init__(self, data: bytes, pos: int = 0, eoi_pad: bool = False, resync: bool = True):
        self.n = len(data)
        self.resync = resync  # libtiff's OJPEG data source fails instead
        self.data = data + _EOI if eoi_pad else data
        self.eoi_pad = eoi_pad
        self.pos = pos
        self.unread = 0
        self.top = float("inf") if eoi_pad else min(self.n, CHUNK)
        self.arith = False
        self.at_end = False  # a scan's data ran to the end of the file
        # the last segment's (start, end, end of its marker or None), None
        # where the interval had no data; whether it holds FF FF ... 00
        self.span: Optional[Tuple[int, int, Optional[int]]] = None
        self.ff_run = False

    def _reach(self, p: int) -> None:
        """Byte ``p`` as PIL's reads make it available to libjpeg."""
        if p < self.top:
            return
        if p >= self.n:
            raise Truncated
        if self.arith:
            raise ValueError("corrupt JPEG data: an arithmetic-coded scan reads past the "
                             "64 KiB PIL has handed libjpeg, and libjpeg's arithmetic decoder "
                             "cannot wait for more (it fails, and so does PIL)")
        self.top = min(self.n, CHUNK * (p // CHUNK + 1))

    def byte(self) -> int:
        p = self.pos
        if p >= self.top:
            self._reach(p)
        self.pos = p + 1
        return self.data[p] if p < len(self.data) else _EOI[(p - len(self.data)) & 1]

    def u16(self) -> int:
        return (self.byte() << 8) | self.byte()

    def skip(self, k: int) -> None:
        """``skip_input_data``: PIL's waits for the bytes skipped; libtiff's
        gives an EOI marker where they run past the strip."""
        if k <= 0:
            return
        target = self.pos + k
        if self.eoi_pad:
            self.pos = min(target, self.n)
            return
        self._reach(target - 1)
        self.pos = target

    def next_marker(self) -> int:
        """``next_marker``: skip to the next marker and read it."""
        m = MARKER.search(self.data, self.pos)
        if m is None:
            if not self.eoi_pad:
                self._reach(self.n)  # raises: the data ends first
            past = max(self.pos - len(self.data), 0)
            self.pos = len(self.data) + past + (past & 1) + 2
            self.unread = 0xD9
            return self.unread
        self._reach(m.end() - 1)
        self.pos = m.end()
        self.unread = self.data[m.end() - 1]
        return self.unread

    def segment(self) -> bytes:
        """The entropy-coded data from the position up to the next marker,
        stuffing removed; the bit reader stops at that marker and keeps it
        unread. Where the file ends first (``at_end``), the data up to its
        end, but an FF and the FF bytes after it that end the file (a
        marker or stuffing cut short)."""
        m = MARKER.search(self.data, self.pos)
        end = self.n if m is None else m.start()
        self.span = (self.pos, end, None if m is None else m.end())
        self.ff_run = _FF_RUN.search(self.data, self.pos, end) is not None
        if m is None:
            cut = len(self.data.rstrip(b"\xff")) if self.data.endswith(b"\xff") else self.n
            seg = STUFFED.sub(b"\xff", self.data[self.pos:max(cut, self.pos)])
            self.pos, self.at_end = self.n, True
            return seg
        seg = STUFFED.sub(b"\xff", self.data[self.pos:m.start()])
        self.pos = m.end()
        self.unread = self.data[m.end() - 1]
        return seg

    def restart(self, num: int) -> None:
        """``read_restart_marker`` expecting RST``num``, and
        ``jpeg_resync_to_restart`` where another marker stands there."""
        marker = self.unread or self.next_marker()
        if marker == 0xD0 + num:
            self.unread = 0
            return
        if not self.resync:
            raise ValueError(f"old-style JPEG-in-TIFF data with marker 0x{marker:02X} where "
                             f"RST{num} is due: libtiff's OJPEG data source fails on libjpeg's "
                             f"resynchronisation (LibJpeg: Unexpected error), and PIL then "
                             f"fails or shows memory the strip never set")
        while True:
            if marker < 0xC0:
                action = 2
            elif not 0xD0 <= marker <= 0xD7 or marker - 0xD0 in ((num + 1) & 7, (num + 2) & 7):
                action = 3
            elif marker - 0xD0 in ((num - 1) & 7, (num - 2) & 7):
                action = 2
            else:
                action = 1
            if action == 1:
                self.unread = 0
                return
            if action == 3:
                return
            marker = self.next_marker()


def intervals(src: Source, restart: int, total: int,
              decode: Callable[[int, int, bytes], Tuple[int, bool]]) -> int:
    """Walk a Huffman-coded scan of ``total`` MCUs in restart intervals of
    ``restart`` MCUs (0: one interval). ``decode(first, count, data)``
    decodes the interval's MCUs from its data (zero bits past its end) and
    returns how many it decoded before one started past the data, and
    whether the last one ran past it. Returns libjpeg's
    ``last_good_iMCU_row`` as an MCU index: the last MCU that began with the
    out-of-data flag clear (looked at before the restart marker is read)."""
    insufficient = False
    num = first = 0
    last_good = -1
    while first < total:
        count = min(restart, total - first) if restart else total
        if first:
            if not insufficient:
                last_good = first
            src.restart(num)
            num = (num + 1) & 7
            if not src.unread:
                insufficient = False
        elif not insufficient:
            last_good = 0
        if src.unread or insufficient:  # at a marker: no data for this interval
            data, src.span = b"", None
        else:
            data = src.segment()
        if insufficient:
            done = 0
        else:
            done, insufficient = decode(first, count, data)
        if done > 1:
            last_good = first + done - 1
        if src.at_end and (insufficient or first + count < total):
            raise Truncated  # the bit reader, or the next restart, waits past the end
        first += count
    return last_good
