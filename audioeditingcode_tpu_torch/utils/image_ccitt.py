"""CCITT fax decoding for TIFF (compressions 2, 3, 4 and 32771), numpy and
the standard library only, as libtiff 4.7's ``tif_fax3.c`` decodes a strip
or tile for PIL 12.1.

- 2 (CCITT RLE): Modified Huffman rows without EOLs, each row starting on
  a byte; 32771 (RLEW): the same, each row on a 16-bit word, with
  libtiff's test of the word by the address of the next byte it would
  read (the strip's offset in the file, libtiff reading the file mapped
  into memory), not by the bits it still holds;
- 3 (T.4): an EOL before each row (libtiff scans for 11 zero bits, skips
  zero bits, then the 1), then a 1-D row, or with T4Options bit 0 a tag
  bit choosing a 1-D or a 2-D (READ) row; EOL fill bits need nothing more;
- 4 (T.6): 2-D (MMR) rows, the reference line white at each strip's
  start; an EOFB (or any EOL) ends the strip.

libtiff's decoder is lenient, and the port keeps each of its rules: a row
whose runs do not add up to its width is cut or padded with white; a code
the tables do not hold ends the row there (padded); an EOL inside a 1-D row
ends that row; bits past the data's end read as zeros, and only a code
that needs bits when none is left is a premature end, which fails the
strip (PIL: "decoder error"). In T.6 an EOL, or the end of the data, ends
the strip early: libtiff fails it when no row was decoded before, and
otherwise returns it with the rows after that row unwritten. PIL then
draws whatever its buffer held there, which the port cannot know, so it
raises. Uncompressed mode (T4Options or T6Options bit 1) is not decoded
by libtiff: its extension code ends the row where it stands.

Black runs are 1 bits and white runs 0 bits (libtiff's decoders ignore
the photometric interpretation; PIL applies it after them).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# T.4's codes, bits in stream order: white and black terminating codes
# (run 0-63), make-up codes (64-1728), and the extended make-up codes
# (1792-2560) that both colours share
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 "
               "000000011110 000000011111").split()
# the states of libtiff's tables (tif_fax3.h)
(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB,
 S_MAKEUP, S_EOL) = range(13)
_MODES = [("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0), ("011", S_VR, 1),
          ("000011", S_VR, 2), ("0000011", S_VR, 3), ("010", S_VL, 1), ("000010", S_VL, 2),
          ("0000010", S_VL, 3), ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)]
# libtiff's EOL entry in the run tables: 11 zero bits (the final 1 is
# left for the row's synchronisation to skip)
_EOL11 = "00000000000"


def _table(width: int, codes) -> List[Tuple[int, int, int]]:
    """libtiff's lookup table of ``width`` bits, indexed least significant
    bit first (the next bit of the stream in bit 0): (state, code length,
    run); S_NULL, length 0, where no code matches."""
    table = [(S_NULL, 0, 0)] * (1 << width)
    for code, state, param in codes:
        value = sum(1 << i for i, c in enumerate(code) if c == "1")
        for k in range(1 << (width - len(code))):
            table[value | (k << len(code))] = (state, len(code), param)
    return table


_WHITE = _table(12, [(c, S_TERMW, i) for i, c in enumerate(_WHITE_TERM)]
                + [(c, S_MAKEUPW, 64 * (i + 1)) for i, c in enumerate(_WHITE_MAKEUP)]
                + [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
                + [(_EOL11, S_EOL, 0)])
_BLACK = _table(13, [(c, S_TERMB, i) for i, c in enumerate(_BLACK_TERM)]
                + [(c, S_MAKEUPB, 64 * (i + 1)) for i, c in enumerate(_BLACK_MAKEUP)]
                + [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
                + [(_EOL11, S_EOL, 0)])
_MAIN = _table(7, _MODES)
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
_U32 = 0xFFFFFFFF


class _End(Exception):
    """A code needed bits when none was left (libtiff's premature EOF)."""


class _Fail(Exception):
    """libtiff's decoder returned -1 for the strip."""


class _Retry(Exception):
    """Group 3 data ended while an EOL was skipped."""


class _RowEnd(Exception):
    """A row ends before its width: an EOL or a code the tables do not hold
    (libtiff's jumps to the row's cleanup)."""


class _Decoder:
    """libtiff's Fax3 decoder state for one image: the run arrays persist
    from strip to strip, as libtiff allocates them once."""

    def __init__(self, width: int, kind: str, two_d: bool):
        self.lastx = width
        self.kind = kind
        self.two_d = kind == "g4" or two_d
        nruns = (width + 1 + 31) // 32 * 32
        self.nruns = 2 * nruns if self.two_d else nruns
        self.arrays = ([0] * self.nruns, [0] * self.nruns)
        self.noeol = False  # set for the rest of the image by a retry

    # ----------------------------------------------------------- bits
    def _start(self, data: bytes, base: int):
        self.data = data.translate(_REVERSED)  # the first bit of each byte in bit 0
        self.cp = 0
        self.ep = len(data)
        self.base = base  # the file offset of the data's first byte
        self.acc = 0
        self.avail = 0
        self.eolcnt = 0

    def need8(self, n: int):
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _End
                self.avail = n
            else:
                self.acc |= self.data[self.cp] << self.avail
                self.cp += 1
                self.avail += 8

    def need16(self, n: int):
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _End
                self.avail = n
            else:
                self.acc |= self.data[self.cp] << self.avail
                self.cp += 1
                self.avail += 8
                if self.avail < n:
                    if self.cp >= self.ep:
                        self.avail = n
                    else:
                        self.acc |= self.data[self.cp] << self.avail
                        self.cp += 1
                        self.avail += 8

    def clr(self, n: int):
        self.avail -= n
        self.acc >>= n

    def lookup16(self, width: int, table):
        self.need16(width)
        entry = table[self.acc & ((1 << width) - 1)]
        self.clr(entry[1])
        return entry

    # ------------------------------------------------------------ runs
    def setvalue(self, x: int):
        if self.pa >= self.nruns:
            raise _Fail  # a run array overflows
        self.cur[self.pa] = (self.runlength + x) & _U32
        self.pa += 1
        self.a0 += x
        self.runlength = 0

    def cleanup(self):
        """libtiff's CLEANUP_RUNS: the row's runs cut or padded to its width."""
        lastx = self.lastx
        if self.runlength:
            self.setvalue(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > 0:
                self.pa -= 1
                self.a0 -= self.cur[self.pa]
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if self.pa & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)

    def fill(self) -> np.ndarray:
        """``_TIFFFax3fillruns``: the row's bits from its runs, each run
        clamped to the width (in the run array too)."""
        runs, n, lastx = self.cur, self.pa, self.lastx
        if n & 1:
            if n < len(runs):
                runs[n] = 0
            n += 1
        x = 0
        lengths = []
        for i in range(n):
            run = runs[i] if i < len(runs) else 0
            if x + run > lastx or run > lastx:
                run = lastx - x
                if i < len(runs):
                    runs[i] = run
            lengths.append(run)
            x += run
        colours = np.arange(len(lengths)) & 1
        return np.repeat(colours.astype(np.uint8), lengths)

    # ------------------------------------------------------------- 1-D
    def expand1d(self):
        """libtiff's EXPAND1D: one row of Modified Huffman runs, then its
        CLEANUP_RUNS. Raises _End (after the cleanup) at a premature end."""
        lastx = self.lastx
        try:
            while True:
                while True:
                    state, _, param = self.lookup16(12, _WHITE)
                    if state == S_EOL:
                        self.eolcnt = 1
                        raise _RowEnd
                    if state == S_TERMW:
                        self.setvalue(param)
                        break
                    if state in (S_MAKEUPW, S_MAKEUP):
                        self.a0 += param
                        self.runlength += param
                    else:
                        raise _RowEnd  # a bad code: the row ends here
                if self.a0 >= lastx:
                    break
                while True:
                    state, _, param = self.lookup16(13, _BLACK)
                    if state == S_EOL:
                        self.eolcnt = 1
                        raise _RowEnd
                    if state == S_TERMB:
                        self.setvalue(param)
                        break
                    if state in (S_MAKEUPB, S_MAKEUP):
                        self.a0 += param
                        self.runlength += param
                    else:
                        raise _RowEnd
                if self.a0 >= lastx:
                    break
                if self.pa >= 2 and self.cur[self.pa - 1] == 0 and self.cur[self.pa - 2] == 0:
                    self.pa -= 2
        except _RowEnd:
            pass
        except _End:
            self.cleanup()
            raise
        self.cleanup()

    # ------------------------------------------------------------- 2-D
    def check_b1(self):
        if self.pa != 0:
            ref = self.ref
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.nruns:
                    raise _Fail  # a run array overflows
                self.b1 += ref[self.pb] + ref[self.pb + 1]
                self.pb += 2

    def _horizontal_run(self, table, term: int, makeup: int):
        while True:
            state, _, param = self.lookup16(12 if table is _WHITE else 13, table)
            if state == term:
                self.setvalue(param)
                return True
            if state in (makeup, S_MAKEUP):
                self.a0 += param
                self.runlength += param
            else:
                return False

    def expand2d(self):
        """libtiff's EXPAND2D: one row of T.4/T.6 2-D codes against the
        reference line, then its CLEANUP_RUNS. Raises _End (after the
        cleanup) at a premature end."""
        lastx, ref = self.lastx, self.ref
        try:
            while self.a0 < lastx:
                if self.pa >= self.nruns:
                    raise _Fail  # a run array overflows
                self.need8(7)
                state, width, param = _MAIN[self.acc & 127]
                self.clr(width)
                if state == S_PASS:
                    self.check_b1()
                    if self.pb + 1 >= self.nruns:
                        raise _Fail  # a run array overflows
                    self.b1 += ref[self.pb]
                    self.pb += 1
                    self.runlength += self.b1 - self.a0
                    self.a0 = self.b1
                    self.b1 += ref[self.pb]
                    self.pb += 1
                elif state == S_HORIZ:
                    if self.pa & 1:
                        ok = (self._horizontal_run(_BLACK, S_TERMB, S_MAKEUPB)
                              and self._horizontal_run(_WHITE, S_TERMW, S_MAKEUPW))
                    else:
                        ok = (self._horizontal_run(_WHITE, S_TERMW, S_MAKEUPW)
                              and self._horizontal_run(_BLACK, S_TERMB, S_MAKEUPB))
                    if not ok:
                        raise _RowEnd  # a bad code in a run: the row ends
                    self.check_b1()
                elif state == S_V0:
                    self.check_b1()
                    self.setvalue(self.b1 - self.a0)
                    self.b1 += ref[self.pb]
                    self.pb += 1
                elif state == S_VR:
                    self.check_b1()
                    self.setvalue(self.b1 - self.a0 + param)
                    self.b1 += ref[self.pb]
                    self.pb += 1
                elif state == S_VL:
                    self.check_b1()
                    if self.b1 < self.a0 + param:
                        raise _RowEnd
                    self.setvalue(self.b1 - self.a0 - param)
                    self.pb -= 1
                    self.b1 -= ref[self.pb]
                elif state == S_EXT:  # uncompressed mode: not decoded by libtiff
                    self.cur[self.pa] = (lastx - self.a0) & _U32
                    self.pa += 1
                    raise _RowEnd
                else:  # S_EOL: 7 zero bits, then 4 more taken
                    self.cur[self.pa] = (lastx - self.a0) & _U32
                    self.pa += 1
                    self.need8(4)
                    self.clr(4)
                    self.eolcnt = 1
                    raise _RowEnd
            if self.runlength:
                if self.runlength + self.a0 < lastx:  # a final V0 expected
                    self.need8(1)
                    if not self.acc & 1:
                        raise _RowEnd
                    self.clr(1)
                self.setvalue(0)
        except _RowEnd:
            pass
        except _End:
            self.cleanup()
            raise
        self.cleanup()

    # -------------------------------------------------------------- rows
    def sync_eol(self):
        """libtiff's SYNC_EOL: to just past the next EOL's final 1. Data that
        ends while it skips the EOL's zeros raises _Retry (libtiff then reads
        the strip again from its start as Group 3 without EOLs)."""
        if self.eolcnt == 0:
            while True:
                self.need16(11)
                if self.acc & 0x7FF == 0:
                    break
                self.clr(1)
        while True:
            try:
                self.need8(8)
            except _End:
                raise _Retry from None
            if self.acc & 0xFF:
                break
            self.clr(8)
        while not self.acc & 1:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0

    def strip(self, data: bytes, rows: int, base: int) -> Tuple[bool, List[np.ndarray]]:
        """libtiff's decode of one strip or tile: (whether it succeeds, the
        rows it writes, in order; rows past them it leaves unwritten)."""
        self._start(data, base)
        self.cur, self.ref = self.arrays
        if self.two_d:
            self.ref[0], self.ref[1] = self.lastx, 0
        out: List[np.ndarray] = []
        while len(out) < rows:
            self.a0 = self.runlength = self.pa = 0
            if self.kind == "g4":
                self.pb, self.b1 = 1, self.ref[0]
                try:
                    self.expand2d()
                except _End:
                    self.eolcnt = 1
                if self.eolcnt:  # EOFB, an EOL or the data's end: Fax4Decode's EOFG4
                    done = len(out)
                    out.append(self.fill())
                    return done > 0, out
                out.append(self.fill())
                self.setvalue(0)  # an imaginary change, for the next row's reference
                self.cur, self.ref = self.ref, self.cur
                continue
            try:
                if self.kind == "g3":
                    try:
                        if not self.noeol:
                            self.sync_eol()
                        if self.two_d:
                            self.need8(1)
                            one_d = self.acc & 1
                            self.clr(1)
                    except _Retry:
                        self.noeol = True
                        self._start(data, base)
                        continue
                    except _End:
                        self.cleanup()
                        raise
                if self.two_d:
                    self.pb, self.b1 = 1, self.ref[0]
                    if one_d:
                        self.expand1d()
                    else:
                        self.expand2d()
                    out.append(self.fill())
                    if self.pa < self.nruns:
                        self.setvalue(0)
                    self.cur, self.ref = self.ref, self.cur
                    continue
                self.expand1d()
            except _End:
                out.append(self.fill())
                return False, out
            out.append(self.fill())
            if self.kind == "rle":
                self.clr(self.avail & 7)
            elif self.kind == "rlew":
                self.clr(self.avail & 15)
                if self.avail == 0 and (self.base + self.cp) & 1:
                    self.cp += 1
        return True, out


def decoder(width: int, compression: int, tags) -> _Decoder:
    """The decoder of one image's strips or tiles ``width`` pixels wide."""
    kind = {2: "rle", 32771: "rlew", 3: "g3", 4: "g4"}[compression]
    two_d = compression == 3 and bool(tags.get(292, (0,))[0] & 1)
    return _Decoder(width, kind, two_d)


def decode_block(dec: _Decoder, src: bytes, rows: int, offset: int, path: str) -> bytes:
    """One strip's or tile's fax data as ``rows`` rows of packed bits, most
    significant first, each row on a byte (libtiff's output)."""
    try:
        ok, out = dec.strip(src, rows, offset)
    except (_Fail, IndexError):  # an overflow of libtiff's run arrays
        ok, out = False, []
    if not ok:
        raise ValueError(f"{path}: corrupt CCITT fax data (libtiff fails the strip, and PIL "
                         f"with a decoder error)")
    if len(out) < rows:
        raise ValueError(f"{path}: CCITT fax data that ends in row {len(out)} of a strip of "
                         f"{rows}: libtiff leaves the strip's other rows unwritten, and PIL draws "
                         f"memory it never wrote there")
    return np.packbits(np.stack(out), axis=1).tobytes()
