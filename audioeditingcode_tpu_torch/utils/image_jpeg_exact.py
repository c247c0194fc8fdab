"""libjpeg-turbo 3.1's Huffman bit reader byte for byte, for the two kinds
of damaged data where the bytes it loads, not only the bits it takes,
change what PIL 12.1 shows; standard library only.

``image_io``'s decoders read a segment's bits as a 16-bit peek table and
need not know when libjpeg loads a byte. That shows in two cases:

- Data without restart markers that holds FF FF ... 00. libjpeg's slow
  reader (``jpeg_fill_bit_buffer``) takes it for one FF byte; its fast one
  (``decode_mcu_fast``, which ``decode_mcu`` runs where the source holds at
  least 512 bytes a block and no restart interval is set) takes it for a
  marker, reads zeros past it, then gives the MCU up to the slow reader,
  which decodes it again over what the fast one wrote: a coefficient the
  fast one set and the slow one leaves zero keeps the fast one's value.
- Data of a one-scan image that runs to the end of the file without a
  marker after it (an EOI lost). PIL hands libjpeg the file 64 KiB at a
  time; libjpeg waits for more wherever a fill needs a byte past what it
  has, and PIL raises "image file is truncated" where there is no more.
  Whether a fill needs the byte past the last depends on where the fills
  fall.

``Bits`` keeps libjpeg's state: the data bits loaded (``L``: each fill
loads bytes until 57 bits are left, ``MIN_GET_BITS``; the fast reader six
bytes where 16 or fewer are left), the bits taken (``p``), the marker hit
(zeros past it, the out-of-data flag where a request runs past it), and
the end of what PIL has handed over (``top``). ``sequential`` and
``lossless`` decode with it, an MCU at a time, as ``decode_mcu`` and
``decode_mcus`` do, waiting (and taking the MCU again) where a fill runs
past ``top``.
"""

from __future__ import annotations

from typing import List, Optional

from .image_jpeg_stream import CHUNK, Truncated

_MIN_GET_BITS = 57  # BIT_BUF_SIZE (64) - 7
_FAST_BYTES = 512  # BUFSIZE: bytes a block of an MCU must have for the fast reader


class _Wait(Exception):
    """A fill needs a byte past what PIL has handed libjpeg: it suspends."""


class Bits:
    """libjpeg's bit reader over one segment of entropy-coded data.
    ``raw`` is the segment's bytes in the file from offset ``start``;
    ``marker_end`` the offset after the marker that ends it (None: the file
    ends first); ``top`` PIL's buffer end; ``n_file`` the file's size."""

    def __init__(self, raw: bytes, start: int, marker_end: Optional[int], top: int,
                 n_file: int, pad: int, peek16):
        data, ends, runs = bytearray(), [], set()
        i = 0
        while i < len(raw):
            if raw[i] != 0xFF:
                data.append(raw[i])
                i += 1
            else:
                j = i + 1
                while j < len(raw) and raw[j] == 0xFF:
                    j += 1
                if j >= len(raw):  # FF bytes that the file ends on
                    break
                if j > i + 1:
                    runs.add(len(data))
                data.append(0xFF)
                i = j + 1
            ends.append(start + i)
        self.w16 = peek16(bytes(data), pad)
        self.nbits = 8 * len(data)
        self.ends, self.runs, self.start = ends, runs, start
        self.marker_end, self.top, self.n_file = marker_end, top, n_file
        self.p = self.loaded = 0
        self.marker = self.insufficient = False
        self.fast = False
        self.zero_from: Optional[int] = None  # the fast reader's zeros from this bit on

    def state(self):
        return self.p, self.loaded, self.marker, self.insufficient

    def restore(self, state) -> None:
        self.p, self.loaded, self.marker, self.insufficient = state

    def room(self) -> float:
        """``bytes_in_buffer``: what PIL has handed over past the loads."""
        k = self.loaded >> 3
        at = self.ends[k - 1] if 0 < k <= len(self.ends) else self.start
        return self.top - at

    def _wait(self) -> None:
        if self.top >= self.n_file:
            raise Truncated
        self.top = min(self.n_file, self.top + CHUNK)
        raise _Wait

    def _fill(self, need: int) -> None:
        """``jpeg_fill_bit_buffer``: load bytes until 57 bits are left; at a
        marker, zeros where ``need`` bits are not there (the warning)."""
        while self.loaded - self.p < _MIN_GET_BITS and not self.marker:
            k = self.loaded >> 3
            if k < len(self.ends):
                if self.ends[k] > self.top:
                    self._wait()
                self.loaded += 8
            elif self.marker_end is None:
                self._wait()
            else:
                if self.marker_end > self.top:
                    self._wait()
                self.marker = True
        if self.marker and need > self.loaded - self.p:
            self.insufficient = True
            self.loaded = self.p + _MIN_GET_BITS

    def _fill_fast(self) -> None:
        """``FILL_BIT_BUFFER_FAST``: six bytes where 16 bits or fewer are
        left; FF not followed by 00 is a marker there, and zeros after it."""
        if self.loaded - self.p > 16:
            return
        for _ in range(6):
            k = self.loaded >> 3
            if self.zero_from is None and (k >= len(self.ends) or k in self.runs):
                self.zero_from = 8 * k
            self.loaded += 8

    def _peek(self) -> int:
        v = self.w16[self.p]
        z = self.zero_from
        if z is not None and self.p + 16 > z:
            v = 0 if self.p >= z else v & (0xFFFF << (self.p + 16 - z)) & 0xFFFF
        return v

    def code(self, lut: List[int]) -> int:
        """``HUFF_DECODE`` (or ``HUFF_DECODE_FAST``): the table entry, 0 for
        a code no entry starts (17 bits taken)."""
        if self.fast:
            self._fill_fast()
            e = lut[self._peek()]
            self.p += e >> 8 if e else 17
            return e
        if self.loaded - self.p < 8:
            self._fill(0)
        e = lut[self._peek()]
        length = e >> 8 if e else 17
        if self.loaded - self.p >= 8:
            if length <= 8:
                self.p += length
                return e
            first = 9
        else:  # at a marker, fewer than 8 bits left: a bit at a time
            first = 1
        if self.loaded - self.p < first:  # jpeg_huff_decode
            self._fill(first)
        self.p += first
        for _ in range(first, length):
            if self.loaded - self.p < 1:
                self._fill(1)
            self.p += 1
        return e

    def value(self, s: int) -> int:
        """``GET_BITS(s)`` after its check, as a signed difference."""
        if self.fast:
            self._fill_fast()
        elif self.loaded - self.p < s:
            self._fill(s)
        v = self._peek() >> (16 - s)
        self.p += s
        return v + 1 - (1 << s) if v < 1 << (s - 1) else v


def _mcu(bits: Bits, blocks, coefs: List[List[int]], preds: List[int]) -> None:
    """``decode_mcu_slow`` (or ``_fast``) of one MCU's blocks."""
    for ci, base, dc, ac in blocks:
        out = coefs[ci]
        s = bits.code(dc) & 15
        if s:
            preds[ci] += bits.value(s)
        out[base] = preds[ci]
        k = 1
        while k < 64:
            e = bits.code(ac)
            r, s = (e >> 4) & 15, e & 15
            if s:
                k += r
                out[base + (k if k < 64 else 63)] = bits.value(s)
                k += 1
            elif r == 15:
                k += 16
            else:
                break


def sequential(bits: Bits, slots, coefs: List[List[int]], per_mcu: int, fast_ok: bool):
    """One restart interval of a sequential scan as ``decode_mcu`` decodes
    it (``fast_ok``: no restart interval, so the fast reader may run):
    (MCUs decoded, whether the data ran out)."""
    preds = [0] * len(coefs)
    for m in range(len(slots) // per_mcu):
        if bits.insufficient:
            return m, True
        blocks = slots[m * per_mcu:(m + 1) * per_mcu]
        saved = [coefs[ci][b:b + 64] for ci, b, _, _ in blocks]
        state, start_preds = bits.state(), preds[:]
        while True:
            try:
                if fast_ok and not bits.marker and bits.room() >= _FAST_BYTES * per_mcu:
                    bits.fast, bits.zero_from = True, None
                    try:
                        _mcu(bits, blocks, coefs, preds)
                    finally:
                        bits.fast = False
                    if bits.zero_from is None:
                        break
                    bits.restore(state)  # a marker to the fast reader: the slow one again
                    preds[:] = start_preds
                    bits.zero_from = None
                _mcu(bits, blocks, coefs, preds)
                break
            except _Wait:  # PIL hands over the next 64 KiB; the MCU is taken again
                bits.restore(state)
                preds[:] = start_preds
                for (ci, b, _, _), block in zip(blocks, saved):
                    coefs[ci][b:b + 64] = block
    return len(slots) // per_mcu, bits.insufficient


def lossless(bits: Bits, tables: List[List[int]], rows: int, per_row: int) -> List[int]:
    """``decode_mcus`` over ``rows`` rows of ``per_row`` differences (the
    i-th with ``tables[i % len(tables)]``), a row at a time: the
    differences of the rows decoded before the data ran out."""
    out: List[int] = []
    for _ in range(rows):
        if bits.insufficient:
            break
        for i in range(per_row):
            while True:
                state = bits.state()
                try:
                    e = bits.code(tables[i % len(tables)])
                    s = e & 255
                    out.append(32768 if s == 16 else bits.value(s) if s else 0)
                    break
                except _Wait:  # the slow reader takes the same bits again
                    bits.restore(state)
    return out
