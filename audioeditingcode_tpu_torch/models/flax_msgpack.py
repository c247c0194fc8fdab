"""Flax's msgpack checkpoint format, read and written in pure Python.

Counterpart of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize`` (flax 0.12.3), which ``registry.load_model`` and
``save_params`` of the JAX package use for every converted ``.msgpack``
file. Only the subset that flax writes is handled: nil, bool, int, float,
str, bin, array, map and ext. Ext type 1 is an ndarray, a nested msgpack
tuple (shape, dtype name, buffer); ext type 3 a numpy scalar in the same
encoding; ext type 2 (complex) raises. Arrays over ``MAX_CHUNK_SIZE`` bytes
are written, and read back, as flax's ``__msgpack_chunked_array__`` dicts.

Arrays come out as ``np.frombuffer`` views of the one buffer the file was
read into: no copy per leaf. ``bfloat16`` has no numpy dtype here; such a
leaf comes out as a ``torch.bfloat16`` tensor viewing the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

Leaf = Union[np.ndarray, torch.Tensor]
# path -> (bytes, seconds) of every checkpoint file loaded into a module in
# this process: read, re-laid out and held by the module on the CPU
LOAD_SECONDS: Dict[str, Tuple[int, float]] = {}


# ------------------------------------------------------------------ reading
class _Reader:
    """A msgpack decoder over one buffer; positions are byte offsets."""

    def __init__(self, buf: Union[bytes, bytearray, memoryview]):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return start

    def _unpack(self, fmt: str, n: int):
        return struct.unpack_from(fmt, self.buf, self._take(n))[0]

    def _str(self, n: int) -> str:
        start = self._take(n)
        return bytes(self.buf[start:start + n]).decode("utf-8")

    def _bin(self, n: int) -> tuple:
        """(offset, length) of a bin payload, left in place."""
        return self._take(n), n

    def read(self) -> Any:
        b = self.buf[self._take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin: copied out (only ext payloads stay in place)
            off, n = self._bin(self._unpack(">" + "BHI"[b - 0xC4], 1 << (b - 0xC4)))
            return bytes(self.buf[off:off + n])
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack(">" + "BHI"[b - 0xC7], 1 << (b - 0xC7))
            return self._ext(n)
        if b == 0xCA:
            return self._unpack(">f", 4)
        if b == 0xCB:
            return self._unpack(">d", 8)
        if 0xCC <= b <= 0xCF:
            k = b - 0xCC
            return self._unpack(">" + "BHIQ"[k], 1 << k)
        if 0xD0 <= b <= 0xD3:
            k = b - 0xD0
            return self._unpack(">" + "bhiq"[k], 1 << k)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack(">" + "BHI"[b - 0xD9], 1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I", 2 if b == 0xDC else 4)
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I", 2 if b == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by flax")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b", 1)
        end = self.pos + n
        if code == _EXT_NDARRAY:
            out = self._ndarray()
        elif code == _EXT_NPSCALAR:
            out = self._ndarray()
            out = out[()] if isinstance(out, np.ndarray) else out.reshape(())
        else:
            raise ValueError(f"msgpack ext type {code} is not supported "
                             f"(flax writes 1 for arrays and 3 for numpy scalars)")
        if self.pos != end:
            raise ValueError("malformed flax ndarray payload")
        return out

    def _ndarray(self) -> Leaf:
        """flax's _ndarray_from_bytes, parsed in place."""
        head = self.buf[self._take(1)]
        if head != 0x93:  # fixarray of 3
            raise ValueError("malformed flax ndarray payload")
        shape = tuple(self.read())
        name = self.read()
        if isinstance(name, bytes):
            name = name.decode()
        b = self.buf[self._take(1)]
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("malformed flax ndarray payload")
        off, n = self._bin(self._unpack(">" + "BHI"[b - 0xC4], 1 << (b - 0xC4)))
        if name == "bfloat16":
            a = np.frombuffer(self.buf, np.uint16, n // 2, off).reshape(shape)
            if not a.flags.writeable:  # a bytes object: torch takes no read-only array
                a = a.copy()
            return torch.from_numpy(a).view(torch.bfloat16)
        dt = np.dtype(name)
        return np.frombuffer(self.buf, dt, n // dt.itemsize, off).reshape(shape)


def _unchunk(d: dict) -> Leaf:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_leaves(v)
    return d


def msgpack_restore(data: Union[bytes, bytearray, memoryview]) -> Any:
    """The tree flax's ``msgpack_restore`` gives for ``data``."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_leaves(out)


def read_file(path: str) -> Any:
    """``msgpack_restore`` of a file, read into one writable buffer."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise IOError(f"short read of {path}")
    return msgpack_restore(buf)


def flatten(tree: dict, prefix: tuple = ()) -> Dict[tuple, Any]:
    """{path tuple: leaf}, as ``flax.traverse_util.flatten_dict``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: Dict[tuple, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


# ------------------------------------------------------------------ writing
def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(n: int, fix: tuple, codes: tuple) -> bytes:
    """Header of a str/bin/array/map of n items: fix = (first code, limit)
    or None; codes = the 8/16/32-bit length codes (None where absent)."""
    if fix is not None and n < fix[1]:
        return bytes((fix[0] | n,))
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack object of {n} items or bytes")


def _str_head(n: int) -> bytes:
    return _sized(n, (0xA0, 32), (0xD9, 0xDA, 0xDB))


def _bin_head(n: int) -> bytes:
    return _sized(n, None, (0xC4, 0xC5, 0xC6))


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes((fixed[n], code))
    return _sized(n, None, (0xC7, 0xC8, 0xC9)) + bytes((code,))


def _leaf_parts(a: Leaf) -> tuple:
    """(shape, dtype name, contiguous byte view) of an array leaf."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return tuple(a.shape), "bfloat16", a.view(torch.uint16).numpy().reshape(-1).view(np.uint8)
        a = a.numpy()
    a = np.asarray(a)
    if not a.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return tuple(a.shape), a.dtype.name, a.reshape(-1).view(np.uint8)


def _pack_array(a: Leaf, code: int, write: Callable[[Any], Any]) -> None:
    shape, name, data = _leaf_parts(a)
    enc = name.encode()
    head = (b"\x93" + _sized(len(shape), (0x90, 16), (None, 0xDC, 0xDD))
            + b"".join(_int(int(s)) for s in shape) + _str_head(len(enc)) + enc
            + _bin_head(data.size))
    write(_ext_head(code, len(head) + data.size) + head)
    write(memoryview(data))


def _nbytes(a: Leaf) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def _chunk(a: Leaf) -> dict:
    """flax's _chunk: a flat array cut into MAX_CHUNK_SIZE-byte pieces."""
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(a.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _pack(x: Any, write: Callable[[Any], Any]) -> None:
    if isinstance(x, dict):
        write(_sized(len(x), (0x80, 16), (None, 0xDE, 0xDF)))
        for k, v in x.items():
            _pack(k, write)
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pack(v, write)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_array(x, _EXT_NDARRAY, write)
    elif isinstance(x, np.generic):
        _pack_array(np.asarray(x), _EXT_NPSCALAR, write)
    elif x is None:
        write(b"\xc0")
    elif x is True or x is False:
        write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        write(_int(x))
    elif isinstance(x, float):
        write(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        enc = x.encode("utf-8")
        write(_str_head(len(enc)) + enc)
    elif isinstance(x, (bytes, bytearray)):
        write(_bin_head(len(x)) + bytes(x))
    elif isinstance(x, (list, tuple)):
        write(_sized(len(x), (0x90, 16), (None, 0xDC, 0xDD)))
        for v in x:
            _pack(v, write)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} in flax's msgpack format")


def write_file(tree: Any, path: str) -> int:
    """Write ``tree`` to ``path`` without building the whole file in
    memory; returns the bytes written."""
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    with open(path, "wb") as f:
        _pack(tree, f.write)
        return f.tell()
