"""Checkpoints in the Hugging Face layout that ``from_pretrained`` reads.

A directory with ``config.json`` and its weights as ``model.safetensors``
or ``pytorch_model.bin``. The card's machine has no ``safetensors``
package, so the format is read and written here in plain Python: an 8-byte
little-endian header length, a JSON header that gives each tensor's dtype,
shape and byte range, then the raw little-endian buffers. A bfloat16 tensor
is a view of its bytes. ``pytorch_model.bin`` goes through
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU. The tensors are
    views of one buffer that holds the file's data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"which the reader does not take")
        begin, end = info["data_offsets"]
        itemsize = torch.empty(0, dtype=dtype).element_size()
        if end - begin != itemsize * _numel(info["shape"]):
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for shape "
                             f"{info['shape']}")
        flat = (torch.frombuffer(data, dtype=dtype, count=(end - begin) // itemsize,
                                 offset=begin)
                if end > begin else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device) as a ``.safetensors`` file that
    ``safetensors.torch.load_file`` reads: tensors in name order, the
    header padded with spaces to a multiple of 8 bytes."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = dict(metadata)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def read_config(d: str) -> dict:
    path = os.path.join(d, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"missing checkpoint config: {path}")
    with open(path) as f:
        return json.load(f)


def read_state_dict(d: str) -> Dict[str, torch.Tensor]:
    """The weights of checkpoint directory ``d``: ``model.safetensors``, else
    ``pytorch_model.bin``."""
    st = os.path.join(d, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    bin_path = os.path.join(d, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    if os.path.exists(st + ".index.json") or os.path.exists(bin_path + ".index.json"):
        raise NotImplementedError(f"{d}: sharded checkpoints are not read")
    raise FileNotFoundError(f"{d}: no model.safetensors or pytorch_model.bin")


def write_checkpoint(d: str, config: dict, state_dict: Dict[str, torch.Tensor]) -> None:
    """``config.json`` and ``model.safetensors`` of a checkpoint directory."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    write_safetensors(state_dict, os.path.join(d, "model.safetensors"),
                      metadata={"format": "pt"})
