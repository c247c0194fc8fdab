"""Checkpoints in the Hugging Face layout that ``from_pretrained`` reads.

A directory with ``config.json`` and its weights: transformers'
``model.safetensors`` or ``pytorch_model.bin``, diffusers'
``diffusion_pytorch_model.safetensors``, or shards of either
(``model-00001-of-00002.safetensors``). The card's machine has no
``safetensors`` package, so the format is read and written here in plain
Python: an 8-byte little-endian header length, a JSON header that gives
each tensor's dtype, shape and byte range, then the raw little-endian
buffers. A bfloat16 tensor is a view of its bytes. ``.bin``, ``.pt``,
``.pth`` and ``.ckpt`` files go through ``torch.load(weights_only=True)``.
Every tensor keeps the dtype it has in the file.
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


TORCH_SUFFIXES = (".bin", ".pt", ".pth", ".ckpt")


def read_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file, a ``"state_dict"`` entry
    unwrapped (as Lightning and LDM checkpoints nest it)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def read_state_dict(d: str, files: Optional[Dict[str, str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Every weight file of checkpoint directory ``d``, in sorted name order
    (``*.safetensors`` and the torch suffixes; a later file's tensor
    replaces an earlier one of the same name), as the JAX package's
    converter reads a subfolder. ``files``, where given, gets each key's
    file."""
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        path = os.path.join(d, name)
        if name.endswith(".safetensors"):
            part = read_safetensors(path)
        elif name.endswith(TORCH_SUFFIXES):
            part = read_torch_file(path)
        else:
            continue
        sd.update(part)
        if files is not None:
            files.update(dict.fromkeys(part, path))
    if not sd:
        raise FileNotFoundError(f"{d}: no weight files (model.safetensors, "
                                f"diffusion_pytorch_model.safetensors, pytorch_model.bin, "
                                f"or any *.safetensors, *.bin, *.pt, *.pth, *.ckpt)")
    return sd


def write_checkpoint(d: str, config: dict, state_dict: Dict[str, torch.Tensor],
                     weights_name: str = "model.safetensors") -> int:
    """``config.json`` and the weights file ``weights_name`` (diffusers':
    ``diffusion_pytorch_model.safetensors``) of a checkpoint directory;
    returns the bytes of the weights file."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    path = os.path.join(d, weights_name)
    write_safetensors(state_dict, path, metadata={"format": "pt"})
    return os.path.getsize(path)
