"""Shared CLI plumbing: seeding, the results layout, artifact saving.

Counterpart of the parts of ``audioeditingcode_tpu/cli/common.py`` that the
text-edit CLI uses; the results layout and ``run_args.json`` are the same.
"""

from __future__ import annotations

import calendar
import json
import os
import random
import struct
import time
import zlib
from typing import List, Optional

import numpy as np
import torch


def set_reproducibility(seed: Optional[int]) -> int:
    """Seed the host RNGs and torch; returns the seed (random if None)."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return seed


def timestamp_name() -> int:
    return calendar.timegm(time.gmtime())


def join_prompts(prompts: List[str]) -> str:
    return "__".join(x.replace(" ", "_") for x in prompts)


def edit_save_path(results_path: str, model_id: str, init_aud: str,
                   source_prompt: List[str], target_prompt: List[str],
                   target_neg_prompt: List[str]) -> str:
    """Results directory of one edit."""
    return os.path.join(
        results_path,
        model_id.split("/")[1] if "/" in model_id else model_id,
        os.path.basename(init_aud).split(".")[0],
        "src_" + join_prompts(source_prompt),
        "dec_" + join_prompts(target_prompt) + "__neg__" + join_prompts(target_neg_prompt),
    )


def edit_image_name(mode: str, cfg_src, cfg_tar, skip, num_steps: int) -> str:
    """Output basename of one edit."""
    ts = timestamp_name()
    base = (
        f'cfg_e_{"-".join(str(x) for x in cfg_src)}_'
        f'cfg_d_{"-".join(str(x) for x in cfg_tar)}_'
    )
    skips = np.atleast_1d(np.asarray(skip))
    if mode == "ours" or (skips != 0).any():
        return base + f'skip_{"-".join(str(int(x)) for x in skips)}_{ts}'
    return base + f"{num_steps}timesteps_{ts}"


def save_spectrogram_png(path: str, spec: np.ndarray) -> None:
    """The spectrogram as an 8-bit grayscale PNG, min-max scaled, tall
    spectrograms transposed (written directly, without matplotlib)."""
    spec = np.asarray(spec, np.float64)
    if spec.ndim == 4:
        spec = spec[0, 0]
    if spec.shape[0] > spec.shape[1]:
        spec = spec.T
    lo, hi = float(np.min(spec)), float(np.max(spec))
    img = np.round(255.0 * (spec - lo) / max(hi - lo, 1e-12)).astype(np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def dump_run_summary(save_path: str, args, extra=None) -> None:
    """Machine-readable run record beside the artifacts."""
    payload = {k: v for k, v in vars(args).items() if not k.startswith("_")}
    payload = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in payload.items()}
    if extra:
        payload.update(extra)
    with open(os.path.join(save_path, "run_args.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)
