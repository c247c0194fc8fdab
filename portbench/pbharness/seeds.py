"""Every draw of a run comes from ``--seed`` and a name: the same seed
gives the same weights, clips and draws, on both sides of a comparison."""

from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, *names) -> int:
    """A 63-bit seed for the draw ``names`` of run seed ``seed`` (any whole
    number)."""
    key = ":".join([str(int(seed))] + [str(n) for n in names]).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *names))
