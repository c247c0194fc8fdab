"""The prompt conditioning of the reference: the port's ``TextCond``
bundle and its weight-free ``NullTextEncoder`` (a seeded unit vector per
prompt, zeros for the empty prompt), copied."""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Union

import numpy as np
import torch

_FIELDS = ("hidden_states", "class_labels", "attention_mask",
           "hidden_states_1", "attention_mask_1")


@dataclasses.dataclass(frozen=True)
class TextCond:
    """Conditioning for one batch of prompts."""

    hidden_states: Optional[torch.Tensor] = None  # (P, K, D) cross-attn stream
    class_labels: Optional[torch.Tensor] = None  # (P, D) FiLM stream (AudioLDM)
    attention_mask: Optional[torch.Tensor] = None  # (P, K)
    hidden_states_1: Optional[torch.Tensor] = None  # (P, K1, D1) 2nd stream
    attention_mask_1: Optional[torch.Tensor] = None  # (P, K1)

    @property
    def batch(self) -> int:
        for f in (self.hidden_states, self.class_labels, self.hidden_states_1):
            if f is not None:
                return f.shape[0]
        return 1


def concat_conds(a: TextCond, b: TextCond) -> TextCond:
    """Batch-concat two bundles for the fused CFG call. Token streams of
    different lengths are right-padded with zero embeddings and a zero mask."""
    fields = {}
    for hs_name, mask_name in (("hidden_states", "attention_mask"),
                               ("hidden_states_1", "attention_mask_1")):
        hss = [getattr(c, hs_name) for c in (a, b)]
        masks = [getattr(c, mask_name) for c in (a, b)]
        if all(h is None for h in hss):
            fields[hs_name] = fields[mask_name] = None
            continue
        if any(h is None for h in hss):
            raise ValueError(f"inconsistent TextCond field {hs_name}")
        K = max(h.shape[1] for h in hss)
        need_mask = any(m is not None for m in masks) or any(h.shape[1] != K for h in hss)
        out_h, out_m = [], []
        for h, m in zip(hss, masks):
            if m is None and need_mask:
                m = torch.ones(h.shape[:2], dtype=torch.int32, device=h.device)
            if h.shape[1] != K:
                h = torch.nn.functional.pad(h, (0, 0, 0, K - h.shape[1]))
                m = torch.nn.functional.pad(m, (0, K - m.shape[1]))
            out_h.append(h)
            out_m.append(m)
        fields[hs_name] = torch.cat(out_h, dim=0)
        fields[mask_name] = torch.cat(out_m, dim=0) if need_mask else None
    cls = [c.class_labels for c in (a, b)]
    if all(v is None for v in cls):
        fields["class_labels"] = None
    elif any(v is None for v in cls):
        raise ValueError("inconsistent TextCond field class_labels")
    else:
        fields["class_labels"] = torch.cat(cls, dim=0)
    return TextCond(**fields)


def repeat_cond(c: TextCond, n: int) -> TextCond:
    """Repeat a batch-1 bundle n times."""
    if c.batch == n:
        return c
    if c.batch != 1:
        raise ValueError(f"cannot repeat batch {c.batch} to {n}")
    return TextCond(**{f: None if getattr(c, f) is None
                       else getattr(c, f).repeat_interleave(n, dim=0) for f in _FIELDS})


class NullTextEncoder:
    """Deterministic weight-free prompt embeddings: seeded from a sha256 of
    the prompt; the empty prompt gives zeros."""

    def __init__(self, hidden_dim: Optional[int] = None, seq_len: int = 8,
                 class_dim: Optional[int] = None, hidden_dim_1: Optional[int] = None,
                 seq_len_1: int = 8, device: Union[str, torch.device] = "cpu"):
        self.hidden_dim = hidden_dim
        self.seq_len = seq_len
        self.class_dim = class_dim
        self.hidden_dim_1 = hidden_dim_1
        self.seq_len_1 = seq_len_1
        self.device = device

    def _emb(self, prompt: str, shape) -> np.ndarray:
        if prompt == "":
            return np.zeros(shape, dtype=np.float32)
        seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed)
        e = rng.standard_normal(shape).astype(np.float32)
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    def _stack(self, prompts: List[str], shape) -> torch.Tensor:
        return torch.as_tensor(np.stack([self._emb(p, shape) for p in prompts]),
                               device=self.device)

    def _mask(self, n: int, k: int) -> torch.Tensor:
        return torch.ones((n, k), dtype=torch.int32, device=self.device)

    def __call__(self, prompts: List[str], negative: bool = False) -> TextCond:
        hs = cls = hs1 = mask = mask1 = None
        if self.hidden_dim is not None:
            hs = self._stack(prompts, (self.seq_len, self.hidden_dim))
            mask = self._mask(len(prompts), self.seq_len)
        if self.class_dim is not None:
            cls = self._stack(prompts, (self.class_dim,))
        if self.hidden_dim_1 is not None:
            hs1 = self._stack(prompts, (self.seq_len_1, self.hidden_dim_1))
            mask1 = self._mask(len(prompts), self.seq_len_1)
        return TextCond(hidden_states=hs, class_labels=cls, attention_mask=mask,
                        hidden_states_1=hs1, attention_mask_1=mask1)
