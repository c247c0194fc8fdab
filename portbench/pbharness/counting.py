"""The yardstick's arithmetic: the work of a denoiser forward and of each
kernel launch, counted from shapes, and the card's peaks.

Each product, exponential, input byte and output byte is counted once,
whatever a kernel does: a float32 product is one product even where a
kernel computes it as three TF32 ones, so a kernel that changes its scheme
reads against the same count. The forward's FLOPs and its B1 and B3
launches come from running the reference's modules on the ``meta`` device
at the forward's shapes (``torch.utils.flop_counter``: 2 M N K per
product), with the port's dispatch rule recording which calls it sends to
B1 and B3.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
BF16_FLOPS = 989e12
# a float32 configuration's products can run no faster than the TF32
# tensor-core rate: no implementation reads over 100 % against it
F32_FLOPS = 495e12
HBM_BYTES = 3.35e12
# the SFU's exponentials: 16 results per clock per SM (CUDA C programming
# guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x the 1.98 GHz boost clock the data sheet's rates assume
EXPS = 16 * 132 * 1.98e9


def peak_flops(dtype: torch.dtype) -> float:
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


def _esz(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    exps: float

    def bound_s(self, dtype: torch.dtype) -> float:
        """The least time the card could take: the largest of the three."""
        return max(self.flops / peak_flops(dtype), self.bytes / HBM_BYTES, self.exps / EXPS)


def attention_work(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
                   dtype: torch.dtype) -> Work:
    """B1 on (B, Sq, H, D) queries over (B, Skv, H_kv, D) keys and values:
    Q K^T and P V, a softmax exponential per score; q, k, v read and o
    written once."""
    e = _esz(dtype)
    return Work(flops=4.0 * B * H * Sq * Skv * D,
                bytes=float(e * (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D)),
                exps=float(B * H * Sq * Skv))


def swiglu_work(M: int, E: int, N: int, dtype: torch.dtype) -> Work:
    """B3 on x (M, E) and W (2N, E): the (M, 2N) product, a sigmoid
    exponential per gate; x, W and the float32 bias read, (M, N) written
    once."""
    e = _esz(dtype)
    return Work(flops=2.0 * M * E * 2 * N,
                bytes=float(e * (M * E + 2 * N * E + M * N) + 4 * 2 * N),
                exps=float(M * N))


@dataclasses.dataclass(frozen=True)
class ForwardCount:
    """One denoiser forward: its FLOPs and its B1 and B3 launches."""

    flops: float
    b1: Tuple[Tuple[int, ...], ...]  # (B, Sq, Skv, H, H_kv, D) per launch
    b3: Tuple[Tuple[int, int, int], ...]  # (M, E, N) per launch

    def kernel_bound_s(self, kernel: str, dtype: torch.dtype) -> float:
        if kernel == "B1":
            return sum(attention_work(*s, dtype=dtype).bound_s(dtype) for s in self.b1)
        return sum(swiglu_work(*s, dtype=dtype).bound_s(dtype) for s in self.b3)


def _denoiser_call(cfg: dict, latent_shape: Tuple[int, ...], rows: int):
    """(module factory, kwargs on meta) of one forward of ``rows`` rows of
    latents shaped ``latent_shape`` (one row's shape, the pipeline's layout)."""
    from .models import STABLE_AUDIO, reference_configs, text_seq_len

    c = reference_configs(cfg)
    meta = dict(device="meta")
    if cfg["family"] == STABLE_AUDIO:
        from pbreference.models.dit1d import StableAudioDiT

        d = c["dit"]
        C, L = latent_shape
        K = text_seq_len(cfg) + 2  # text tokens, then the start and end embeds
        return (lambda: StableAudioDiT(d)), dict(
            sample=torch.empty((rows, L, C), **meta),
            timestep=torch.empty((rows,), **meta),
            encoder_hidden_states=torch.empty((rows, K, d.cross_attention_input_dim), **meta),
            global_hidden_states=torch.empty((rows, 1, d.global_states_input_dim), **meta),
            rotary=(torch.empty((L + 1, d.rotary_embed_dim), **meta),
                    torch.empty((L + 1, d.rotary_embed_dim), **meta)))
    from pbreference.models.unet2d import UNet2DConditionModel

    u = c["unet"]
    return (lambda: UNet2DConditionModel(u)), dict(
        sample=torch.empty((rows,) + tuple(latent_shape), **meta),
        timesteps=torch.empty((rows,), **meta),
        class_labels=torch.empty((rows, u.projection_class_embeddings_input_dim), **meta))


def count_forward(cfg: dict, latent_shape: Tuple[int, ...], rows: int) -> ForwardCount:
    """The work of one denoiser forward of ``rows`` rows."""
    from torch.utils.flop_counter import FlopCounterMode

    from pbreference.ops import flash_attention, swiglu

    factory, kwargs = _denoiser_call(cfg, latent_shape, rows)
    with torch.device("meta"):
        module = factory()
    b1: List[tuple] = []
    b3: List[tuple] = []
    flash_attention.RECORD, swiglu.RECORD = b1, b3
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            module(**kwargs)
    finally:
        flash_attention.RECORD = swiglu.RECORD = None
    return ForwardCount(flops=float(fc.get_total_flops()), b1=tuple(b1), b3=tuple(b3))
