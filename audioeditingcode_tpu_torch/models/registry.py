"""Model factory: model_id -> LatentAudioPipeline (the mel UNet families:
AudioLDM, AudioLDM2, TANGO) or StableAudioPipeline (Stable Audio family).

Counterpart of ``audioeditingcode_tpu/models/registry.py``. Without a
checkpoint the modules get a seeded random init of the JAX package's
magnitudes: norm scales one, biases zero, weights N(0, 1/fan_in), Fourier
feature weights N(0, 1), Snake params zero.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ..editing.solvers import CosineDPMSolver
from ..schedulers.cosine_dpm import make_cosine_dpm_schedule
from ..schedulers.ddim import make_schedule
from .configs import MODEL_SPECS, ModelSpec
from .dit1d import StableAudioDiT
from .hifigan import HifiGanGenerator
from .oobleck import AutoencoderOobleck
from .pipeline import LatentAudioPipeline
from .pipeline1d import StableAudioPipeline
from .projection import StableAudioProjectionModel
from .text_encoders import NullTextEncoder, TextCond
from .unet2d import UNet2DConditionModel
from .vae import AutoencoderKL

# model ids of the JAX package that this port does not cover yet, with the
# ROADMAP item that adds them
_NOT_PORTED = {
    "CompVis/stable-diffusion-v1-4": "Queue A item 11 (cli/images.py)",
    "CompVis/ldm-celebahq-256": "Queue A item 11 (cli/images.py)",
    "test/tiny-sd": "Queue A item 11 (cli/images.py)",
    "test/tiny-celebahq": "Queue A item 11 (cli/images.py)",
}


def resolve_spec(model_id: str) -> ModelSpec:
    if model_id in MODEL_SPECS:
        return MODEL_SPECS[model_id]
    if model_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_id} is not ported to PyTorch yet: ROADMAP {_NOT_PORTED[model_id]}")
    raise KeyError(f"unknown model_id {model_id!r}; known: {sorted(MODEL_SPECS)}")


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in place, drawn on the CPU in parameter order
    (so a seed gives the same weights on every device)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if leaf == "bias":
            p.zero_()
        elif getattr(owner, "fourier_features", False):  # fixed random features
            p.copy_(torch.randn(p.shape, generator=generator))
        elif leaf in ("alpha", "beta"):  # Snake log-scales
            p.zero_()
        elif p.dim() == 1:  # norm weights (and the vocoder's mean/scale stats)
            p.fill_(0.0 if leaf == "mean" else 1.0)
        else:
            # fan-in of the Flax kernel: every dim but its output one
            # (ConvTranspose1d keeps (in, out, k) in torch)
            fan_in = p.numel() // (p.shape[1] if isinstance(owner, nn.ConvTranspose1d)
                                   else p.shape[0])
            w = torch.randn(p.shape, generator=generator) / fan_in ** 0.5
            p.copy_(w)
    return module


def to_model_dtype_(module: nn.Module, device, dtype: torch.dtype) -> nn.Module:
    """Move an inference module to ``device`` in ``dtype``, keeping float32
    the params its classes list in ``float32_params`` (those the Flax
    modules use uncast in every dtype)."""
    module.to(device=device, dtype=dtype).eval().requires_grad_(False)
    for m in module.modules():
        for name in getattr(m, "float32_params", ()):
            p = m.get_parameter(name)
            p.data = p.data.float()
    return module


def load_model(
    model_id: str,
    num_diffusion_steps: int,
    device: Union[str, torch.device] = "cpu",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    weights_dir: Optional[str] = None,
) -> Union[LatentAudioPipeline, StableAudioPipeline]:
    """Build the pipeline for ``model_id`` on ``device`` with seeded random
    weights (converted checkpoints are not supported yet)."""
    spec = resolve_spec(model_id)
    if weights_dir is not None:
        raise NotImplementedError(
            "--weights_dir: loading converted checkpoints into the PyTorch port "
            "is not supported yet (ROADMAP Queue A item 13)")
    if spec.family == "stable-audio":
        return _load_stable_audio(spec, num_diffusion_steps, device, dtype, seed)
    g = torch.Generator().manual_seed(seed)
    unet = random_init_(UNet2DConditionModel(spec.unet), g)
    vae = random_init_(AutoencoderKL(spec.vae), g)
    vocoder = random_init_(HifiGanGenerator(spec.vocoder), g)
    for m in (unet, vae, vocoder):
        to_model_dtype_(m, device, dtype)
    return LatentAudioPipeline(
        model_id=model_id,
        sched=make_schedule(spec.scheduler, num_diffusion_steps, device=device),
        unet=unet,
        vae=vae,
        vocoder=vocoder,
        text_encoder=_make_text_encoder(spec, device),
        mel_config=spec.mel,
        sample_rate=spec.sample_rate,
        vae_pad_multiple=spec.vae.downscale_factor,
        max_mel_frames=1700 if spec.family == "tango" else None,
    )


def _make_text_encoder(spec: ModelSpec, device) -> Callable[..., TextCond]:
    """The weight-free prompt encoder of a mel family, as the JAX registry
    builds it without converted weights (the text towers need a checkpoint:
    ROADMAP Queue A item 13): AudioLDM's FiLM vector; AudioLDM2's two token
    streams, 8 tokens at the GPT-2 width and text_seq_len at the projected
    width; TANGO's T5 stream of min(text_seq_len, 64) tokens."""
    unet = spec.unet
    if spec.family == "audioldm2":
        return NullTextEncoder(hidden_dim=unet.cross_attention_dim, seq_len=8,
                               hidden_dim_1=unet.cross_attention_dim_1,
                               seq_len_1=spec.text_seq_len or 8, device=device)
    if spec.family == "tango":
        return NullTextEncoder(hidden_dim=unet.cross_attention_dim,
                               seq_len=min(spec.text_seq_len, 64), device=device)
    return NullTextEncoder(class_dim=unet.projection_class_embeddings_input_dim, device=device)


def _load_stable_audio(spec: ModelSpec, num_diffusion_steps: int, device,
                       dtype: torch.dtype, seed: int) -> StableAudioPipeline:
    """DiT + Oobleck VAE + projection + cosine DPM solver, with the duration
    conditioning set up for the model's full length (as the JAX registry
    does eagerly)."""
    g = torch.Generator().manual_seed(seed)
    dit = random_init_(StableAudioDiT(spec.dit), g)
    vae = random_init_(AutoencoderOobleck(spec.oobleck), g)
    projection = random_init_(StableAudioProjectionModel(spec.projection), g)
    for m in (dit, vae, projection):
        to_model_dtype_(m, device, dtype)
    pipe = StableAudioPipeline(
        model_id=spec.model_id,
        sched=CosineDPMSolver(make_cosine_dpm_schedule(
            spec.cosine_scheduler, num_diffusion_steps, device=device)),
        dit=dit,
        vae=vae,
        projection=projection,
        text_encoder=NullTextEncoder(hidden_dim=spec.projection.conditioning_dim,
                                     seq_len=spec.text_seq_len or 8, device=device),
        sample_rate=spec.sample_rate,
        sample_size=spec.dit.sample_size,
    )
    pipe.setup_duration()
    return pipe
