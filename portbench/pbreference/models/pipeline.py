"""LatentAudioPipeline: schedule + UNet + VAE + vocoder + text encoder.

Counterpart of ``audioeditingcode_tpu/models/pipeline.py``: the model seam
the editing loops consume. Latents are NCHW at this boundary; the UNet's
cond and uncond streams run in ONE batched forward per step. Modules run in
the pipeline's dtype; latents and the schedule math stay float32. The image
models go through the same pipeline: an RGB image (B, 3, H, W) in [-1, 1]
takes the place of the mel image, the VAE may be a ``VQModel``
(CelebA-HQ), and there is no vocoder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import torch
from torch.nn import functional as F

from ..editing.invert import make_cfg_denoiser
from ..ops.stft import MelConfig
from ..schedulers.ddim import DiffusionSchedule
from .hifigan import HifiGanGenerator
from .text_encoders import TextCond, concat_conds, repeat_cond
from .unet2d import UNet2DConditionModel
from .vae import AutoencoderKL, VQModel


@dataclasses.dataclass
class LatentAudioPipeline:
    model_id: str
    sched: DiffusionSchedule
    unet: UNet2DConditionModel
    vae: Union[AutoencoderKL, VQModel]
    vocoder: Optional[HifiGanGenerator]
    text_encoder: Callable[..., TextCond]
    mel_config: MelConfig
    sample_rate: int = 16000
    vae_pad_multiple: int = 4
    max_mel_frames: Optional[int] = None  # TANGO: 1700

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    def encode_text(self, prompts: List[str], negative: bool = False) -> TextCond:
        return self.text_encoder(prompts, negative=negative)

    @torch.no_grad()
    def unet_eps(self, x: torch.Tensor, t: torch.Tensor, cond: TextCond) -> torch.Tensor:
        """One denoiser forward: NCHW latent batch -> NCHW model output."""
        ts = torch.as_tensor(t, device=x.device).reshape(()).expand(x.shape[0])
        out = self.unet(x.to(self.dtype), ts, cond.hidden_states, cond.class_labels,
                        cond.attention_mask, cond.hidden_states_1, cond.attention_mask_1)
        return out.to(x.dtype)

    def make_eps_pair(self, uncond: TextCond, cond: Optional[TextCond]):
        """eps_pair_fn(x_u, x_c, k) with both streams in one UNet call."""

        def pair(x_u, x_c, k):
            t = self.sched.timesteps[k]
            if cond is None or x_c is None:
                return self.unet_eps(x_u, t, repeat_cond(uncond, x_u.shape[0])), None
            # multi-prompt: broadcast the latent to the P cond prompts
            P = max(cond.batch, x_c.shape[0])
            if x_c.shape[0] == 1 and P > 1:
                x_c = x_c.expand((P,) + tuple(x_c.shape[1:]))
            cu = repeat_cond(uncond, x_u.shape[0])
            cc = repeat_cond(cond, P)
            eps = self.unet_eps(torch.cat([x_u, x_c], dim=0), t, concat_conds(cu, cc))
            return eps[: x_u.shape[0]], eps[x_u.shape[0]:]

        return pair

    def make_denoiser(self, uncond: TextCond, cond: Optional[TextCond],
                      cfg_tensor: Optional[torch.Tensor]):
        """CFG denoiser(xt, k) for the inversion/edit loops."""
        return make_cfg_denoiser(self.make_eps_pair(uncond, cond),
                                 cfg_tensor if cond is not None else None)

    @torch.no_grad()
    def vae_encode(self, x: torch.Tensor) -> torch.Tensor:
        """mel image (B, 1, T, n_mels) -> latent (B, C, T/4, n_mels/4), or
        an RGB image (B, 3, H, W) -> (B, C, H/f, W/f); the height (time)
        axis is padded at its START to a multiple of the VAE scale f."""
        h = x.shape[2]
        if self.max_mel_frames is not None and h > self.max_mel_frames:
            raise ValueError(f"Audio too long: {h} mel frames > model maximum "
                             f"{self.max_mel_frames}.")
        m = self.vae_pad_multiple
        if h % m:
            x = F.pad(x, (0, 0, m - h % m, 0))
        return self.vae.encode(x.to(self.dtype)).to(x.dtype)

    @torch.no_grad()
    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z.to(self.dtype)).to(z.dtype)

    @torch.no_grad()
    def decode_to_mel(self, x_dec: torch.Tensor) -> torch.Tensor:
        """Decoded mel image (B, 1, T, n_mels) -> waveform (B, ~T*hop)."""
        if self.vocoder is None:
            raise ValueError(f"{self.model_id} has no vocoder")
        return self.vocoder(x_dec[:, 0].to(self.dtype)).to(x_dec.dtype)

    def decode_latent_to_waveform(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode_to_mel(self.vae_decode(z))

    def get_sr(self) -> int:
        return self.sample_rate
