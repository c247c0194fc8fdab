"""Stable Audio pipeline: DiT + Oobleck VAE + duration conditioning.

Counterpart of ``audioeditingcode_tpu/models/pipeline1d.py``: the model seam
the editing loops consume, with the same behaviour:

- the solver is a :class:`..editing.solvers.CosineDPMSolver`, and the input
  preconditioning (``scale_input``) happens inside the denoiser, so the
  editing loops stay generic;
- duration conditioning (start/end hidden states appended to the text
  stream, and the global token) and the rotary tables for L + 1 positions
  are computed once by :meth:`setup_duration`;
- latents are (B, C, L) at this boundary; the DiT runs (B, L, C). Modules
  run in the pipeline's dtype; latents and the solver math stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import torch

from ..editing.invert import make_cfg_denoiser
from ..editing.solvers import CosineDPMSolver
from .dit1d import StableAudioDiT, rotary_tables
from .oobleck import AutoencoderOobleck
from .projection import StableAudioProjectionModel
from .text_encoders import TextCond, concat_conds, repeat_cond


@dataclasses.dataclass
class StableAudioPipeline:
    model_id: str
    sched: CosineDPMSolver
    dit: StableAudioDiT
    vae: AutoencoderOobleck
    projection: StableAudioProjectionModel
    text_encoder: Callable[..., TextCond]
    sample_rate: int = 44100
    sample_size: int = 1024  # latent length (DiT sample_size)

    # set by setup_duration:
    _duration_embeds: Optional[torch.Tensor] = None  # (1 or N clips, 2, D) start/end
    _global_states: Optional[torch.Tensor] = None  # (1 or N clips, 1, 2D)
    _rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # (L+1, rot) each
    _waveform_start: int = 0
    _waveform_end: Optional[int] = None

    mel_config = None  # the waveform path has no mel frontend

    @property
    def dtype(self) -> torch.dtype:
        return self.dit.dtype

    @property
    def device(self) -> torch.device:
        return self.dit.proj_in.weight.device

    @property
    def hop_length(self) -> int:
        return self.vae.config.hop_length

    @property
    def audio_vae_length(self) -> int:
        return self.sample_size * self.hop_length

    # ----------------------------------------------------- duration setup
    @torch.no_grad()
    def setup_duration(self, audio_start_in_s: float = 0.0,
                       audio_end_in_s: Optional[float] = None) -> None:
        """Duration embeds, global token, rotary tables and the decode crop."""
        max_s = self.audio_vae_length / self.sample_rate
        if audio_end_in_s is None:
            audio_end_in_s = max_s
        if audio_end_in_s - audio_start_in_s > max_s:
            raise ValueError(
                f"The total audio length requested "
                f"({audio_end_in_s - audio_start_in_s}s) is longer than the model "
                f"maximum possible length ({max_s})."
            )
        self._waveform_start = int(audio_start_in_s * self.sample_rate)
        self._waveform_end = int(audio_end_in_s * self.sample_rate)
        dev = self.device
        start, end = self.projection.encode_duration(
            torch.tensor([audio_start_in_s], dtype=torch.float32, device=dev),
            torch.tensor([audio_end_in_s], dtype=torch.float32, device=dev))
        self._duration_embeds = torch.cat([start, end], dim=1)
        self._global_states = torch.cat([start, end], dim=2)
        self._rotary = rotary_tables(self.dit.config.rotary_embed_dim,
                                     self.sample_size + 1, device=dev)

    @torch.no_grad()
    def setup_clip_durations(self, durations_in_s: List[float]) -> None:
        """Duration conditioning per clip, for N clips edited in one batch:
        row i of the duration embeds and the global token conditions clip i
        on [0, durations_in_s[i]] (each row as :meth:`setup_duration` makes
        it for that clip alone). The rotary tables and the decode crop cover
        the longest clip."""
        rows = []
        for d in durations_in_s:
            self.setup_duration(0.0, d)
            rows.append((self._duration_embeds, self._global_states))
        self.setup_duration(0.0, max(durations_in_s))
        self._duration_embeds = torch.cat([r[0] for r in rows], dim=0)  # (N, 2, D)
        self._global_states = torch.cat([r[1] for r in rows], dim=0)  # (N, 1, 2D)

    def shard_clip_rows(self, shard) -> None:
        """Keep this rank's rows of per-clip duration state (N clips split
        over dp; ``shard`` is ``parallel.mesh.Axis.shard``). One row for all
        clips stays as it is."""
        if self._duration_embeds is not None and self._duration_embeds.shape[0] > 1:
            self._duration_embeds = shard(self._duration_embeds)
            self._global_states = shard(self._global_states)

    def _require_setup(self):
        if self._duration_embeds is None:
            self.setup_duration()

    @staticmethod
    def _rows(state: torch.Tensor, B: int) -> torch.Tensor:
        """The duration state for a forward of B rows: one row for all, or
        per-clip rows repeated along the CFG fold (the N unconditional rows,
        then the N conditional ones)."""
        n = state.shape[0]
        if n == 1:
            return state.expand((B,) + tuple(state.shape[1:]))
        if B % n:
            raise ValueError(f"a forward of {B} rows for {n} clips' duration conditioning")
        return state.repeat((B // n,) + (1,) * (state.dim() - 1))

    # ----------------------------------------------------------- text
    def encode_text(self, prompts: List[str], negative: bool = False) -> TextCond:
        """Text embeds; an all-empty prompt list gives an all-zero stream and
        an all-zero mask, the marker on which :meth:`dit_forward` zeroes the
        whole stream, duration embeds included."""
        cond = self.text_encoder(prompts, negative=negative)
        hs, mask = cond.hidden_states, cond.attention_mask
        if mask is None:
            mask = torch.ones(hs.shape[:2], dtype=torch.int32, device=hs.device)
        if all(p == "" for p in prompts):
            return TextCond(hidden_states=torch.zeros_like(hs),
                            attention_mask=torch.zeros_like(mask))
        return TextCond(hidden_states=hs * mask[..., None].to(hs.dtype), attention_mask=mask)

    # ----------------------------------------------------------- denoiser
    @torch.no_grad()
    def dit_forward(self, x: torch.Tensor, t: torch.Tensor, cond: TextCond) -> torch.Tensor:
        """One DiT forward: (B, C, L) scaled latent -> raw v-prediction
        (B, C, L) in x's dtype."""
        self._require_setup()
        B = x.shape[0]
        hs = cond.hidden_states
        dur = self._rows(self._duration_embeds, B)
        embeds = torch.cat([hs, dur.to(hs.dtype)], dim=1)
        if cond.attention_mask is not None:
            # an all-zero mask is the unconditional branch: zero the whole
            # stream, duration embeds included
            valid = (cond.attention_mask.sum(dim=1) > 0).to(embeds.dtype)
            embeds = embeds * valid[:, None, None]
        glob = self._rows(self._global_states, B)
        ts = torch.as_tensor(t, device=x.device).reshape(()).expand(B)
        out = self.dit(x.transpose(1, 2), ts, embeds, glob, self._rotary)
        return out.transpose(1, 2).to(x.dtype)

    def make_eps_pair(self, uncond: TextCond, cond: Optional[TextCond]):
        """pair(x_u, x_c, k): both CFG streams in ONE DiT call, with the
        solver's input preconditioning applied inside."""
        solver = self.sched

        def pair(x_u, x_c, k):
            t = solver.sched.timesteps[k]
            if cond is None or x_c is None:
                x_in = solver.scale_input(k, x_u)
                return self.dit_forward(x_in, t, repeat_cond(uncond, x_u.shape[0])), None
            # multi-prompt: broadcast the latent to the P cond prompts
            P = max(cond.batch, x_c.shape[0])
            if x_c.shape[0] == 1 and P > 1:
                x_c = x_c.expand((P,) + tuple(x_c.shape[1:]))
            cu = repeat_cond(uncond, x_u.shape[0])
            cc = repeat_cond(cond, P)
            x_in = solver.scale_input(k, torch.cat([x_u, x_c], dim=0))
            eps = self.dit_forward(x_in, t, concat_conds(cu, cc))
            return eps[: x_u.shape[0]], eps[x_u.shape[0]:]

        return pair

    def make_denoiser(self, uncond: TextCond, cond: Optional[TextCond],
                      cfg_tensor: Optional[torch.Tensor]):
        """CFG denoiser(xt, k) for the inversion/edit loops."""
        return make_cfg_denoiser(self.make_eps_pair(uncond, cond),
                                 cfg_tensor if cond is not None else None)

    # ----------------------------------------------------------- vae
    @torch.no_grad()
    def vae_encode(self, x: torch.Tensor,
                   noise: Union[torch.Tensor, torch.Generator, None] = None) -> torch.Tensor:
        """Waveform (C, T) or (B, C, T) -> sampled latent (B, 64, L), in the
        model dtype. The waveform is zero-padded or trimmed to the fixed
        ``audio_vae_length`` and mono is repeated to stereo. ``noise`` is
        the (B, 64, L) draw of the latent sample or a generator (default: a
        generator seeded 0)."""
        if x.dim() == 2:
            x = x[None]
        channels = self.vae.config.audio_channels
        if x.shape[1] == 1 and channels == 2:
            x = x.repeat(1, 2, 1)
        T = self.audio_vae_length
        audio = torch.zeros((x.shape[0], channels, T), dtype=x.dtype, device=x.device)
        n = min(x.shape[-1], T)
        audio[:, :, :n] = x[:, :, :n]
        if noise is None:
            noise = torch.Generator(device=x.device).manual_seed(0)
        return self.vae.encode_sample(audio.to(self.dtype), noise)

    @torch.no_grad()
    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent (B, 64, L) -> waveform (B, 2, T) cropped to the requested
        duration, in z's dtype."""
        self._require_setup()
        aud = self.vae.decode(z.to(self.dtype)).to(z.dtype)
        return aud[:, :, self._waveform_start: self._waveform_end]

    def decode_to_mel(self, x_dec: torch.Tensor) -> torch.Tensor:
        """Waveform passthrough: Stable Audio decodes straight to audio."""
        return x_dec

    def get_sr(self) -> int:
        return self.sample_rate
