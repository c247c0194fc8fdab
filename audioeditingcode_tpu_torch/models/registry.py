"""Model factory: model_id -> LatentAudioPipeline (the mel UNet families:
AudioLDM, AudioLDM2, TANGO; and the image models: Stable Diffusion,
CelebA-HQ) or StableAudioPipeline (Stable Audio family).

Counterpart of ``audioeditingcode_tpu/models/registry.py``. Weights come
from a converted-checkpoint directory (``weights_dir``, the layout that the
port's ``cli/convert_checkpoint.py`` and the JAX package's
``tools/convert_checkpoint.py`` write):

  <dir>/unet.msgpack  vae.msgpack  vocoder.msgpack          (mel families;
                                                            images: no vocoder)
  <dir>/dit.msgpack   oobleck.msgpack  projection.msgpack   (Stable Audio)
  <dir>/gpt2.msgpack  projection_lm.msgpack                 (AudioLDM2)
  <dir>/t5/  clap_text/  clip/                              (text towers)

A load goes through ``bridge.flax_to_torch_state_dict``, strict both ways:
a missing or left-over leaf or a wrong shape raises and names the file.
Without a checkpoint the modules get a seeded random init of the JAX
package's magnitudes: norm scales one, biases zero, weights N(0, 1/fan_in),
Fourier feature weights N(0, 1), Snake params zero, a VQ codebook
U(0, 2 / N) (the Flax initializer). Where a text tower is
absent from ``weights_dir`` the registry falls back to the null encoder, as
the JAX one does; where it is present, it is loaded or the load raises.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Union

import torch
from torch import nn

from ..editing.solvers import CosineDPMSolver
from ..ops.stft import MelConfig
from ..schedulers.cosine_dpm import make_cosine_dpm_schedule
from ..schedulers.ddim import make_schedule
from . import flax_msgpack
from .audioldm2_cond import AudioLDM2ProjectionModel, AudioLDM2TextEncoder, GPT2Model
from .bridge import flax_to_torch_state_dict, torch_to_flax_tree
from .configs import MODEL_SPECS, AudioLDM2ProjectionConfig, GPT2Config, ModelSpec
from .dit1d import StableAudioDiT
from .hifigan import HifiGanGenerator
from .oobleck import AutoencoderOobleck
from .pipeline import LatentAudioPipeline
from .pipeline1d import StableAudioPipeline
from .projection import StableAudioProjectionModel
from .text_encoders import (
    ClapFilmEncoder,
    ClipTextEncoder,
    NullTextEncoder,
    T5ProjectedEncoder,
    T5TextEncoder,
    TextCond,
    clap_text_features,
    load_clap_projection,
    load_text_tower,
)
from .tokenizers import Tokenizer
from .unet2d import UNet2DConditionModel
from .vae import AutoencoderKL, VQModel


def resolve_spec(model_id: str) -> ModelSpec:
    if model_id in MODEL_SPECS:
        return MODEL_SPECS[model_id]
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
        elif leaf == "codebook":  # the Flax VQ init, uniform(scale=2 / N)
            p.copy_(torch.rand(p.shape, generator=generator) * (2.0 / p.shape[0]))
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


def load_params_(module: nn.Module, path: str) -> nn.Module:
    """Load a converted ``.msgpack`` file into ``module`` (strict)."""
    t0 = time.perf_counter()
    flat = flax_msgpack.flatten(flax_msgpack.read_file(path))
    try:
        sd = flax_to_torch_state_dict(flat, module)
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path} does not match the {type(module).__name__} of this "
                         f"model: {e}") from e
    module.load_state_dict(sd, assign=True)
    flax_msgpack.LOAD_SECONDS[path] = (os.path.getsize(path), time.perf_counter() - t0)
    return module


def _weights(factory: Callable[[], nn.Module], weights_dir: Optional[str], name: str,
             g: torch.Generator, required: bool = True) -> nn.Module:
    """The module from ``<weights_dir>/<name>.msgpack``, else seeded random
    (a missing file raises unless it is not ``required``)."""
    if weights_dir is None:
        return seeded(factory, g)
    path = os.path.join(weights_dir, f"{name}.msgpack")
    if not os.path.exists(path):
        if required:
            raise FileNotFoundError(f"missing converted weights: {path}")
        return seeded(factory, g)
    return load_params_(_meta(factory), path)


def seeded(factory: Callable[[], nn.Module], g: torch.Generator) -> nn.Module:
    """The module with seeded random weights, built without torch's default
    init (``random_init_`` writes every parameter, and the modules hold no
    buffers): the weights of ``random_init_(factory(), g)`` at about half
    the host time (a 1 B-parameter DiT spends ~5 s in the default init)."""
    return random_init_(_meta(factory).to_empty(device="cpu"), g)


def _meta(factory: Callable[[], nn.Module]) -> nn.Module:
    """The module with no init: every param comes from a file."""
    with torch.device("meta"):
        return factory()


def save_params(module: nn.Module, path: str) -> int:
    """Write ``module`` as the JAX package's ``save_params`` writes its
    params (the JAX nesting, under ``params``); returns the bytes written."""
    return flax_msgpack.write_file(torch_to_flax_tree(module), path)


def to_model_dtype_(module: nn.Module, device, dtype: torch.dtype) -> nn.Module:
    """Move an inference module to ``device`` in ``dtype``, keeping float32
    (and their float32 values) the params its classes list in
    ``float32_params`` (those the Flax modules use uncast in every dtype)."""
    keep = [(m, name, m.get_parameter(name).detach()) for m in module.modules()
            for name in getattr(m, "float32_params", ())]
    module.to(device=device, dtype=dtype).eval().requires_grad_(False)
    for m, name, t in keep:
        m.get_parameter(name).data = t.to(device=device, dtype=torch.float32)
    return module


def load_model(
    model_id: str,
    num_diffusion_steps: int,
    device: Union[str, torch.device] = "cpu",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    weights_dir: Optional[str] = None,
) -> Union[LatentAudioPipeline, StableAudioPipeline]:
    """Build the pipeline for ``model_id`` on ``device``: weights from the
    converted checkpoint ``weights_dir``, else seeded random ones."""
    spec = resolve_spec(model_id)
    if spec.family == "stable-audio":
        return _load_stable_audio(spec, num_diffusion_steps, device, dtype, seed, weights_dir)
    g = torch.Generator().manual_seed(seed)
    unet = _weights(lambda: UNet2DConditionModel(spec.unet), weights_dir, "unet", g)
    vae_cls = VQModel if spec.vae.num_vq_embeddings > 0 else AutoencoderKL
    vae = _weights(lambda: vae_cls(spec.vae), weights_dir, "vae", g)
    vocoder = None  # the image models decode to pixels
    if spec.vocoder is not None:
        vocoder = _weights(lambda: HifiGanGenerator(spec.vocoder), weights_dir, "vocoder", g)
    for m in (unet, vae, vocoder):
        if m is not None:
            to_model_dtype_(m, device, dtype)
    return LatentAudioPipeline(
        model_id=model_id,
        sched=make_schedule(spec.scheduler, num_diffusion_steps, device=device),
        unet=unet,
        vae=vae,
        vocoder=vocoder,
        text_encoder=_make_text_encoder(spec, device, weights_dir),
        mel_config=spec.mel or MelConfig(),
        sample_rate=spec.sample_rate,
        vae_pad_multiple=spec.vae.downscale_factor,
        max_mel_frames=1700 if spec.family == "tango" else None,
    )


def _make_text_encoder(spec: ModelSpec, device,
                       weights_dir: Optional[str] = None) -> Callable[..., TextCond]:
    """The prompt encoder of a mel family or an image model: the
    checkpoint's text towers where ``weights_dir`` holds them, else the
    weight-free one, as the JAX registry builds it: AudioLDM's FiLM vector;
    AudioLDM2's two token streams, 8 tokens at the GPT-2 width and
    text_seq_len at the projected width; TANGO's T5 stream and Stable
    Diffusion's CLIP stream of min(text_seq_len, 64) tokens; CelebA-HQ takes
    no conditioning."""
    unet = spec.unet
    if spec.family == "celebahq":
        return NullTextEncoder(device=device)
    if weights_dir is not None:
        build = {"audioldm": _try_clap_film, "audioldm2": _try_audioldm2_chain,
                 "tango": _try_t5_encoder, "stable-diffusion": _try_clip_encoder}[spec.family]
        enc = build(spec, weights_dir, device)
        if enc is not None:
            return enc
    if spec.family == "audioldm2":
        return NullTextEncoder(hidden_dim=unet.cross_attention_dim, seq_len=8,
                               hidden_dim_1=unet.cross_attention_dim_1,
                               seq_len_1=spec.text_seq_len or 8, device=device)
    if spec.family in ("tango", "stable-diffusion"):
        return NullTextEncoder(hidden_dim=unet.cross_attention_dim,
                               seq_len=min(spec.text_seq_len, 64), device=device)
    return NullTextEncoder(class_dim=unet.projection_class_embeddings_input_dim, device=device)


def _load_stable_audio(spec: ModelSpec, num_diffusion_steps: int, device,
                       dtype: torch.dtype, seed: int,
                       weights_dir: Optional[str] = None) -> StableAudioPipeline:
    """DiT + Oobleck VAE + projection + cosine DPM solver, with the duration
    conditioning set up for the model's full length (as the JAX registry
    does eagerly). A checkpoint without ``projection.msgpack`` keeps the
    seeded projection, as the JAX registry keeps its init."""
    g = torch.Generator().manual_seed(seed)
    dit = _weights(lambda: StableAudioDiT(spec.dit), weights_dir, "dit", g)
    vae = _weights(lambda: AutoencoderOobleck(spec.oobleck), weights_dir, "oobleck", g)
    projection = _weights(lambda: StableAudioProjectionModel(spec.projection), weights_dir,
                          "projection", g, required=False)
    for m in (dit, vae, projection):
        to_model_dtype_(m, device, dtype)
    text_encoder = NullTextEncoder(hidden_dim=spec.projection.conditioning_dim,
                                   seq_len=spec.text_seq_len or 8, device=device)
    if weights_dir is not None:
        text_encoder = _try_t5_projected(spec, weights_dir, projection, device) or text_encoder
    pipe = StableAudioPipeline(
        model_id=spec.model_id,
        sched=CosineDPMSolver(make_cosine_dpm_schedule(
            spec.cosine_scheduler, num_diffusion_steps, device=device)),
        dit=dit,
        vae=vae,
        projection=projection,
        text_encoder=text_encoder,
        sample_rate=spec.sample_rate,
        sample_size=spec.dit.sample_size,
    )
    pipe.setup_duration()
    return pipe


# ------------------------------------------------------------ text towers
def _tower(weights_dir: str, name: str, device):
    """(model, tokenizer) of ``<weights_dir>/<name>/``, or None where the
    directory is absent."""
    d = os.path.join(weights_dir, name)
    if not os.path.isdir(d):
        return None
    return load_text_tower(d, device), Tokenizer.from_dir(d)


def _try_clap_film(spec: ModelSpec, weights_dir: str, device):
    """AudioLDM's CLAP text branch: RoBERTa + MLP projection, the
    L2-normalized pooled vector as the FiLM conditioning."""
    tower = _tower(weights_dir, "clap_text", device)
    if tower is None:
        return None
    d = os.path.join(weights_dir, "clap_text")
    return ClapFilmEncoder(tower[0], tower[1], load_clap_projection(d, device))


def _try_t5_encoder(spec: ModelSpec, weights_dir: str, device):
    """FLAN-T5 sequence conditioning (TANGO)."""
    tower = _tower(weights_dir, "t5", device)
    if tower is None:
        return None
    return T5TextEncoder(tower[0], tower[1], max_length=min(spec.text_seq_len or 512, 512))


def _try_clip_encoder(spec: ModelSpec, weights_dir: str, device):
    """CLIP text conditioning (Stable Diffusion)."""
    tower = _tower(weights_dir, "clip", device)
    if tower is None:
        return None
    return ClipTextEncoder(*tower)


def _try_t5_projected(spec: ModelSpec, weights_dir: str, projection, device):
    """Stable Audio: the T5 encoder through the learned text projection."""
    tower = _tower(weights_dir, "t5", device)
    if tower is None:
        return None
    return T5ProjectedEncoder(T5TextEncoder(tower[0], tower[1],
                                            max_length=spec.text_seq_len or 128), projection)


def _try_audioldm2_chain(spec: ModelSpec, weights_dir: str, device):
    """The CLAP + T5 + GPT-2 chain of ``clap_text/``, ``t5/``,
    ``gpt2.msgpack`` and ``projection_lm.msgpack``; None where none of them
    is there (a part of them raises)."""
    parts = ("gpt2.msgpack", "projection_lm.msgpack", "t5", "clap_text")
    have = [os.path.exists(os.path.join(weights_dir, p)) for p in parts]
    if not any(have):
        return None
    if not all(have):
        missing = [p for p, h in zip(parts, have) if not h]
        raise FileNotFoundError(f"{weights_dir}: the AudioLDM2 text chain lacks {missing}")
    roberta, clap_tok = _tower(weights_dir, "clap_text", device)
    clap_proj = load_clap_projection(os.path.join(weights_dir, "clap_text"), device)
    t5, t5_tok = _tower(weights_dir, "t5", device)

    def t5_features(prompts):
        ids, mask = t5_tok(prompts, padding=True, max_length=t5_tok.model_max_length)
        ids = torch.as_tensor(ids, device=device)
        mask = torch.as_tensor(mask, device=device)
        return t5(ids, mask), mask

    def clap_features(prompts):
        return clap_text_features(roberta, clap_tok, clap_proj, prompts)

    gpt2 = load_params_(_meta(lambda: GPT2Model(spec.gpt2 or GPT2Config())),
                        os.path.join(weights_dir, "gpt2.msgpack"))
    projection = load_params_(
        _meta(lambda: AudioLDM2ProjectionModel(spec.projection_lm
                                               or AudioLDM2ProjectionConfig())),
        os.path.join(weights_dir, "projection_lm.msgpack"))
    return AudioLDM2TextEncoder(clap_features, t5_features,
                                to_model_dtype_(projection, device, torch.float32),
                                to_model_dtype_(gpt2, device, torch.float32))


