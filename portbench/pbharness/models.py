"""A configuration file made into the port's pipeline (the system under
test) and into the reference's, both from the same seeded weights.

A configuration file holds the port's model id and family and one section
per sub-configuration (``dit``, ``oobleck``, ``projection``,
``cosine_scheduler`` for Stable Audio; ``unet``, ``vae``, ``vocoder``,
``scheduler``, ``mel`` for the mel UNets), each the fields of the
dataclass of that name, equal to the port's registry's. The port's
pipeline is the registry's ``load_model`` for a model without a
checkpoint (weight-free ``NullTextEncoder``), holding the weights of
:mod:`.weights` in place of its host-side init.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import weights

STABLE_AUDIO = "stable-audio"
MEL_FAMILIES = ("audioldm",)


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _section(cls, values: dict):
    return cls(**{k: _tuplify(v) for k, v in values.items()})


def _meta(factory):
    with torch.device("meta"):
        return factory()


# ----------------------------------------------------------------- reference
def reference_configs(cfg: dict) -> Dict[str, object]:
    from pbreference.models.dit1d import DiT1DConfig
    from pbreference.models.hifigan import HifiGanConfig
    from pbreference.models.oobleck import OobleckConfig
    from pbreference.models.projection import ProjectionConfig
    from pbreference.models.unet2d import UNet2DConditionConfig
    from pbreference.models.vae import AutoencoderKLConfig
    from pbreference.ops.stft import MelConfig
    from pbreference.schedulers.cosine_dpm import CosineDPMConfig
    from pbreference.schedulers.ddim import DDIMConfig

    classes = {"dit": DiT1DConfig, "oobleck": OobleckConfig, "projection": ProjectionConfig,
               "cosine_scheduler": CosineDPMConfig, "unet": UNet2DConditionConfig,
               "vae": AutoencoderKLConfig, "vocoder": HifiGanConfig, "scheduler": DDIMConfig,
               "mel": MelConfig}
    return {k: _section(c, cfg[k]) for k, c in classes.items() if k in cfg}


def reference_factories(cfg: dict) -> Dict[str, object]:
    """name -> factory of each weighted module, reference classes."""
    c = reference_configs(cfg)
    if cfg["family"] == STABLE_AUDIO:
        from pbreference.models.dit1d import StableAudioDiT
        from pbreference.models.oobleck import AutoencoderOobleck
        from pbreference.models.projection import StableAudioProjectionModel

        return {"dit": lambda: StableAudioDiT(c["dit"]),
                "oobleck": lambda: AutoencoderOobleck(c["oobleck"]),
                "projection": lambda: StableAudioProjectionModel(c["projection"])}
    from pbreference.models.hifigan import HifiGanGenerator
    from pbreference.models.unet2d import UNet2DConditionModel
    from pbreference.models.vae import AutoencoderKL

    return {"unet": lambda: UNet2DConditionModel(c["unet"]),
            "vae": lambda: AutoencoderKL(c["vae"]),
            "vocoder": lambda: HifiGanGenerator(c["vocoder"])}


def make_states(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The float32 seeded weights of every module of the configuration."""
    return {name: weights.make_state(_meta(f), device, seed, name)
            for name, f in reference_factories(cfg).items()}


def text_seq_len(cfg: dict) -> int:
    return cfg.get("text_seq_len") or 8


def build_reference(cfg: dict, seed: int, steps: int, device, serve_dtype: torch.dtype):
    """The reference pipeline in float32 holding the values the port's
    modules hold in ``serve_dtype``, built from the same seed."""
    from pbreference import precision
    from pbreference.models.text_encoders import NullTextEncoder

    c = reference_configs(cfg)
    states = make_states(cfg, seed, device)
    mods = {}
    for name, factory in reference_factories(cfg).items():
        m = _meta(factory)
        m.load_state_dict(weights.rounded_to(states.pop(name), m, serve_dtype),
                          strict=True, assign=True)
        mods[name] = precision.apply(m.eval().requires_grad_(False))
    if cfg["family"] == STABLE_AUDIO:
        from pbreference.editing.solvers import CosineDPMSolver
        from pbreference.models.pipeline1d import StableAudioPipeline
        from pbreference.schedulers.cosine_dpm import make_cosine_dpm_schedule

        pipe = StableAudioPipeline(
            model_id=cfg["model_id"],
            sched=CosineDPMSolver(make_cosine_dpm_schedule(c["cosine_scheduler"], steps,
                                                           device=device)),
            dit=mods["dit"], vae=mods["oobleck"], projection=mods["projection"],
            text_encoder=NullTextEncoder(hidden_dim=c["projection"].conditioning_dim,
                                         seq_len=text_seq_len(cfg), device=device),
            sample_rate=cfg["sample_rate"], sample_size=c["dit"].sample_size)
        pipe.setup_duration()
        return pipe
    from pbreference.models.pipeline import LatentAudioPipeline
    from pbreference.schedulers.ddim import make_schedule

    return LatentAudioPipeline(
        model_id=cfg["model_id"], sched=make_schedule(c["scheduler"], steps, device=device),
        unet=mods["unet"], vae=mods["vae"], vocoder=mods["vocoder"],
        text_encoder=NullTextEncoder(
            class_dim=c["unet"].projection_class_embeddings_input_dim, device=device),
        mel_config=c["mel"], sample_rate=cfg["sample_rate"],
        vae_pad_multiple=c["vae"].downscale_factor)


# ---------------------------------------------------------------- the port
PORT_MODULES = {STABLE_AUDIO: {"dit": "dit", "oobleck": "vae", "projection": "projection"},
                "audioldm": {"unet": "unet", "vae": "vae", "vocoder": "vocoder"}}


def port_spec(cfg: dict):
    """The port's ModelSpec of the file's model id. Each section of the
    file, and its sample rate and text length, has to equal the registry's:
    the file states what is run."""
    from audioeditingcode_tpu_torch.models.registry import resolve_spec

    spec = resolve_spec(cfg["model_id"])
    if spec.family != cfg["family"]:
        raise ValueError(f"{cfg['model_id']}: the port's family is {spec.family}, "
                         f"the file says {cfg['family']}")
    for k, v in cfg.items():
        have = getattr(spec, k, None)
        if dataclasses.is_dataclass(have):
            v = _section(type(have), v)
        elif k not in ("sample_rate", "text_seq_len"):
            continue
        if v != have:
            raise ValueError(f"{cfg['model_id']}: the file's {k} is not the port's registry's")
    return spec


def build_port(cfg: dict, seed: int, steps: int, device, dtype: torch.dtype):
    """The port's pipeline for ``cfg`` in ``dtype`` on ``device``, assembled
    by the registry's ``load_model`` and holding the seeded weights of
    :mod:`.weights`. The registry's own seeded init draws leaf by leaf on
    the host; as every parameter is then loaded strictly from the device's
    draws, the build allocates the modules empty on the device instead."""
    from unittest import mock

    from audioeditingcode_tpu_torch.models import registry

    spec = port_spec(cfg)
    with mock.patch.object(registry, "seeded",
                           lambda factory, g: registry._meta(factory).to_empty(device=device)):
        pipe = registry.load_model(spec.model_id, steps, device, dtype, seed)
    states = make_states(cfg, seed, device)
    with torch.no_grad():
        for name, attr in PORT_MODULES[spec.family].items():
            getattr(pipe, attr).load_state_dict(states.pop(name), strict=True)
    return pipe
