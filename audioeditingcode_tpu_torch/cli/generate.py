"""Standalone generation CLI on PyTorch: text-to-audio, style transfer,
inpainting and super-resolution.

Counterpart of ``audioeditingcode_tpu/cli/generate.py``, with the same
flags, defaults and output names (``<text>_<timestamp>_<i>.wav`` under
``--save_path``, and ``run_args.json``). Run it as ``python -m
audioeditingcode_tpu_torch.cli.generate`` or ``aetorch-generate``. It runs
on the CUDA card ``--device_num`` unless ``--device cpu`` is given; a
missing card is an error.

Every random draw (the start latent, the per-step variance noise and
inpainting's kept-region noise) comes from one ``torch.Generator`` seeded
with ``--seed``; for Stable Audio the solver's per-step noise is by default
the Brownian path's increments (``--noise_sampler brownian``), drawn on the
host. The mel families run the ``-n`` candidates one at a time through the
CFG denoiser, as the JAX CLI does. ``run_args.json`` records the loop's
seconds (``generate_seconds``, synchronised host clock), its denoiser
forwards (``unet_steps``) and, for inpainting, whether the result equals
the source latent bit for bit outside the mask (``kept_region_bit_exact``).
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from ..editing.cfg import build_cfg_tensors
from ..editing.generate import (
    inpaint_latents,
    inpaint_latents_cosine,
    style_transfer_latents,
    text_to_audio_latents,
    transfer_skip,
)
from ..editing.sdedit import sdedit_loop_cosine
from ..models.registry import load_model, resolve_spec
from ..utils.audio_io import load_audio, write_wav
from ..utils.device import resolve_device
from .common import StageClock, dump_run_summary, set_reproducibility, timestamp_name

MEL_FPS = 102.4  # mel frames per second of the 16 kHz frontend


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Text-to-audio generation")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("-t", "--text", type=str, default="")
    p.add_argument("-f", "--file_path", type=str, default=None,
                   help="source wav: presence switches to style transfer")
    p.add_argument("--mode", type=str, default=None,
                   choices=[None, "generation", "transfer", "inpaint", "sr"])
    p.add_argument("--transfer_strength", type=float, default=0.5)
    p.add_argument("-s", "--seed", type=int, default=42)
    p.add_argument("--model_id", type=str, default="cvssp/audioldm-s-full-v2")
    p.add_argument("-dur", "--duration", type=float, default=10.0)
    p.add_argument("-gs", "--guidance_scale", type=float, default=2.5)
    p.add_argument("-n", "--n_candidate_gen_per_text", type=int, default=1)
    p.add_argument("--ddim_steps", type=int, default=200)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--inpaint_window", type=float, nargs=2, default=None,
                   help="seconds [start, end] to regenerate (inpaint mode)")
    p.add_argument("--time_mask_ratio", type=float, nargs=2, default=None,
                   help="fraction [start, end] of the time axis to regenerate")
    p.add_argument("--freq_mask_ratio", type=float, nargs=2, default=None,
                   help="fraction [start, end] of the mel-bin axis to regenerate; "
                        "sr mode defaults to 0.75 1.0")
    p.add_argument("--noise_sampler", type=str, default="brownian",
                   choices=["brownian", "iid"],
                   help="Stable Audio only: the solver's variance noise, the "
                        "increments of one Brownian path or i.i.d. draws")
    p.add_argument("--save_path", type=str, default="./output")
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    return p


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def _empty_window_error() -> ValueError:
    return ValueError("inpaint window selects nothing (out of range or empty) — the "
                      "output would silently equal the source")


def _kept_region_bit_exact(w: torch.Tensor, w0: torch.Tensor, mask: torch.Tensor) -> bool:
    keep = mask == 0
    return bool(torch.equal(w[keep], w0.to(w.dtype)[keep]))


def _save(args, mode: str, audio: np.ndarray, sr: int, seed: int, device, clock: StageClock,
          extra: dict) -> list:
    print(f"[generate] {clock.seconds['generate']:.3f} s for {clock.forwards['generate']} "
          f"denoiser forwards on {device}")
    if not np.all(np.isfinite(audio)):
        raise FloatingPointError("generation produced non-finite audio")
    os.makedirs(args.save_path, exist_ok=True)
    base = (args.text or "generation").replace(" ", "_")[:60]
    outs = []
    for i in range(audio.shape[0]):
        out = os.path.join(args.save_path, f"{base}_{timestamp_name()}_{i}.wav")
        write_wav(out, audio[i] if audio.ndim == 3 else audio[i: i + 1], sr)
        outs.append(out)
        print(f"[+] saved {out}")
    dump_run_summary(args.save_path, args, {
        "seed": seed, "mode": mode, "device": str(device),
        "generate_seconds": clock.seconds["generate"],
        "unet_steps": clock.forwards["generate"], **extra})
    return outs


def _main_stable_audio(args, mode: str, pipe, gen: torch.Generator, seed: int, device) -> list:
    """Text-to-audio, style transfer and inpainting on Stable Audio: x_T =
    sigma_max * n (or the source latent noised to sigmas[skip]), then the
    2nd-order SDE-DPM-Solver++ reverse loop."""
    n = args.n_candidate_gen_per_text
    S = pipe.sched.num_inference_steps
    max_s = pipe.audio_vae_length / pipe.sample_rate
    pipe.setup_duration(0.0, min(args.duration, max_s))

    if mode == "generation":
        w0 = torch.zeros((n, pipe.dit.config.in_channels, pipe.sample_size), device=device)
        skip = 0  # x_t = 0 + sigmas[0] * noise: pure sigma_max noise
    else:
        x0, _, dur = load_audio(args.file_path, pipe.mel_config, stft=False,
                                model_sr=pipe.get_sr())
        pipe.setup_duration(0.0, min(dur, max_s))
        w0 = pipe.vae_encode(torch.as_tensor(x0, device=device), gen).repeat(n, 1, 1)
        # skip == S is a loop of no step: strength 0 gives back the input
        # exactly (sigmas[S] == 0)
        skip = min(max(int(round(S * (1.0 - args.transfer_strength))), 0), S)

    clock = StageClock(device)
    eps_pair = clock.counted("generate", pipe.make_eps_pair(
        pipe.encode_text([""], negative=True), pipe.encode_text([args.text or ""])))

    def step_noise(n_skip: int) -> torch.Tensor:
        runs = S - n_skip
        if args.noise_sampler != "brownian" or runs == 0:
            return _randn(gen, (runs,) + tuple(w0.shape))
        from ..schedulers.brownian import brownian_noise_for_sigmas

        return torch.as_tensor(brownian_noise_for_sigmas(
            seed, pipe.sched.sched.sigmas_host[n_skip:], tuple(w0.shape)), device=device)

    extra = {}
    if mode == "inpaint":
        # regenerate the union of the masked regions; time windows in latent
        # frames (sample_rate / hop_length per second)
        mask = torch.zeros(w0.shape, device=device)
        any_flag = args.inpaint_window is not None or args.time_mask_ratio is not None
        if args.inpaint_window is not None:
            per_s = pipe.sample_rate / pipe.hop_length
            f0, f1 = (int(s * per_s) for s in args.inpaint_window)
            mask[:, :, f0:f1] = 1.0
        if args.time_mask_ratio is not None:
            t0, t1 = (int(r * w0.shape[2]) for r in args.time_mask_ratio)
            mask[:, :, t0:t1] = 1.0
        if not any_flag:
            mask[...] = 1.0  # no window given: regenerate everything
        elif not bool(mask.any()):
            raise _empty_window_error()
        noise = _randn(gen, w0.shape)
        keep_noise = _randn(gen, (S,) + tuple(w0.shape))
        zs = step_noise(0)
        with clock.stage("generate"):
            w = inpaint_latents_cosine(pipe.sched, eps_pair, w0, mask, noise, keep_noise, zs,
                                       args.guidance_scale)
        extra["kept_region_bit_exact"] = _kept_region_bit_exact(w, w0, mask)
    else:
        noise = _randn(gen, w0.shape)
        zs = step_noise(skip)
        with clock.stage("generate"):
            w = sdedit_loop_cosine(pipe.sched, eps_pair, w0, noise, zs, skip=skip,
                                   cfg_tar=args.guidance_scale)
    audio = pipe.decode_to_mel(pipe.vae_decode(w)).float().cpu().numpy()
    return _save(args, mode, audio, pipe.get_sr(), seed, device, clock, extra)


def _mel_mask(args, pipe, w0: torch.Tensor) -> torch.Tensor:
    """The union of the masked regions of the latent (1 = regenerate)."""
    mask = np.zeros(tuple(w0.shape), np.float32)
    lat_t, lat_f = w0.shape[2], w0.shape[3]
    any_flag = (args.inpaint_window is not None or args.time_mask_ratio is not None
                or args.freq_mask_ratio is not None)
    if args.inpaint_window is not None:
        f0, f1 = (int(s * MEL_FPS / pipe.vae_pad_multiple) for s in args.inpaint_window)
        mask[:, :, f0:f1, :] = 1.0
    if args.time_mask_ratio is not None:
        t0, t1 = (int(r * lat_t) for r in args.time_mask_ratio)
        mask[:, :, t0:t1, :] = 1.0
    if args.freq_mask_ratio is not None:
        b0, b1 = (int(r * lat_f) for r in args.freq_mask_ratio)
        mask[:, :, :, b0:b1] = 1.0
    if not any_flag:
        mask[...] = 1.0  # no window given: regenerate everything
    elif not mask.any():
        raise _empty_window_error()
    return torch.as_tensor(mask, device=w0.device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    mode = args.mode or ("transfer" if args.file_path else "generation")
    spec = resolve_spec(args.model_id)  # raises for model families not ported yet
    stable_audio = spec.family == "stable-audio"
    if stable_audio and mode == "sr":
        raise NotImplementedError(
            "sr regenerates mel-frequency bands; Stable Audio latents are waveform "
            "codes — use --mode inpaint with a time window")
    if mode != "generation" and (not args.file_path or not os.path.exists(args.file_path)):
        raise FileNotFoundError(f"--file_path: {args.file_path}")
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = load_model(args.model_id, args.ddim_steps, device=device, dtype=dtype, seed=seed,
                      weights_dir=args.weights_dir)
    if stable_audio:
        return _main_stable_audio(args, mode, pipe, gen, seed, device)

    n = args.n_candidate_gen_per_text
    S = args.ddim_steps
    # latent time length: duration * 102.4 mel frames / the VAE's 4
    frames = int(args.duration * MEL_FPS)
    lat_w = (spec.mel.n_mel_channels if spec.mel else 64) // pipe.vae_pad_multiple
    shape = (n, spec.unet.in_channels, max(frames // 4, 8), lat_w)

    w0 = None
    if mode != "generation":
        x0, _, _ = load_audio(args.file_path, pipe.mel_config, stft=True,
                              model_sr=pipe.get_sr(), device=device)
        w0 = pipe.vae_encode(torch.as_tensor(x0, device=device)).repeat(n, 1, 1, 1)
        shape = tuple(w0.shape)

    uncond = pipe.encode_text([""], negative=True)
    cond = pipe.encode_text([args.text]) if args.text else None
    cfg_t, _ = build_cfg_tensors((1,) + tuple(shape[1:]), [args.text or ""],
                                 [args.guidance_scale], zero_empty_prompts=(args.text == ""),
                                 device=device)
    clock = StageClock(device)
    den1 = clock.counted("generate", pipe.make_denoiser(uncond, cond,
                                                        cfg_t if cond is not None else None))

    def denoise(xt, k):  # the n candidates one at a time through the CFG denoiser
        return torch.cat([den1(xt[i: i + 1], k) for i in range(n)], dim=0)

    extra = {}
    if mode == "generation":
        noise, zs = _randn(gen, shape), _randn(gen, (S,) + shape)
        with clock.stage("generate"):
            w = text_to_audio_latents(pipe.sched, denoise, noise, zs, eta=args.ddim_eta)
    elif mode == "transfer":
        runs = S - transfer_skip(pipe.sched, args.transfer_strength)
        noise, zs = _randn(gen, shape), _randn(gen, (runs,) + shape)
        with clock.stage("generate"):
            w = style_transfer_latents(pipe.sched, denoise, w0, noise, zs,
                                       args.transfer_strength, eta=args.ddim_eta)
    else:  # inpaint / sr: regenerate the union of the masked regions
        if mode == "sr" and args.freq_mask_ratio is None:
            args.freq_mask_ratio = [0.75, 1.0]
        mask = _mel_mask(args, pipe, w0)
        noise = _randn(gen, shape)
        keep_noise, zs = _randn(gen, (S,) + shape), _randn(gen, (S,) + shape)
        with clock.stage("generate"):
            w = inpaint_latents(pipe.sched, denoise, w0, mask, noise, keep_noise, zs,
                                eta=args.ddim_eta)
        extra["kept_region_bit_exact"] = _kept_region_bit_exact(w, w0, mask)
    audio = pipe.decode_to_mel(pipe.vae_decode(w)).float().cpu().numpy()
    return _save(args, mode, audio, pipe.get_sr(), seed, device, clock, extra)


if __name__ == "__main__":
    main()
