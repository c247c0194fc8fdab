"""SDEdit baseline CLI on PyTorch.

Counterpart of ``audioeditingcode_tpu/cli/sdedit.py``, with the same flags,
results layout and file name (``s{seed}_skip{skip}_cfg{cfg}``). Run it as
``python -m audioeditingcode_tpu_torch.cli.sdedit`` or ``aetorch-sdedit``.
It runs on the CUDA card ``--device_num`` unless ``--device cpu`` is given;
a missing card is an error. The start noise and the per-step variance noise
are drawn from a ``torch.Generator`` seeded with ``--seed``; for Stable
Audio the per-step noise is by default the Brownian path's increments
(``--noise_sampler brownian``), drawn on the host. ``run_args.json`` records
the loop's seconds (``sdedit_seconds``, synchronised host clock), its
denoiser forwards (``unet_steps``) and the Brownian draw's host seconds
(``noise_seconds``).
"""

from __future__ import annotations

import argparse
import os
import time
import warnings

import numpy as np
import torch

from ..editing.sdedit import sdedit_loop, sdedit_loop_cosine
from ..models.registry import load_model, resolve_spec
from ..utils.audio_io import load_audio, write_wav
from ..utils.device import resolve_device
from .common import dump_run_summary, init_wandb, save_spectrogram_png, set_reproducibility
from .run import MODEL_CHOICES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run the SDEdit baseline.")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--model_id", type=str, choices=MODEL_CHOICES,
                   default="cvssp/audioldm2-music")
    p.add_argument("--init_aud", type=str, required=True)
    p.add_argument("--cfg_tar", type=float, default=12)
    p.add_argument("--num_diffusion_steps", type=int, default=200)
    p.add_argument("--target_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--target_neg_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--results_path", default="sdedit")
    p.add_argument("--tstart", type=int, default=100)
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_disable", action="store_true")
    p.add_argument("--noise_sampler", type=str, default="brownian",
                   choices=["brownian", "iid"],
                   help="Stable Audio only: the solver's variance noise, the "
                        "increments of one Brownian path (the upstream "
                        "sampler's BrownianTreeNoiseSampler) or i.i.d. draws")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.eta = 1.0
    if not os.path.exists(args.init_aud):
        raise FileNotFoundError(f"--init_aud: no such file: {args.init_aud}")
    spec = resolve_spec(args.model_id)  # raises for model families not ported yet
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)

    skip = args.num_diffusion_steps - args.tstart
    image_name = f"s{args.seed}_skip{skip}_cfg{args.cfg_tar}"
    wandb = init_wandb(args, "sdedit", image_name)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = load_model(args.model_id, args.num_diffusion_steps, device=device,
                      dtype=dtype, seed=seed, weights_dir=args.weights_dir)
    stable_audio = spec.family == "stable-audio"

    x0_np, sr, duration = load_audio(args.init_aud, pipe.mel_config, stft=not stable_audio,
                                     model_sr=pipe.get_sr(), device=device)
    x0 = torch.as_tensor(x0_np, device=device)
    if stable_audio:
        pipe.setup_duration(0.0, min(duration, pipe.audio_vae_length / pipe.sample_rate))
        w0 = pipe.vae_encode(x0, gen)
    else:
        w0 = pipe.vae_encode(x0)

    uncond = pipe.encode_text(args.target_neg_prompt, negative=True)
    tgt = pipe.encode_text(args.target_prompt)
    eps_pair = pipe.make_eps_pair(uncond, tgt)

    runs = args.num_diffusion_steps - skip
    noise = torch.randn(w0.shape, generator=gen, device=device, dtype=w0.dtype)
    noise_s = 0.0
    if stable_audio and args.noise_sampler == "brownian":
        from ..schedulers.brownian import brownian_noise_for_sigmas

        t0 = time.perf_counter()
        latents = torch.as_tensor(brownian_noise_for_sigmas(
            seed, pipe.sched.sched.sigmas_host[skip:], tuple(w0.shape)), device=device)
        noise_s = time.perf_counter() - t0
    else:
        latents = torch.randn((runs,) + tuple(w0.shape), generator=gen, device=device,
                              dtype=w0.dtype)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if stable_audio:
        xt = sdedit_loop_cosine(pipe.sched, eps_pair, w0, noise, latents, skip=skip,
                                cfg_tar=float(args.cfg_tar))
    else:
        xt = sdedit_loop(pipe.sched, eps_pair, w0, noise, latents, skip=skip,
                         cfg_tar=float(args.cfg_tar), eta=args.eta)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sdedit_s = time.perf_counter() - t0
    print(f"[sdedit] {sdedit_s:.3f} s for {runs} denoiser steps "
          f"({runs / sdedit_s:.2f} steps/s) on {device}"
          + (f"; Brownian noise {noise_s:.3f} s on the host" if noise_s else ""))

    x_dec = pipe.vae_decode(xt)
    audio = pipe.decode_to_mel(x_dec).float().cpu().numpy()
    orig_audio = pipe.decode_to_mel(x0).float().cpu().numpy()
    if not np.all(np.isfinite(audio)):
        raise FloatingPointError("SDEdit produced non-finite audio")

    save_path = os.path.join(
        args.results_path,
        args.model_id.split("/")[1] if "/" in args.model_id else args.model_id,
        os.path.basename(args.init_aud).split(".")[0],
        "pmt_" + "__".join(x.replace(" ", "_") for x in args.target_prompt)
        + "__neg__" + "__".join(x.replace(" ", "_") for x in args.target_neg_prompt),
    )
    os.makedirs(save_path, exist_ok=True)
    if audio.ndim == 3:  # the (2, T) stereo waveform of the one clip
        audio = audio[0]
    if orig_audio.ndim == 3:
        orig_audio = orig_audio[0]
    if not stable_audio:
        save_spectrogram_png(os.path.join(save_path, image_name + ".png"),
                             x_dec.float().cpu().numpy())
    write_wav(os.path.join(save_path, image_name + ".wav"), audio, sr)
    write_wav(os.path.join(save_path, "orig.wav"), orig_audio, sr)
    dump_run_summary(save_path, args, {
        "seed": seed, "duration": duration, "device": str(device),
        "sdedit_seconds": sdedit_s, "unet_steps": runs, "noise_seconds": noise_s,
    })
    print(f"[+] saved {os.path.join(save_path, image_name + '.wav')}")
    wandb.finish()
    return os.path.join(save_path, image_name + ".wav")


if __name__ == "__main__":
    main()
