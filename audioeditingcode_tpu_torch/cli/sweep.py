"""Evaluation-sweep CLI on PyTorch: one inversion, many (tstart, cfg_tar)
edits.

Counterpart of ``audioeditingcode_tpu/cli/sweep.py``, with the same flags,
defaults and results layout. Run it as ``python -m
audioeditingcode_tpu_torch.cli.sweep`` or ``aetorch-sweep``. It runs on the
CUDA card ``--device_num`` unless ``--device cpu`` is given; a missing card
is an error.

The inversion depends only on the clip, the source prompt and cfg_src, so
it runs once; every grid point reuses its noise maps ``zs[:tstart]`` and
trajectory, and for Stable Audio ``extras[tstart - 1]`` as the solver's
warm start. Cost: S + sum_i tstart_i denoiser forwards, against
sum_i (S + tstart_i) for one ``cli/run.py`` edit per grid point. The
draws follow ``cli/run.py``'s (Stable Audio's latent sample, then the
inversion noise, from one ``torch.Generator`` seeded with ``--seed``), so
each grid point equals ``cli/run.py --mode ours`` at that tstart and
cfg_tar with the same seed. Results land under ``edit_save_path`` as
``edit_image_name("ours", ...)``; ``run_args.json`` records the
inversion's and each reverse pass's seconds (synchronised host clock) and
denoiser forwards.

``--tp`` shards the models' output channels over that many ranks; ``--dp``
ranks run the same replicated sweep, as the JAX CLI's program does
(``parallel/launch.py`` starts the ranks; rank 0 writes the results).
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from ..editing.cfg import build_cfg_tensors
from ..editing.invert import inversion_forward_process, inversion_reverse_process
from ..models.registry import load_model, resolve_spec
from ..parallel.launch import is_writer, run_on_ranks
from ..utils.audio_io import load_audio, write_wav
from ..utils.device import resolve_device
from .common import (
    StageClock,
    dump_run_summary,
    edit_image_name,
    edit_save_path,
    maybe_shard_pipeline,
    save_spectrogram_png,
    set_reproducibility,
)
from .run import MODEL_CHOICES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sweep tstart x cfg_tar over one inversion")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("--model_id", type=str, choices=MODEL_CHOICES,
                   default="cvssp/audioldm2-music")
    p.add_argument("--init_aud", type=str, required=True)
    p.add_argument("--cfg_src", type=float, default=3.0)
    p.add_argument("--cfg_tars", type=float, nargs="+", default=[12.0])
    p.add_argument("--tstarts", type=int, nargs="+",
                   default=[100, 110, 120, 130, 140, 150, 160],
                   help="the reference grid: skip = T - tstart")
    p.add_argument("--num_diffusion_steps", type=int, default=200)
    p.add_argument("--target_prompt", type=str, required=True)
    p.add_argument("--source_prompt", type=str, default="")
    p.add_argument("--target_neg_prompt", type=str, default="")
    p.add_argument("--results_path", type=str, default="results")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.eta = 1.0
    args.numerical_fix = True
    if not os.path.exists(args.init_aud):
        raise FileNotFoundError(f"--init_aud: no such file: {args.init_aud}")
    resolve_spec(args.model_id)  # raises for model families not ported yet
    return run_on_ranks(_run, args)


def _run(args):
    """The sweep on this rank (rank 0 writes the results and returns their
    paths, the others None)."""
    spec = resolve_spec(args.model_id)
    writer = is_writer()
    stable_audio = spec.family == "stable-audio"
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")

    S = args.num_diffusion_steps
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = load_model(args.model_id, S, device=device, dtype=dtype, seed=seed,
                      weights_dir=args.weights_dir)
    maybe_shard_pipeline(pipe, args.dp, args.tp)
    x0_np, sr, duration = load_audio(args.init_aud, pipe.mel_config, stft=not stable_audio,
                                     model_sr=pipe.get_sr(), device=device)
    x0 = torch.as_tensor(x0_np, device=device)
    if stable_audio:
        # duration conditioning and decode crop, as cli/run.py's
        pipe.setup_duration(0.0, min(duration, pipe.audio_vae_length / pipe.sample_rate))
        w0 = pipe.vae_encode(x0, gen)
    else:
        w0 = pipe.vae_encode(x0)

    empty = pipe.encode_text([""], negative=True)
    uncond = pipe.encode_text([args.target_neg_prompt], negative=True)
    src = pipe.encode_text([args.source_prompt]) if args.source_prompt else None
    tgt = pipe.encode_text([args.target_prompt])
    cfg_src_t, _ = build_cfg_tensors(w0.shape, [args.source_prompt], [args.cfg_src],
                                     zero_empty_prompts=True, device=device)
    clock = StageClock(device)

    # one inversion for the whole grid
    with clock.stage("inversion"):
        den = clock.counted("inversion", pipe.make_denoiser(empty, src, cfg_src_t))
        _, zs, xts, extras = inversion_forward_process(
            pipe.sched, den, w0, gen, eta=args.eta, numerical_fix=args.numerical_fix,
            return_extras=True)

    save_path = edit_save_path(args.results_path, args.model_id, args.init_aud,
                               [args.source_prompt], [args.target_prompt],
                               [args.target_neg_prompt])
    orig = pipe.decode_to_mel(x0).float().cpu().numpy()
    if writer:
        os.makedirs(save_path, exist_ok=True)
        write_wav(os.path.join(save_path, "orig.wav"), orig[0] if orig.ndim == 3 else orig, sr)

    outs = []
    for tstart in args.tstarts:
        t = min(int(tstart), S)
        for cfg_tar in args.cfg_tars:
            stage = f"reverse_t{t}_cfg{cfg_tar}"
            cfg_t = torch.ones((1,) + tuple(w0.shape[1:]), device=device) * cfg_tar
            with clock.stage(stage):
                den = clock.counted(stage, pipe.make_denoiser(uncond, tgt, cfg_t))
                w_edit = inversion_reverse_process(
                    pipe.sched, den, xts, zs[:t], eta=args.eta,
                    init_history=None if extras is None else extras[t - 1])
            x_dec = pipe.vae_decode(w_edit)
            audio = pipe.decode_to_mel(x_dec).float().cpu().numpy()
            if not np.all(np.isfinite(audio)):
                raise FloatingPointError("the edit produced non-finite audio")
            name = edit_image_name("ours", [args.cfg_src], [cfg_tar], S - t, S)
            out = os.path.join(save_path, name + ".wav")
            if not writer:
                continue
            write_wav(out, audio[0] if audio.ndim == 3 else audio, sr)
            if not stable_audio:
                save_spectrogram_png(os.path.join(save_path, name + ".png"),
                                     x_dec.float().cpu().numpy())
            outs.append(out)
            print(f"[+] tstart={t} cfg_tar={cfg_tar}: {out}")
    if not writer:
        return None
    dump_run_summary(save_path, args, {
        "seed": seed, "n_edits": len(outs), "device": str(device),
        "edit_seconds": sum(clock.seconds.values()),
        "unet_steps": sum(clock.forwards.values()), **clock.record()})
    return outs


if __name__ == "__main__":
    main()
