"""Text-based audio editing CLI on PyTorch: ``--mode ours`` (edit-friendly
DDPM inversion) and ``--mode ddim`` (the plain DDIM-inversion baseline).

Counterpart of ``audioeditingcode_tpu/cli/run.py``, with the same flags and
results layout. Run it as ``python -m audioeditingcode_tpu_torch.cli.run``.
It runs on the CUDA card ``--device_num`` unless ``--device cpu`` is given;
a missing card is an error. ``--profile_dir DIR`` writes a torch.profiler
trace of the edit into DIR (``utils/profiling.py``).

``--dp``, ``--tp`` and ``--sp`` run the edit on that many ranks
(``parallel/launch.py``; rank r on card ``--device_num`` + r): tp shards
the models' output channels, sp (Stable Audio) splits the DiT's token
axis, and dp ranks run the same replicated edit of the one clip, as the
JAX CLI's GSPMD program does. Rank 0 writes the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import warnings

import numpy as np
import torch

from ..editing.cfg import build_cfg_tensors
from ..editing.ddim import ddim_generation_loop, ddim_inversion_loop
from ..editing.invert import inversion_forward_process, inversion_reverse_process
from ..models.registry import load_model, resolve_spec
from ..ops.flash_attention import sp_mesh_scope
from ..parallel.launch import is_writer, requested_sp, run_on_ranks
from ..utils.audio_io import load_audio, write_wav
from ..utils.device import resolve_device
from ..utils.profiling import PhaseTimer, trace
from .common import (
    check_sp,
    dump_run_summary,
    edit_image_name,
    edit_save_path,
    maybe_shard_pipeline,
    save_spectrogram_png,
    set_reproducibility,
)

MODEL_CHOICES = [
    "cvssp/audioldm-s-full-v2",
    "cvssp/audioldm-l-full",
    "cvssp/audioldm2",
    "cvssp/audioldm2-large",
    "cvssp/audioldm2-music",
    "declare-lab/tango-full-ft-audio-music-caps",
    "declare-lab/tango-full-ft-audiocaps",
    "stabilityai/stable-audio-open-1.0",
    "test/tiny-audioldm",
    "test/tiny-audioldm2",
    "test/tiny-stable-audio",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run text-based audio editing.")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--model_id", type=str, choices=MODEL_CHOICES,
                   default="cvssp/audioldm2-music")
    p.add_argument("--init_aud", type=str, required=True)
    p.add_argument("--cfg_src", type=float, nargs="+", default=[3])
    p.add_argument("--cfg_tar", type=float, nargs="+", default=[12])
    p.add_argument("--num_diffusion_steps", type=int, default=200)
    p.add_argument("--target_prompt", type=str, nargs="+", default=[""], required=True)
    p.add_argument("--source_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--target_neg_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--tstart", type=int, nargs="+", default=[100])
    p.add_argument("--results_path", type=str, default="results")
    p.add_argument("--cutoff_points", type=float, nargs="*", default=None)
    p.add_argument("--mode", default="ours", choices=["ours", "ddim"])
    p.add_argument("--fix_alpha", type=float, default=0.1)
    p.add_argument("--first_order", action="store_true", default=False,
                   help="Force the Stable Audio solver to first order")
    p.add_argument("--weights_dir", type=str, default=None,
                   help="Directory of converted weights")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    # accepted for flag compatibility; wandb logging is always off (the
    # reference's --wandb_disable defaults to True)
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_disable", action="store_true", default=True)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture a profiler trace of the edit into this dir")
    p.add_argument("--selfcheck", action="store_true", default=False,
                   help="reconstruction self-test: invert, then reverse with "
                        "the SOURCE prompt/cfg and report the latent "
                        "reconstruction SNR ('ours' mode: >= 40 dB)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ways")
    p.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel ways (Stable Audio only): split the DiT's "
                        "token axis; an explicit --sp 1 runs the sp route on one device")
    return p


def parse_args(argv=None):
    """Parse, then apply the reference's fixed post-parse args
    (eta=1, numerical_fix=True, test_rand_gen=False)."""
    args = build_parser().parse_args(argv)
    args.eta = 1.0
    args.numerical_fix = True
    args.test_rand_gen = False
    return args


def _reject_unported(args) -> None:
    spec = resolve_spec(args.model_id)  # raises for model families not ported yet
    check_sp(requested_sp(args), spec.family == "stable-audio")


def _check_ddim_args(args, skip, stable_audio: bool) -> None:
    """What --mode ddim takes (checked before a model loads): a
    DDIM-scheduler model, one cfg value each and single prompts; a partial
    inversion (skip != 0) is warned about."""
    if stable_audio:
        raise ValueError(
            "--mode ddim requires a DDIM-scheduler model; Stable Audio "
            "uses the cosine DPM solver (run --mode ours).")
    if len(args.cfg_src) > 1 or len(args.cfg_tar) > 1:
        raise ValueError("DDIM only supports one cfg scale value")
    if len(args.source_prompt) > 1 or len(args.target_prompt) > 1:
        raise ValueError("DDIM only supports single prompts")
    if (skip != 0).any():
        warnings.warn(
            "Plain DDIM Inversion should be run with t_start == "
            "num_diffusion_steps. You are now running partial DDIM inversion.",
            RuntimeWarning,
        )


def main(argv=None):
    args = parse_args(argv)
    if not os.path.exists(args.init_aud):
        raise FileNotFoundError(f"--init_aud: no such file: {args.init_aud}")
    _reject_unported(args)
    return run_on_ranks(_run, args)


def _run(args):
    """The edit on this rank (every rank of a parallel run runs it; rank 0
    writes the results and returns the wav's path, the others None)."""
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights "
                      "(smoke-test mode, outputs are not meaningful audio).")

    if len(args.tstart) != len(args.target_prompt):
        if len(args.tstart) == 1:
            args.tstart = args.tstart * len(args.target_prompt)
        else:
            raise ValueError("T-start amount and target prompt amount don't match.")
    tstart = np.asarray(args.tstart, dtype=np.int64)
    skip = args.num_diffusion_steps - tstart
    stable_audio = resolve_spec(args.model_id).family == "stable-audio"
    if args.mode == "ddim":
        _check_ddim_args(args, skip, stable_audio)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = load_model(args.model_id, args.num_diffusion_steps, device=device,
                      dtype=dtype, seed=seed, weights_dir=args.weights_dir)
    # an explicit --sp 1 on a mel family is a no-op: only the DiT has an sp path
    mesh = maybe_shard_pipeline(pipe, args.dp, args.tp,
                                requested_sp(args) if stable_audio else None)

    x0_np, sr, duration = load_audio(args.init_aud, pipe.mel_config, stft=not stable_audio,
                                     model_sr=pipe.get_sr(), device=device)
    x0 = torch.as_tensor(x0_np, device=device)
    if stable_audio:
        # duration conditioning and the decode crop window
        pipe.setup_duration(0.0, min(duration, pipe.audio_vae_length / pipe.sample_rate))
        if args.first_order:
            pipe.sched = dataclasses.replace(pipe.sched, first_order=True)
        w0 = pipe.vae_encode(x0, gen)
    else:
        w0 = pipe.vae_encode(x0)

    uncond = pipe.encode_text(args.target_neg_prompt, negative=True)
    has_src = len(args.source_prompt) > 1 or args.source_prompt[0] != ""
    src = pipe.encode_text(args.source_prompt) if has_src else None
    tgt = pipe.encode_text(args.target_prompt)
    empty = pipe.encode_text([""], negative=True)

    cfg_src_t, _ = build_cfg_tensors(w0.shape, args.source_prompt, list(args.cfg_src),
                                     cutoff_points=args.cutoff_points,
                                     zero_empty_prompts=True, device=device)
    cfg_tar_t, masks = build_cfg_tensors(w0.shape, args.target_prompt, list(args.cfg_tar),
                                         cutoff_points=args.cutoff_points, device=device)

    if args.mode == "ddim":
        # plain DDIM inversion, then eta-0 generation; both denoisers take
        # the empty prompt as the unconditional stream
        s = int(skip[0])
        n_steps = 2 * (args.num_diffusion_steps - s)  # denoiser forwards of the edit
        fwd_den = pipe.make_denoiser(empty, src, cfg_src_t)
        rev_den = fwd_den if args.selfcheck else pipe.make_denoiser(empty, tgt, cfg_tar_t)

        def edit():
            wT = ddim_inversion_loop(pipe.sched, fwd_den, w0, skip=s)
            # the selfcheck's reference is w0 itself: DDIM inversion is approximate
            return ddim_generation_loop(pipe.sched, rev_den, wT, skip=s), w0
    else:
        T = int(args.num_diffusion_steps - skip.min())
        n_steps = int(args.num_diffusion_steps + T)  # denoiser forwards of the edit
        multi = len(args.target_prompt) > 1
        fwd_den = pipe.make_denoiser(empty, src, cfg_src_t)
        rev_den = fwd_den if args.selfcheck else pipe.make_denoiser(uncond, tgt, cfg_tar_t)

        def edit():
            _, zs, xts, extras = inversion_forward_process(
                pipe.sched, fwd_den, w0, gen, eta=args.eta,
                numerical_fix=args.numerical_fix,
                # selfcheck measures the numerics, so it keeps zs[0]
                zero_first=not args.selfcheck, return_extras=True,
            )
            w_edit = inversion_reverse_process(
                pipe.sched, rev_den, xts, zs[:T], eta=args.eta,
                tstart=torch.as_tensor(tstart, device=device) if multi else None,
                fix_alpha=args.fix_alpha, masks=masks if multi else None,
                # the cosine solver's 2nd-order history, carried over from the
                # forward pass (None for DDIM, which has none)
                init_history=None if extras is None else extras[T - 1],
            )
            return w_edit, xts[0]

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timer = PhaseTimer()
    with trace(args.profile_dir), timer.phase("edit", steps=n_steps), sp_mesh_scope(mesh):
        w_edit, recon_ref = edit()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    timer.report()
    edit_s = timer.phases["edit"]["seconds"]
    print(f"[edit] {edit_s:.3f} s for {n_steps} denoiser steps "
          f"({n_steps / edit_s:.2f} steps/s) on {device}")

    x_dec = pipe.vae_decode(w_edit)
    audio = pipe.decode_to_mel(x_dec).float().cpu().numpy()
    orig_audio = pipe.decode_to_mel(x0).float().cpu().numpy()
    if not np.all(np.isfinite(audio)):
        raise FloatingPointError("the edit produced non-finite audio")

    selfcheck_snr = None
    if args.selfcheck:
        # the 'ours' inversion is exact by construction (zs are the recorded
        # residuals): reversing with the source conditioning must reproduce
        # the recorded trajectory start xts[0] up to float error (for the
        # cosine solver too: its final step ignores z, so exactness lands on
        # the recorded trajectory start). DDIM inversion is first-order
        # approximate: its SNR against w0 gets no verdict.
        ref = recon_ref.double().cpu().numpy()
        err = w_edit.double().cpu().numpy() - ref
        sig = float(np.mean(np.square(ref)))
        selfcheck_snr = float(10.0 * np.log10(sig / max(float(np.mean(np.square(err))), 1e-30)))
        verdict = (("PASS" if selfcheck_snr >= 40.0 else "WEAK") if args.mode == "ours"
                   else "ddim-approx")
        print(f"[selfcheck] latent reconstruction SNR: {selfcheck_snr:.1f} dB ({verdict})")
    if not is_writer():
        return None

    save_path = edit_save_path(args.results_path, args.model_id, args.init_aud,
                               args.source_prompt, args.target_prompt,
                               args.target_neg_prompt)
    os.makedirs(save_path, exist_ok=True)
    name = edit_image_name(args.mode, args.cfg_src, args.cfg_tar, skip,
                           args.num_diffusion_steps)
    if args.selfcheck:
        name = "selfcheck_" + name

    if stable_audio:
        audio = audio[0]  # the (2, T) stereo waveform of the one clip
    else:
        save_spectrogram_png(os.path.join(save_path, name + ".png"),
                             x_dec.float().cpu().numpy())
    write_wav(os.path.join(save_path, name + ".wav"), audio, sr)
    write_wav(os.path.join(save_path, "orig.wav"), orig_audio, sr)
    dump_run_summary(save_path, args, {
        "seed": seed, "duration": duration, "selfcheck_snr_db": selfcheck_snr,
        "device": str(device), "edit_seconds": edit_s, "unet_steps": n_steps,
        "mesh": None if mesh is None else mesh.shape,
    })
    print(f"[+] saved {os.path.join(save_path, name + '.wav')}")
    return os.path.join(save_path, name + ".wav")


if __name__ == "__main__":
    main()
