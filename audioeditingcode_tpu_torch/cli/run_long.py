"""Long-form text-based editing on PyTorch: chunk -> window-batched edit ->
crossfade.

Counterpart of ``audioeditingcode_tpu/cli/run_long.py``, with the same
flags, defaults and results layout. Run it as ``python -m
audioeditingcode_tpu_torch.cli.run_long`` or ``aetorch-run-long``. It runs
on the CUDA card ``--device_num`` unless ``--device cpu`` is given; a
missing card is an error.

A recording of any length is split into overlapping windows; the
edit-friendly-inversion edit runs on every window at once, the windows
folded into each denoiser forward (``editing/batched.py``), and the decoded
windows are stitched with a linear crossfade (``editing/longform.py``).
Mel families chunk in mel frames (windows of a multiple of 4 frames);
Stable Audio chunks the waveform (each window is padded to the model's
fixed VAE length inside ``vae_encode``). Each window's inversion noise is
its own slice of one draw from a ``torch.Generator`` seeded with
``--seed``. ``run_args.json`` records the edit's seconds (``edit_seconds``,
synchronised host clock) and its denoiser forwards (``unet_steps``).

``--dp`` splits the windows over that many ranks (each makes every draw and
edits its block; ``editing/batched.py``), ``--tp`` shards the models'
output channels, ``--sp`` (Stable Audio) splits the DiT's token axis
(``parallel/launch.py`` starts the ranks; rank 0 writes the result).
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from ..editing.batched import edit_windows, make_window_denoiser
from ..editing.cfg import build_cfg_tensors
from ..editing.longform import overlap_add, split_windows, window_starts
from ..models.registry import load_model, resolve_spec
from ..ops.flash_attention import sp_mesh_scope
from ..parallel.launch import is_writer, requested_sp, run_on_ranks
from ..parallel.mesh import batch_sharding
from ..utils.audio_io import load_audio, write_wav
from ..utils.device import resolve_device
from .common import (
    StageClock,
    check_sp,
    dump_run_summary,
    maybe_shard_pipeline,
    set_reproducibility,
    timestamp_name,
)
from .run import MODEL_CHOICES

MEL_FPS = 102.4  # mel frames per second
SAMPLES_PER_FRAME = 160  # the HiFi-GAN vocoder's upsampling product


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Edit long audio in chunks")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("--model_id", type=str, choices=MODEL_CHOICES,
                   default="cvssp/audioldm2-music")
    p.add_argument("--init_aud", type=str, required=True)
    p.add_argument("--cfg_src", type=float, default=3.0)
    p.add_argument("--cfg_tar", type=float, default=12.0)
    p.add_argument("--num_diffusion_steps", type=int, default=200)
    p.add_argument("--target_prompt", type=str, required=True)
    p.add_argument("--source_prompt", type=str, default="")
    p.add_argument("--target_neg_prompt", type=str, default="")
    p.add_argument("--tstart", type=int, default=100)
    p.add_argument("--chunk_seconds", type=float, default=10.0)
    p.add_argument("--overlap_seconds", type=float, default=1.0)
    p.add_argument("--results_path", type=str, default="results_long")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1, help="shard the window axis over 'dp'")
    p.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel ways (Stable Audio only)")
    return p


def edit_batch(pipe, w0: torch.Tensor, noise: torch.Tensor, args, tstart: int,
               mesh=None) -> tuple:
    """The text edit of the N rows of ``w0`` (windows or clips) under one
    prompt pair, all rows in each denoiser forward; returns (the (N, ...)
    edited latents, the edit's seconds, its denoiser forwards). On a mesh
    the rows split over its dp axis (per-clip duration rows too) and the
    DiT's tokens over its sp axis."""
    dp = batch_sharding(mesh)
    if dp is not None and hasattr(pipe, "shard_clip_rows"):
        pipe.shard_clip_rows(dp.shard)
    shape = (1,) + tuple(w0.shape[1:])
    device = w0.device
    uncond = pipe.encode_text([args.target_neg_prompt], negative=True)
    empty = pipe.encode_text([""], negative=True)
    src = pipe.encode_text([args.source_prompt]) if args.source_prompt else None
    tgt = pipe.encode_text([args.target_prompt])
    cfg_src_t, _ = build_cfg_tensors(shape, [args.source_prompt], [args.cfg_src],
                                     zero_empty_prompts=True, device=device)
    cfg_tar_t, _ = build_cfg_tensors(shape, [args.target_prompt], [args.cfg_tar], device=device)
    clock = StageClock(device)
    fwd_den = clock.counted("edit", make_window_denoiser(
        pipe.make_eps_pair(empty, src), cfg_src_t if src is not None else None))
    rev_den = clock.counted("edit", make_window_denoiser(pipe.make_eps_pair(uncond, tgt),
                                                         cfg_tar_t))
    with clock.stage("edit"), sp_mesh_scope(mesh):
        w_edit = edit_windows(pipe.sched, fwd_den, rev_den, w0, noise, tstart,
                              eta=args.eta, numerical_fix=args.numerical_fix, dp=dp)
    seconds, forwards = clock.seconds["edit"], clock.forwards["edit"]
    rows = w0.shape[0] if dp is None else dp.block(w0.shape[0])
    print(f"[edit] {seconds:.3f} s for {forwards} denoiser forwards of {rows} "
          f"rows each on {device}")
    return w_edit, seconds, forwards


def _inversion_noise(gen: torch.Generator, steps: int, w0: torch.Tensor) -> torch.Tensor:
    """Each row's q(x_t | x_0) draw, (S, N, ...) in one draw."""
    return torch.randn((steps,) + tuple(w0.shape), generator=gen, device=w0.device)


def _save(args, stitched: np.ndarray, sr: int, tstart: int, record: dict) -> str:
    if not np.all(np.isfinite(stitched)):
        raise FloatingPointError("the edit produced non-finite audio")
    if not is_writer():
        return None
    save_path = os.path.join(args.results_path, args.model_id.split("/")[-1],
                             os.path.basename(args.init_aud).split(".")[0])
    os.makedirs(save_path, exist_ok=True)
    name = (f"long_cfg_e_{args.cfg_src}_cfg_d_{args.cfg_tar}"
            f"_tstart_{tstart}_chunk_{args.chunk_seconds}_{timestamp_name()}")
    out_path = os.path.join(save_path, name + ".wav")
    write_wav(out_path, stitched, sr)
    dump_run_summary(save_path, args, record)
    print(f"[+] saved {out_path} ({record['n_windows']} windows, "
          f"{record['duration']:.1f} s)")
    return out_path


def _main_stable_audio(args, pipe, gen, seed: int, device, mesh) -> str:
    """Waveform-domain overlapping windows, each edited by the same
    solver-history-threaded inversion as ``cli/run.py``'s Stable Audio
    path, decoded in one batch and stitched with a linear crossfade."""
    sr = pipe.sample_rate
    max_s = pipe.audio_vae_length / sr
    x0_full, _, duration = load_audio(args.init_aud, pipe.mel_config, stft=False, model_sr=sr)

    win = int(round(min(args.chunk_seconds, max_s) * sr))
    ov = min(int(round(args.overlap_seconds * sr)), win - 1)
    hop = win - ov
    T_samp = x0_full.shape[-1]
    starts = window_starts(T_samp, win, hop)
    if T_samp <= win:  # one (possibly short) window; vae_encode zero-pads
        wins = x0_full[None]
    else:  # window_starts pulls the last start back: every slice is exact
        wins = np.stack([x0_full[:, s: s + win] for s in starts], axis=0)
    n_win = wins.shape[0]

    # every window is padded to the fixed audio_vae_length inside
    # vae_encode; the decode crop is the window length
    pipe.setup_duration(0.0, min(win / sr, max_s))
    w0 = pipe.vae_encode(torch.as_tensor(wins, device=device), gen)  # (N, 64, L)
    tstart = min(args.tstart, args.num_diffusion_steps)
    noise = _inversion_noise(gen, args.num_diffusion_steps, w0)
    w_edit, edit_s, forwards = edit_batch(pipe, w0, noise, args, tstart, mesh)

    audio = pipe.vae_decode(w_edit).float().cpu().numpy()  # (N, 2, ~win)
    if audio.shape[-1] != win:
        # int(win / sr * sr) in the decode crop can lose a sample to float
        # round-trip; realign so that every window overlays at its start
        if audio.shape[-1] > win:
            audio = audio[..., :win]
        else:
            audio = np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, win - audio.shape[-1])])
    stitched = overlap_add(audio.astype(np.float32), starts, T_samp)
    return _save(args, stitched, sr, tstart, {
        "seed": seed, "duration": duration, "n_windows": n_win,
        "win_samples": win, "hop_samples": hop, "device": str(device),
        "edit_seconds": edit_s, "unet_steps": forwards,
        "mesh": None if mesh is None else mesh.shape})


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.eta = 1.0
    args.numerical_fix = True
    if not os.path.exists(args.init_aud):
        raise FileNotFoundError(f"--init_aud: no such file: {args.init_aud}")
    spec = resolve_spec(args.model_id)  # raises for model families not ported yet
    check_sp(requested_sp(args), spec.family == "stable-audio")
    return run_on_ranks(_run, args)


def _run(args):
    """The long-form edit on this rank (rank 0 writes the result and returns
    its path, the others None)."""
    spec = resolve_spec(args.model_id)
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = load_model(args.model_id, args.num_diffusion_steps, device=device, dtype=dtype,
                      seed=seed, weights_dir=args.weights_dir)
    if spec.family == "stable-audio":
        mesh = maybe_shard_pipeline(pipe, args.dp, args.tp, requested_sp(args))
        return _main_stable_audio(args, pipe, gen, seed, device, mesh)
    mesh = maybe_shard_pipeline(pipe, args.dp, args.tp)

    # window geometry in mel frames, multiples of the VAE pad (4)
    win = max(int(round(args.chunk_seconds * MEL_FPS / 4)) * 4, 8)
    ov = min(int(round(args.overlap_seconds * MEL_FPS / 4)) * 4, win - 4)
    hop = win - ov

    x0_full, sr, duration = load_audio(args.init_aud, pipe.mel_config, stft=True,
                                       model_sr=pipe.get_sr(), device=device)
    wins, starts = split_windows(np.asarray(x0_full), win, hop)
    n_win = wins.shape[0]
    w0 = pipe.vae_encode(torch.as_tensor(wins, device=device))  # (N, C, win/4, 16)
    tstart = min(args.tstart, args.num_diffusion_steps)
    noise = _inversion_noise(gen, args.num_diffusion_steps, w0)
    w_edit, edit_s, forwards = edit_batch(pipe, w0, noise, args, tstart, mesh)

    audio = pipe.decode_to_mel(pipe.vae_decode(w_edit)).float().cpu().numpy()
    if audio.ndim == 2:  # (N, Tw) -> (N, 1, Tw)
        audio = audio[:, None]
    starts_samples = [s * SAMPLES_PER_FRAME for s in starts]
    # the frontend computed int(duration * 102.4) mel frames; rounding the
    # duration here instead would append a zero-weight silent frame
    total = max(x0_full.shape[2], win) * SAMPLES_PER_FRAME
    stitched = overlap_add(audio.astype(np.float32), starts_samples, total)
    return _save(args, stitched, sr, tstart, {
        "seed": seed, "duration": duration, "n_windows": n_win,
        "win_frames": win, "hop_frames": hop, "device": str(device),
        "edit_seconds": edit_s, "unet_steps": forwards,
        "mesh": None if mesh is None else mesh.shape})


if __name__ == "__main__":
    main()
