"""Batched multi-clip text-based editing on PyTorch.

Counterpart of ``audioeditingcode_tpu/cli/run_batch.py``, with the same
flags, defaults and per-clip results layout (``cli/run.py``'s
``edit_save_path``). Run it as ``python -m
audioeditingcode_tpu_torch.cli.run_batch`` or ``aetorch-run-batch``. It
runs on the CUDA card ``--device_num`` unless ``--device cpu`` is given; a
missing card is an error.

Every clip in a directory (or an explicit file list) is edited under one
prompt pair, all clips folded into each denoiser forward
(``editing/batched.py``), and decoded in one batch. Mel clips are
zero-padded to the batch's longest (a multiple of the VAE's 4 frames) and
each decode is cropped back to its clip's length, so the UNet sees the pad
region: a short clip's batched edit is close to, not bit-equal with, its
``cli/run.py`` edit. Stable Audio clips share the model's fixed VAE window,
and each carries its own duration conditioning
(``StableAudioPipeline.setup_clip_durations``). Each clip's inversion
noise is its own slice of one draw from a ``torch.Generator`` seeded with
``--seed``. Each clip's ``run_args.json`` records the batch's edit seconds
(``edit_seconds``, synchronised host clock), its denoiser forwards
(``unet_steps``) and the batch size (``n_clips``).

``--dp`` splits the clips over that many ranks (each makes every draw and
edits its block, with its clips' duration rows), ``--tp`` shards the
models' output channels, ``--sp`` (Stable Audio) splits the DiT's token
axis (``parallel/launch.py`` starts the ranks; rank 0 writes the results).
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings

import numpy as np
import torch

from ..models.registry import load_model, resolve_spec
from ..parallel.launch import is_writer, requested_sp, run_on_ranks
from ..utils.audio_io import load_audio, write_wav
from ..utils.device import resolve_device
from .common import (
    check_sp,
    dump_run_summary,
    edit_image_name,
    edit_save_path,
    maybe_shard_pipeline,
    save_spectrogram_png,
    set_reproducibility,
)
from .run import MODEL_CHOICES
from .run_long import SAMPLES_PER_FRAME, _inversion_noise, edit_batch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Edit a batch of clips in one program")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("--model_id", type=str, choices=MODEL_CHOICES,
                   default="cvssp/audioldm2-music")
    p.add_argument("--init_aud", type=str, nargs="+", required=True,
                   help="wav files, or a single directory of wavs")
    p.add_argument("--cfg_src", type=float, default=3.0)
    p.add_argument("--cfg_tar", type=float, default=12.0)
    p.add_argument("--num_diffusion_steps", type=int, default=200)
    p.add_argument("--target_prompt", type=str, required=True)
    p.add_argument("--source_prompt", type=str, default="")
    p.add_argument("--target_neg_prompt", type=str, default="")
    p.add_argument("--tstart", type=int, default=100)
    p.add_argument("--results_path", type=str, default="results")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1, help="shard the clip axis over 'dp'")
    p.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel ways (Stable Audio only)")
    return p


def _collect_files(paths):
    if len(paths) == 1 and os.path.isdir(paths[0]):
        files = sorted(glob.glob(os.path.join(paths[0], "*.wav")))
        if not files:
            raise FileNotFoundError(f"no .wav files in {paths[0]}")
    else:
        for f in paths:
            if not os.path.exists(f):
                raise FileNotFoundError(f"--init_aud: no such file: {f}")
        files = list(paths)
    # results land under basename(clip).split('.')[0], as edit_save_path
    # names them: two clips with one such name would overwrite each other
    seen = {}
    for f in files:
        base = os.path.basename(f).split(".")[0]
        if base in seen:
            raise ValueError(f"clips {seen[base]!r} and {f!r} share the results basename "
                             f"{base!r}; rename one (outputs would overwrite)")
        seen[base] = f
    return files


def _fit_len(wav: np.ndarray, n: int) -> np.ndarray:
    """Crop or zero-pad the trailing sample axis to exactly n samples."""
    if wav.shape[-1] >= n:
        return wav[..., :n]
    pad = [(0, 0)] * (wav.ndim - 1) + [(0, n - wav.shape[-1])]
    return np.pad(wav, pad)


def _save_clip(args, clip_path, audio, x_dec, orig_audio, sr, stable_audio, skip,
               record: dict) -> str:
    """One clip's outputs in ``cli/run.py``'s per-clip results layout."""
    save_path = edit_save_path(args.results_path, args.model_id, clip_path,
                               [args.source_prompt], [args.target_prompt],
                               [args.target_neg_prompt])
    os.makedirs(save_path, exist_ok=True)
    name = edit_image_name("ours", [args.cfg_src], [args.cfg_tar], skip,
                           args.num_diffusion_steps)
    if not stable_audio:
        save_spectrogram_png(os.path.join(save_path, name + ".png"), x_dec)
    write_wav(os.path.join(save_path, name + ".wav"), audio, sr)
    write_wav(os.path.join(save_path, "orig.wav"), orig_audio, sr)
    dump_run_summary(save_path, args, {**record, "batched": True})
    return os.path.join(save_path, name + ".wav")


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.eta = 1.0
    args.numerical_fix = True

    files = _collect_files(args.init_aud)
    spec = resolve_spec(args.model_id)  # raises for model families not ported yet
    check_sp(requested_sp(args), spec.family == "stable-audio")
    return run_on_ranks(_run, args)


def _run(args):
    """The batch edit on this rank (rank 0 writes the results and returns
    their paths, the others None)."""
    files = _collect_files(args.init_aud)
    n_clip = len(files)
    spec = resolve_spec(args.model_id)
    stable_audio = spec.family == "stable-audio"
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    tstart = min(args.tstart, args.num_diffusion_steps)
    skip = args.num_diffusion_steps - tstart

    if stable_audio:
        clips, durations = [], []
        for f in files:
            wav, _, dur = load_audio(f, None, stft=False, model_sr=spec.sample_rate)
            clips.append(wav)
            durations.append(dur)
        if len({c.shape[0] for c in clips}) > 1:
            raise ValueError("batch clips must share a channel count; got "
                             + ", ".join(f"{f}: {c.shape[0]}ch" for f, c in zip(files, clips)))
        pipe = load_model(args.model_id, args.num_diffusion_steps, device=device, dtype=dtype,
                          seed=seed, weights_dir=args.weights_dir)
        mesh = maybe_shard_pipeline(pipe, args.dp, args.tp, requested_sp(args))
        sr = pipe.sample_rate
        max_s = pipe.audio_vae_length / sr
        # duration conditioning per clip, as each clip's cli/run.py edit has
        # it; the decode crop covers the longest clip, cropped per clip below
        pipe.setup_clip_durations([min(d, max_s) for d in durations])
        T_pad = max(c.shape[-1] for c in clips)
        x0 = np.zeros((n_clip, clips[0].shape[0], T_pad), np.float32)
        for i, c in enumerate(clips):
            x0[i, :, : c.shape[-1]] = c
        x0 = torch.as_tensor(x0, device=device)
        w0 = pipe.vae_encode(x0, gen)  # (N, 64, L)
    else:
        mels, durations = [], []
        for f in files:
            mel, _, dur = load_audio(f, spec.mel, stft=True, model_sr=None, device=device)
            mels.append(mel)  # (1, 1, T_i, M)
            durations.append(dur)
        frames = [m.shape[2] for m in mels]
        T_pad = max(-(-max(frames) // 4) * 4, 8)
        x0 = np.zeros((n_clip, 1, T_pad, mels[0].shape[3]), np.float32)
        for i, m in enumerate(mels):
            x0[i, :, : m.shape[2]] = m[0]
        pipe = load_model(args.model_id, args.num_diffusion_steps, device=device, dtype=dtype,
                          seed=seed, weights_dir=args.weights_dir)
        mesh = maybe_shard_pipeline(pipe, args.dp, args.tp)
        sr = pipe.get_sr()
        x0 = torch.as_tensor(x0, device=device)
        w0 = pipe.vae_encode(x0)  # (N, C, T/4, M/4)

    noise = _inversion_noise(gen, args.num_diffusion_steps, w0)
    w_edit, edit_s, forwards = edit_batch(pipe, w0, noise, args, tstart, mesh)
    x_dec = pipe.vae_decode(w_edit)
    audio = pipe.decode_to_mel(x_dec).float().cpu().numpy()
    x_dec = x_dec.float().cpu().numpy()
    if not np.all(np.isfinite(audio)):
        raise FloatingPointError("the edit produced non-finite audio")
    # orig.wav vocodes the original input, as cli/run.py's does
    orig_audio = pipe.decode_to_mel(x0).float().cpu().numpy()
    if not is_writer():
        return None

    outputs = []
    for i, f in enumerate(files):
        if stable_audio:
            n = clips[i].shape[-1]
            a, oa, xd = _fit_len(audio[i], n), _fit_len(orig_audio[i], n), None
        else:
            n = frames[i] * SAMPLES_PER_FRAME
            a = _fit_len(audio[i].reshape(1, -1), n)
            oa = _fit_len(orig_audio[i].reshape(1, -1), n)
            xd = x_dec[i][None, :, : frames[i]]  # (1, 1, T_i, M) for the PNG
        outputs.append(_save_clip(args, f, a, xd, oa, sr, stable_audio, skip, {
            "seed": seed, "duration": durations[i], "device": str(device),
            "edit_seconds": edit_s, "unet_steps": forwards, "n_clips": n_clip,
            "mesh": None if mesh is None else mesh.shape}))
    print(f"[+] batch-edited {n_clip} clips -> {args.results_path}")
    return outputs


if __name__ == "__main__":
    main()
