"""Unsupervised PC-extraction CLI on PyTorch.

Counterpart of ``audioeditingcode_tpu/cli/pc_extract.py``, with the same
flags, results layout and npz checkpoint. Run it as
``python -m audioeditingcode_tpu_torch.cli.pc_extract``; it runs on the CUDA
card ``--device_num`` unless ``--device cpu`` is given, and a missing card
is an error.

Stages: edit-friendly inversion; the drift-free trajectory, which keeps each
step's input, x0 prediction and incoming solver state; then, at each step of
the ``--drift_start`` / ``--drift_end`` window, power iteration for the top
``--n_evs`` posterior PCs, the ev batch fused into the denoiser batch.
Checkpoints land after the trajectory and after every ``--ts_chunk`` window
steps. Each stage's seconds and denoiser forwards go into run_args.json.

``--dp`` splits the power iteration over that many ranks, as the JAX CLI
shards it: the ev batch of each window step at ``--ts_chunk 1``, the window
steps of each chunk above it (every rank makes each step's draw, in window
order; the results are gathered in step order). ``--tp`` shards the
models' output channels (``parallel/launch.py`` starts the ranks; rank 0
writes the checkpoint and the results).
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..editing.cfg import build_cfg_tensors
from ..editing.invert import inversion_forward_process
from ..editing.pc_drift import (
    EigResult,
    PCStreamChoice,
    forward_directional,
    get_eigenvectors,
    snapshot_iterations,
)
from ..editing.pcdata import load_extraction, save_extraction, step_timestep_key
from ..editing.solvers import as_solver
from ..models.registry import load_model, resolve_spec
from ..parallel.launch import is_writer, run_on_ranks
from ..parallel.mesh import batch_sharding
from ..models.text_encoders import repeat_cond
from ..utils.audio_io import load_audio, write_wav
from ..utils.device import resolve_device
from .common import (
    StageClock,
    dump_run_summary,
    init_wandb,
    log_edit_artifacts,
    log_pc_corrs,
    maybe_shard_pipeline,
    plot_corrs,
    save_spectrogram_png,
    set_reproducibility,
    timestamp_name,
)
from .run import MODEL_CHOICES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract PCs for a real audio signal")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--cfg_tar", type=float, nargs="+", default=[3])
    p.add_argument("--model_id", type=str, choices=MODEL_CHOICES,
                   default="cvssp/audioldm2-music")
    p.add_argument("--init_aud", type=str, required=True)
    p.add_argument("--num_diffusion_steps", type=int, default=200)
    p.add_argument("--source_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--target_neg_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--corr_to_swap", type=float, default=0.8)
    p.add_argument("--drift_start", type=int, default=None)
    p.add_argument("--drift_end", type=int, default=None)
    p.add_argument("--results_path", default="pc_extractions")
    p.add_argument("-c", "--const", type=float, default=1e-3)
    p.add_argument("--n_evs", type=int, default=1)
    p.add_argument("-p", "--patch", nargs=2, default=None, type=int)
    p.add_argument("-t", "--iters", type=int, default=50)
    p.add_argument("-d", "--dry", action="store_true")
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_disable", action="store_true")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    p.add_argument("--dp", type=int, default=1,
                   help="shard the n_evs power-iteration batch over 'dp'")
    p.add_argument("--ts_chunk", type=int, default=1,
                   help="window steps per checkpoint; each step's power "
                        "iteration is independent given the trajectory, and "
                        "the results equal --ts_chunk 1")
    return p


def parse_args(argv=None):
    """Parse, then apply the fixed post-parse args (pc_mode='both', eta=1,
    numerical_fix=True, double_precision=False, test_rand_gen=False)."""
    args = build_parser().parse_args(argv)
    args.pc_mode = "both"
    args.eta = 1.0
    args.numerical_fix = True
    args.double_precision = False
    args.test_rand_gen = False
    return args


def main(argv=None):
    args = parse_args(argv)
    if not os.path.exists(args.init_aud):
        raise FileNotFoundError(f"--init_aud: no such file: {args.init_aud}")
    resolve_spec(args.model_id)  # raises for model families not ported yet
    return run_on_ranks(_run, args)


def _run(args):
    """The extraction on this rank (rank 0 writes the checkpoint and the
    results and returns the checkpoint's path, the others None)."""
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg_tar = float(np.atleast_1d(args.cfg_tar)[0])

    image_name = (
        f"s{args.seed}_"
        + (f"p{args.patch[0]}-{args.patch[1]}_" if args.patch is not None else "")
        + f"pc-{args.pc_mode}_cfgd{args.cfg_tar}_"
        + f"drift{args.drift_start}-{args.drift_end}_it{args.iters}_c{args.const:.1e}"
        + f"_{timestamp_name()}"
    )
    wandb = init_wandb(args, "pc_extraction_inv", image_name)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")

    if args.dtype == "bfloat16":
        # power iteration probes the denoiser Jacobian by finite differences
        # at const 1e-3: the per-element perturbation sits far below
        # bfloat16's 8-bit mantissa, so the probe difference collapses to
        # zero norm and renormalising it gives NaN eigenvectors
        warnings.warn("--dtype bfloat16 is numerically unsound for "
                      "finite-difference PC extraction (probe below bf16 "
                      "quantization); overriding to float32.")
        args.dtype = "float32"
    pipe = load_model(args.model_id, args.num_diffusion_steps, device=device,
                      dtype=torch.float32, seed=seed, weights_dir=args.weights_dir)
    mesh = maybe_shard_pipeline(pipe, args.dp, args.tp)
    stable_audio = resolve_spec(args.model_id).family == "stable-audio"
    S = args.num_diffusion_steps
    if args.drift_start is None:
        args.drift_start = S
    if args.drift_end is None:
        args.drift_end = -1

    x0_np, sr, duration = load_audio(args.init_aud, pipe.mel_config, stft=not stable_audio,
                                     model_sr=pipe.get_sr(), device=device)
    x0 = torch.as_tensor(x0_np, device=device)
    if stable_audio:
        # duration conditioning and the decode crop window; the checkpoint
        # records the duration, so that pc_apply conditions on it too
        args.duration = min(duration, pipe.audio_vae_length / pipe.sample_rate)
        pipe.setup_duration(0.0, args.duration)
        w0 = pipe.vae_encode(x0, gen)
    else:
        w0 = pipe.vae_encode(x0)

    save_path = os.path.join(
        args.results_path,
        args.model_id.split("/")[1] if "/" in args.model_id else args.model_id,
        os.path.basename(args.init_aud).split(".")[0],
        "pmt_" + "__".join(x.replace(" ", "_") for x in args.source_prompt)
        + "__neg__" + "__".join(x.replace(" ", "_") for x in args.target_neg_prompt),
    )
    writer = is_writer()
    if writer:
        os.makedirs(save_path, exist_ok=True)

    clock = StageClock(device)
    ckpt_path, xt = run_pc_extraction(args, pipe, w0, gen, cfg_tar, save_path, image_name,
                                      seed, clock=clock, mesh=mesh)
    # the final decode of the drift-free trajectory's end (every rank: the
    # decoders may be tp-sharded)
    x_dec = pipe.vae_decode(xt)
    audio = pipe.decode_to_mel(x_dec).float().cpu().numpy()
    orig_audio = pipe.decode_to_mel(x0).float().cpu().numpy()
    if not writer:
        return None

    loaded = load_extraction(ckpt_path[: -len(".npz")])
    plot_corrs(loaded["corrs"], loaded["in_corrs"], args.n_evs, save_path=save_path)
    eigdata = loaded["eigdata"]
    log_pc_corrs(wandb, loaded["corrs"], loaded["in_corrs"],
                 [eigdata[t]["eigval"] for t in sorted(eigdata)], args.n_evs)

    if audio.ndim == 3:  # Stable Audio waveform (B, C, T)
        audio = audio[0]
    if orig_audio.ndim == 3:
        orig_audio = orig_audio[0]
    if not np.all(np.isfinite(audio)):
        raise FloatingPointError("the extraction's trajectory decoded to non-finite audio")
    if not stable_audio:
        save_spectrogram_png(os.path.join(save_path, image_name + ".png"),
                             x_dec.float().cpu().numpy())
    write_wav(os.path.join(save_path, image_name + ".wav"), audio, sr)
    write_wav(os.path.join(save_path, "orig.wav"), orig_audio, sr)
    window = len(loaded["eig_ts"])
    power_s = clock.seconds.get("power_iteration", 0.0)
    dump_run_summary(save_path, args, {
        "seed": seed, "duration": duration, "device": str(device), **clock.record(),
        "window_steps": window,
        "power_iteration_seconds_per_window_step": power_s / window if window else None,
        "mesh": None if mesh is None else mesh.shape,
    })
    log_edit_artifacts(
        wandb, image_name, sr,
        orig_audio=np.squeeze(orig_audio).T if orig_audio.ndim > 1 else orig_audio,
        gen_audio=np.squeeze(audio).T if audio.ndim > 1 else audio,
        gen_spec=None if stable_audio else np.squeeze(x_dec.float().cpu().numpy()),
    )
    print(f"[+] extraction saved to {ckpt_path}")
    wandb.finish()
    return ckpt_path


def patch_mask(shape, patch, fade: int = 0) -> np.ndarray:
    """1 inside the ``--patch`` window of the time axis (axis 2 of the mel
    latent (1, C, T, F) and of the 1-D latent (1, C, L)), with a linear ramp
    of ``fade`` frames on each side; an image CLI's four-value patch (top,
    bottom, left, right of the latent) has no ramp; all ones without a
    patch."""
    mask = np.zeros(shape, dtype=np.float32)
    if patch is None:
        mask[...] = 1
    elif len(patch) == 4:
        mask[:, :, patch[0]: patch[1], patch[2]: patch[3]] = 1
    else:
        mask[:, :, patch[0]: patch[1]] = 1
        if fade > 0:
            ramp = np.linspace(0, 1, fade, dtype=np.float32).reshape(
                (1, 1, fade) + (1,) * (mask.ndim - 3))
            mask[:, :, patch[0] - fade: patch[0]] = ramp
            mask[:, :, patch[1]: patch[1] + fade] = ramp[:, :, ::-1]
    return mask


@torch.no_grad()
def run_pc_extraction(args, pipe, w0: torch.Tensor,
                      gen: Optional[torch.Generator], cfg_tar: float, save_path: str,
                      image_name: str, seed: int,
                      inv_noise: Union[torch.Tensor, torch.Generator, None] = None,
                      v0s: Optional[Sequence[torch.Tensor]] = None,
                      clock: Optional[StageClock] = None, mesh=None):
    """Edit-friendly inversion, the drift-free trajectory, power iteration at
    each window step, incremental npz checkpoints. Returns (ckpt_path, the
    trajectory's final latent).

    The draws: ``inv_noise`` is the inversion's (S, *w0.shape) draw (default:
    drawn from ``gen``), ``v0s`` one (n_evs, ...) standard-normal draw per
    window step, in window order (default: each drawn from ``gen`` in
    turn). On a mesh with a dp axis the power iteration splits over it: the
    ev batch at ``--ts_chunk`` 1, each chunk's window steps above it; only
    the writing rank writes the checkpoint."""
    S = args.num_diffusion_steps
    drift_start_it = S - args.drift_start
    drift_end_it = S - args.drift_end
    device = w0.device
    clock = clock or StageClock(device)

    uncond = pipe.encode_text(args.target_neg_prompt, negative=True)
    has_src = len(args.source_prompt) > 1 or args.source_prompt[0] != ""
    src = pipe.encode_text(args.source_prompt) if has_src else None
    text = pipe.encode_text(args.source_prompt)
    empty = pipe.encode_text([""], negative=True)

    cfg_t, _ = build_cfg_tensors(w0.shape, args.source_prompt, [cfg_tar],
                                 zero_empty_prompts=True, device=device)
    with clock.stage("inversion"):
        fwd_den = clock.counted("inversion", pipe.make_denoiser(empty, src, cfg_t))
        _, zs, wts = inversion_forward_process(
            pipe.sched, fwd_den, w0, gen if inv_noise is None else inv_noise,
            eta=args.eta, numerical_fix=args.numerical_fix)
    # latents[0] = x_T; latents[it + 1] = the noise map of step it
    latents = torch.cat([wts[S: S + 1], torch.flip(zs, dims=(0,))], dim=0)
    mask = torch.as_tensor(patch_mask(tuple(w0.shape), args.patch), device=device)

    n_ev = args.n_evs
    solver = as_solver(pipe.sched, eta=args.eta)
    timesteps = getattr(pipe.sched, "sched", pipe.sched).timesteps.cpu().numpy()
    ckpt_path = os.path.join(save_path, image_name + ".npz")
    snaps = snapshot_iterations(args.iters)
    prev_pc = None
    eig_ts, eig_its = [], []
    eig_vecs, eig_vals, interm_vecs, interm_vals, norm_factors = [], [], [], [], []
    corrs, in_corrs, in_norms = [], [], []

    def stacked(xs):
        return np.asarray(xs) if xs else np.zeros((0,))

    dp = batch_sharding(mesh)
    ts_chunk = max(1, int(getattr(args, "ts_chunk", 1)))
    ev_dp = dp if ts_chunk == 1 else None  # JAX dp_on_ev
    step_dp = dp if ts_chunk > 1 else None

    def save():
        if not is_writer():
            return
        save_extraction(
            ckpt_path, vars(args) | {"seed": seed, "cfg_tar_scalar": cfg_tar},
            eig_ts, eig_its, stacked(eig_vecs), stacked(eig_vals), stacked(interm_vecs),
            stacked(interm_vals), list(snaps), stacked(norm_factors), stacked(corrs),
            stacked(in_corrs), stacked(in_norms), latents.float().cpu().numpy(),
            np.stack(xts_list))

    # the drift-free trajectory: each step's input, x0 prediction and
    # incoming solver state (the power iterations start from these)
    eps_pair = clock.counted("trajectory", pipe.make_eps_pair(uncond, text))
    xts, x0_preds, states = [latents[0]], [], []
    with clock.stage("trajectory"):
        xt, state = latents[0], solver.init_state(latents[0])
        for it in range(S):
            states.append(state)
            xt, x0_pred, state = forward_directional(
                solver, eps_pair, xt, it, latents[it + 1], cfg_tar, eta=args.eta,
                state=state, return_state=True)
            xts.append(xt)
            x0_preds.append(x0_pred)
    xts_list = [x.float().cpu().numpy() for x in xts]
    save()  # the trajectory's checkpoint, before the expensive stage

    window = [] if args.dry else [it for it in range(S) if drift_start_it <= it < drift_end_it]
    if v0s is not None and len(v0s) != len(window):
        raise ValueError(f"{len(v0s)} v0 draws for {len(window)} window steps")
    ev_rows = n_ev if ev_dp is None else ev_dp.block(n_ev)
    uncond_ev, text_ev = repeat_cond(uncond, ev_rows), repeat_cond(text, ev_rows)
    eps_pair_ev = clock.counted("power_iteration", pipe.make_eps_pair(uncond_ev, text_ev))

    def widen(x):
        return x.repeat_interleave(n_ev, dim=0)

    def record(it, res):
        nonlocal prev_pc
        vecs = res.eigvecs.float().cpu().numpy()
        if it > drift_start_it and prev_pc is not None:
            corr = np.sum(prev_pc.reshape(n_ev, -1) * vecs.reshape(n_ev, -1), axis=1)
            for ev in range(n_ev):
                if corr[ev] <= -args.corr_to_swap:
                    vecs[ev] *= -1
                    corr[ev] *= -1
                    print(f"swapped eigvec {ev + 1}!")
            corrs.append(corr)
        prev_pc = vecs
        eig_ts.append(step_timestep_key(timesteps, it))
        eig_its.append(it)
        eig_vecs.append(vecs)
        eig_vals.append(res.eigvals.float().cpu().numpy())
        interm_vecs.append(res.interm_eigvecs.float().cpu().numpy())
        interm_vals.append(res.interm_eigvals.float().cpu().numpy())
        norm_factors.append(float(solver.x0_shift_coeff(it)))
        in_corrs.append(res.in_corrs.float().cpu().numpy())
        in_norms.append(res.in_norms.float().cpu().numpy())

    def eig(it, v0):
        # the incoming solver state stays batch 1: it broadcasts
        return get_eigenvectors(
            solver, eps_pair_ev, widen(xts[it]), widen(latents[it + 1]), mask, it,
            widen(x0_preds[it]), v0=v0, generator=gen, mode=PCStreamChoice.BOTH,
            const=args.const, cfg_tar=cfg_tar, iters=args.iters, eta=args.eta, n_ev=n_ev,
            state=states[it], dp=ev_dp)

    for start in range(0, len(window), ts_chunk):
        chunk = window[start: start + ts_chunk]
        if step_dp is None:
            for j, it in enumerate(chunk):
                with clock.stage("power_iteration"):
                    record(it, eig(it, None if v0s is None else v0s[start + j]))
        else:
            # every rank draws each step's v0 in window order, runs its block
            # of the chunk's steps, and the results are gathered in step order
            draws = [v0s[start + j] if v0s is not None else
                     torch.randn(widen(xts[it]).shape, generator=gen, device=device,
                                 dtype=xts[it].dtype) for j, it in enumerate(chunk)]
            with clock.stage("power_iteration"):
                mine = step_dp.shard(torch.arange(len(chunk))).tolist()
                local = [eig(chunk[j], draws[j]) for j in mine]
                fields = {f: step_dp.gather(torch.stack([getattr(r, f) for r in local]),
                                            len(chunk))
                          for f in EigResult._fields if f != "snapshot_iters"}
            for j, it in enumerate(chunk):
                record(it, EigResult(**{f: v[j] for f, v in fields.items()},
                                     snapshot_iters=snaps))
        save()
    save()
    return ckpt_path, xts[-1]


if __name__ == "__main__":
    main()
