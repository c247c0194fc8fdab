"""PC drift application CLI on PyTorch.

Counterpart of ``audioeditingcode_tpu/cli/pc_apply.py``, with the same
flags and outputs. Run it as ``python -m
audioeditingcode_tpu_torch.cli.pc_apply``; it runs on the CUDA card
``--device_num`` unless ``--device cpu`` is given, and a missing card is an
error. It loads a PC extraction (written by either package), reruns the
drift-free trajectory up to the window at batch 1, then drifts along the
chosen PCs inside [drift_start, drift_end) at one row per ev (or one row
with ``--combine_evs``), optionally blended back toward the stored
trajectory outside a ``--patch`` mask (``--fix_alpha``, ``--fade_length``);
``--rand_v`` swaps each PC for a random vector of its norm. The random
weights are the extraction's: seeded by its seed.
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from ..editing.pc_drift import apply_drift, forward_directional
from ..editing.pcdata import load_extraction, step_timestep_key
from ..editing.solvers import as_solver
from ..models.registry import load_model, resolve_spec
from ..models.text_encoders import repeat_cond
from ..schedulers.cosine_dpm import SolverState
from ..utils.audio_io import write_wav
from ..utils.device import resolve_device
from .common import (
    StageClock,
    dump_run_summary,
    init_wandb,
    save_spectrogram_png,
    set_reproducibility,
)
from .pc_extract import patch_mask


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Apply extracted PCs to audio")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--extraction_path", type=str, required=True)
    p.add_argument("--drift_start", type=int, required=True)
    p.add_argument("--drift_end", type=int, required=True)
    p.add_argument("--amount", type=float, required=True)
    p.add_argument("--use_specific_ts_pc", type=int, default=None)
    p.add_argument("--fix_alpha", type=float, default=None)
    p.add_argument("--fade_length", type=float, default=0.0)
    p.add_argument("--evs", type=int, nargs="+", default=[1])
    p.add_argument("--combine_evs", action="store_true")
    p.add_argument("--evals_pt", type=str, default=None,
                   help="Precomputed averaged eigenvalues (.npz mapping t->eigvals)")
    p.add_argument("--rand_v", action="store_true")
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_disable", action="store_true")
    return p


def parse_args(argv=None):
    """Parse, then apply the fixed post-parse args (shift_x0_for_np=True,
    sub_iters=None)."""
    args = build_parser().parse_args(argv)
    args.shift_x0_for_np = True
    args.sub_iters = None
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.drift_start < args.drift_end:
        raise ValueError("Drift start must be greater than drift end")
    for suffix in (".pt", ".npz"):
        if args.extraction_path.endswith(suffix):
            args.extraction_path = args.extraction_path[: -len(suffix)]
    load = load_extraction(args.extraction_path)
    ex_args = load["args"]
    if args.weights_dir is None and getattr(ex_args, "weights_dir", None):
        args.weights_dir = ex_args.weights_dir
    resolve_spec(ex_args.model_id)  # raises for model families not ported yet
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)

    run_name = (
        f"drift{args.drift_start}-{args.drift_end}"
        f'{"_spts" + str(args.use_specific_ts_pc) if args.use_specific_ts_pc is not None else ""}'
        f'{"_shiftx0-4np" if args.shift_x0_for_np else ""}'
        f'{f"fix{args.fix_alpha}" if args.fix_alpha is not None else ""}'
        f'{"_fade" + str(args.fade_length) if args.fade_length > 0 else ""}'
        f'{"_avgeval" if args.evals_pt is not None else ""}'
        f'{"_RAND" if args.rand_v else ""}'
        f"_a{args.amount}"
    )
    wandb = init_wandb(args, "pc_application", run_name)
    if args.weights_dir is None:
        warnings.warn("running with RANDOM weights.")

    eigdata = load["eigdata"]
    latents = torch.as_tensor(load["latents"], device=device)
    xts = torch.as_tensor(load["xts"], device=device) if args.fix_alpha is not None else None
    rng = np.random.default_rng(seed)
    if args.rand_v:
        for k in eigdata:
            v = eigdata[k]["eigvec"]
            r = rng.standard_normal(v.shape).astype(np.float32)
            eigdata[k]["eigvec"] = r / np.linalg.norm(r) * np.linalg.norm(v)

    # fade length in latent frames
    args.fade_length = int(args.fade_length * latents.shape[3] / 15)

    S = int(ex_args.num_diffusion_steps)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = load_model(ex_args.model_id, S, device=device, dtype=dtype,
                      seed=int(ex_args.seed), weights_dir=args.weights_dir)
    if resolve_spec(ex_args.model_id).family == "stable-audio":
        # the extraction's duration conditioning and decode crop (an
        # extraction that records none conditions on the model's full length)
        dur = getattr(ex_args, "duration", None)
        pipe.setup_duration(0.0, None if dur is None else float(dur))
    cfg_tar = float(getattr(ex_args, "cfg_tar_scalar", np.atleast_1d(ex_args.cfg_tar)[0]))
    eta = float(ex_args.eta)

    clock = StageClock(device)
    xt = run_pc_application(args, pipe, ex_args, eigdata, latents, xts, cfg_tar, eta,
                            clock=clock)

    drifts_path = args.extraction_path + "_driftgens"
    os.makedirs(drifts_path, exist_ok=True)
    x_dec = torch.cat([pipe.vae_decode(xt[i: i + 1]) for i in range(xt.shape[0])], dim=0)
    # rows: (T,) mono mel-family audio or (C, T) Stable Audio stereo
    audio = pipe.decode_to_mel(x_dec).float().cpu().numpy()
    if not np.all(np.isfinite(audio)):
        raise FloatingPointError("the drift produced non-finite audio")

    def out_name(prefix):
        return (
            f"{prefix}_drift{args.drift_start}-{args.drift_end}"
            f'{"_spts" + str(args.use_specific_ts_pc) if args.use_specific_ts_pc is not None else ""}'
            f"_it{ex_args.iters if args.sub_iters is None else args.sub_iters}"
            f"_shiftednp{args.shift_x0_for_np}"
            f'{"_fade" + str(args.fade_length) if args.fade_length > 0 else ""}'
            f'{f"_fix{args.fix_alpha}" if args.fix_alpha is not None else ""}'
            f'{"_avgeval" if args.evals_pt is not None else ""}'
            f'{"_RAND" if args.rand_v else ""}'
            f"_a{args.amount}.wav"
        )

    outputs = []
    if args.combine_evs:
        names = [(out_name(f'pcs{"".join(str(x) for x in args.evs)}'), 0)]
    else:
        names = [(out_name(f"pc{ev}"), min(i, audio.shape[0] - 1))
                 for i, ev in enumerate(args.evs)]
    for name, row in names:
        write_wav(os.path.join(drifts_path, name), audio[row], pipe.get_sr())
        outputs.append(os.path.join(drifts_path, name))
    if x_dec.dim() == 4:  # mel-family spectrograms only
        save_spectrogram_png(os.path.join(drifts_path, "drift_spec.png"),
                             x_dec.float().cpu().numpy())
    dump_run_summary(drifts_path, args, {"seed": seed, "device": str(device),
                                         **clock.record()})
    for o in outputs:
        print(f"[+] saved {o}")
    wandb.finish()
    return outputs


def _rows(state, sl: slice):
    """Rows ``sl`` of a solver state (DDIM's () passes through)."""
    if isinstance(state, SolverState):
        return SolverState(m1=state.m1[sl], m1_valid=state.m1_valid)
    return state


def _cat_states(states):
    if isinstance(states[0], SolverState):
        return SolverState(m1=torch.cat([s.m1 for s in states], dim=0),
                           m1_valid=states[0].m1_valid)
    return states[0]


@torch.no_grad()
def run_pc_application(args, pipe, ex_args, eigdata, latents, xts, cfg_tar, eta,
                       clock=None):
    """Rerun the drift-free trajectory and apply PC drift inside the window.
    Returns the final latent batch: one row per ev, or one if combined.

    Phase A runs the batch-1 trajectory up to the window; phase B the rest
    at batch n_out, the drift replacing the plain step inside the window
    (solver history included)."""
    S = int(ex_args.num_diffusion_steps)
    device = latents.device
    clock = clock or StageClock(device)
    uncond = pipe.encode_text(list(ex_args.target_neg_prompt), negative=True)
    text = pipe.encode_text(list(ex_args.source_prompt))
    solver = as_solver(pipe.sched, eta=eta)

    evals_override = None
    if args.evals_pt is not None:
        z = np.load(args.evals_pt)
        evals_override = {int(k): z[k] for k in z.files}
    fix = args.fix_alpha is not None and xts is not None
    # the --fix_alpha mask: the extraction's --patch, faded at its edges
    mask = (torch.as_tensor(patch_mask(tuple(latents[0].shape), getattr(ex_args, "patch", None),
                                       args.fade_length), device=device) if fix else None)

    drift_start_it = max(S - args.drift_start, 0)
    drift_end_it = S - args.drift_end
    timesteps = getattr(pipe.sched, "sched", pipe.sched).timesteps.cpu().numpy()
    n_out = 1 if args.combine_evs else len(args.evs)

    # phase A: the batch-1 trajectory up to the window
    a_end = min(drift_start_it, S)
    pair = clock.counted("trajectory", pipe.make_eps_pair(uncond, text))
    xt = latents[0]
    state = solver.init_state(xt)
    with clock.stage("trajectory"):
        for it in range(a_end):
            xt, _, state = forward_directional(solver, pair, xt, it, latents[it + 1], cfg_tar,
                                               eta=eta, state=state, return_state=True)
    if a_end >= S:
        return xt

    # phase B: batch n_out over [a_end, S); the rows are equal entering the
    # window, so widening the batch here reproduces a batch-1 first step
    if xt.shape[0] == 1 and n_out > 1:
        xt = xt.repeat_interleave(n_out, dim=0)
        if isinstance(state, SolverState):
            state = SolverState(m1=state.m1.repeat_interleave(n_out, dim=0),
                                m1_valid=state.m1_valid)
    n_ev = next(iter(eigdata.values()))["eigvec"].shape[0] if eigdata else 1
    lat_shape = tuple(latents.shape[2:])
    pair_n = clock.counted("drift", pipe.make_eps_pair(repeat_cond(uncond, n_out),
                                                       repeat_cond(text, n_out)))
    sel = [e - 1 for e in args.evs]

    def eig(it):
        t_val = step_timestep_key(timesteps, it)
        use_t = (t_val if args.use_specific_ts_pc is None
                 else step_timestep_key(timesteps, S - args.use_specific_ts_pc))
        vecs = np.asarray(eigdata[use_t]["eigvec"]).reshape((n_ev,) + lat_shape)
        vals = (np.asarray(evals_override[t_val]) if evals_override is not None
                else np.asarray(eigdata[t_val]["eigval"]))
        return (torch.as_tensor(vecs, dtype=torch.float32, device=device),
                torch.as_tensor(vals, dtype=torch.float32, device=device))

    with clock.stage("drift"):
        for it in range(a_end, S):
            latent = latents[it + 1]
            lat_b = latent.repeat_interleave(n_out, dim=0) if n_out > 1 else latent
            xt_m1, x0_pred, st_fwd = forward_directional(
                solver, pair_n, xt, it, lat_b, cfg_tar, eta=eta, state=state,
                return_state=True)
            if not drift_start_it <= it < drift_end_it:
                xt, state = xt_m1, st_fwd
                continue
            vec, val = eig(it)
            if args.combine_evs:
                drift, st_drift = apply_drift(
                    solver, it, xt_m1, x0_pred, vec[sel], val[sel], latent, eta=eta,
                    amount=args.amount, use_shifted_x0_for_noisepred=args.shift_x0_for_np,
                    xt=xt, state=state, return_state=True)
            else:
                outs, sts = [], []
                for i, ev in enumerate(args.evs):
                    row = slice(i, i + 1)
                    o, s_ev = apply_drift(
                        solver, it, xt_m1[row], x0_pred[row], vec[ev - 1: ev],
                        val[ev - 1: ev], latent, eta=eta, amount=args.amount,
                        use_shifted_x0_for_noisepred=args.shift_x0_for_np,
                        xt=xt[row], state=_rows(state, row), return_state=True)
                    outs.append(o)
                    sts.append(s_ev)
                drift, st_drift = torch.cat(outs, dim=0), _cat_states(sts)
            if fix:
                pxt = xts[it + 1]
                drift = mask * drift + (1 - mask) * (
                    args.fix_alpha * pxt + (1 - args.fix_alpha) * drift)
            xt, state = drift, st_drift
    return xt
