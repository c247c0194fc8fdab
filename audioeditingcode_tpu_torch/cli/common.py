"""Shared CLI plumbing: seeding, the results layout, artifact saving, the
PC diagnostics, wandb (optional) and per-stage timing.

Counterpart of ``audioeditingcode_tpu/cli/common.py``; the results layout
and ``run_args.json`` are the same. wandb and matplotlib are optional: a
missing or disabled wandb logs nothing, and without matplotlib the PC
correlation plots are skipped.
"""

from __future__ import annotations

import calendar
import json
import os
import random
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.image_io import write_png


def set_reproducibility(seed: Optional[int]) -> int:
    """Seed the host RNGs and torch; returns the seed (random if None)."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return seed


def check_sp(sp: Optional[int], stable_audio: bool) -> None:
    """An sp above 1 (``parallel.launch.requested_sp``) splits the DiT's
    token axis: only Stable Audio has one (the JAX CLIs' ValueError)."""
    if sp is not None and sp > 1 and not stable_audio:
        raise ValueError("--sp shards the DiT latent sequence axis; it requires a "
                         "stable-audio model (mel families scale via --dp/--tp)")


def maybe_shard_pipeline(pipe, dp: int, tp: int, sp: Optional[int] = None):
    """The mesh of a parallel run, with the pipeline's UNet, VAE, vocoder and
    DiT sharded over its tp axis (JAX ``cli/run.py::maybe_shard_pipeline``);
    None where nothing is asked for. sp is ``parallel.launch.requested_sp``:
    None where not asked for; an explicit sp, 1 included, gives the 3-axis
    mesh, under which the DiT's attention takes the sp route
    (``ops.flash_attention.sp_mesh_scope``). Every rank calls it, inside the
    run's process group (``parallel.launch.run_on_ranks``)."""
    if dp * tp == 1 and sp is None:
        return None
    from ..parallel.mesh import make_mesh, shard_module_params

    mesh = make_mesh(dp * tp * (sp or 1), dp=dp, tp=tp, sp=sp)
    for attr in ("unet", "vae", "vocoder", "dit"):
        module = getattr(pipe, attr, None)
        if module is not None:
            shard_module_params(module, mesh)
    return mesh


def timestamp_name() -> int:
    return calendar.timegm(time.gmtime())


def join_prompts(prompts: List[str]) -> str:
    return "__".join(x.replace(" ", "_") for x in prompts)


def edit_save_path(results_path: str, model_id: str, init_aud: str,
                   source_prompt: List[str], target_prompt: List[str],
                   target_neg_prompt: List[str]) -> str:
    """Results directory of one edit."""
    return os.path.join(
        results_path,
        model_id.split("/")[1] if "/" in model_id else model_id,
        os.path.basename(init_aud).split(".")[0],
        "src_" + join_prompts(source_prompt),
        "dec_" + join_prompts(target_prompt) + "__neg__" + join_prompts(target_neg_prompt),
    )


def edit_image_name(mode: str, cfg_src, cfg_tar, skip, num_steps: int) -> str:
    """Output basename of one edit."""
    ts = timestamp_name()
    base = (
        f'cfg_e_{"-".join(str(x) for x in cfg_src)}_'
        f'cfg_d_{"-".join(str(x) for x in cfg_tar)}_'
    )
    skips = np.atleast_1d(np.asarray(skip))
    if mode == "ours" or (skips != 0).any():
        return base + f'skip_{"-".join(str(int(x)) for x in skips)}_{ts}'
    return base + f"{num_steps}timesteps_{ts}"


def save_spectrogram_png(path: str, spec: np.ndarray) -> None:
    """The spectrogram as an 8-bit grayscale PNG, min-max scaled, tall
    spectrograms transposed (written directly, without matplotlib)."""
    spec = np.asarray(spec, np.float64)
    if spec.ndim == 4:
        spec = spec[0, 0]
    if spec.shape[0] > spec.shape[1]:
        spec = spec.T
    lo, hi = float(np.min(spec)), float(np.max(spec))
    write_png(path, np.round(255.0 * (spec - lo) / max(hi - lo, 1e-12)).astype(np.uint8))


def dump_run_summary(save_path: str, args, extra=None) -> None:
    """Machine-readable run record beside the artifacts."""
    payload = {k: v for k, v in vars(args).items() if not k.startswith("_")}
    payload = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in payload.items()}
    if extra:
        payload.update(extra)
    with open(os.path.join(save_path, "run_args.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)


def plot_corrs(corrs, in_corrs, n_evs: int, save_path: Optional[str] = None):
    """PC-correlation diagnostics: each PC's correlation with the previous
    timestep's, and the power method's mean successive-iterate correlation.
    Returns the two figures, saved as PNGs when ``save_path`` is given; (None,
    None) without matplotlib, which is then said in one line."""
    try:
        import matplotlib
    except ImportError:
        print("[!] matplotlib not installed; PC correlation plots skipped "
              "(the arrays are in the extraction's npz)")
        return None, None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    corrs = np.asarray(corrs) if len(corrs) else np.zeros((0, n_evs))
    fig1, ax = plt.subplots()
    for ev in range(n_evs):
        if corrs.shape[0]:
            ax.plot(corrs[:, ev], label=f"PC {ev + 1}")
    ax.set_xlabel("timestep index")
    ax.set_ylabel("corr with previous timestep's PC")
    ax.set_ylim(-1.05, 1.05)
    ax.legend()
    fig1.tight_layout()

    fig2, ax2 = plt.subplots()
    in_corrs = np.asarray(in_corrs) if len(in_corrs) else np.zeros((0, 1, n_evs))
    if in_corrs.size:
        mean_conv = in_corrs.mean(axis=0)  # (iters-1, n_ev)
        for ev in range(min(n_evs, mean_conv.shape[-1])):
            ax2.plot(mean_conv[:, ev], label=f"PC {ev + 1}")
    ax2.set_xlabel("power iteration")
    ax2.set_ylabel("mean successive-iterate corr")
    ax2.legend()
    fig2.tight_layout()

    if save_path is not None:
        fig1.savefig(os.path.join(save_path, "pc_corrs.png"))
        fig2.savefig(os.path.join(save_path, "pc_in_corrs.png"))
    plt.close(fig1)
    plt.close(fig2)
    return fig1, fig2


class WandbStub:
    """No-op drop-in used when wandb is unavailable or disabled."""

    def __getattr__(self, name):
        def _noop(*a, **k):
            return self

        return _noop


def init_wandb(args, job_type: str, name: str):
    """Open a wandb run (project "AudInv", named by ``--wandb_name`` or the
    output basename, with ``--wandb_group``, the job type and the args as its
    config); the no-op stub when disabled or not installed."""
    if getattr(args, "wandb_disable", True):
        return WandbStub()
    try:
        import wandb
    except ImportError:
        print("[!] wandb not installed; logging disabled")
        return WandbStub()
    mode = os.environ.get("WANDB_MODE", "online")
    wandb.init(project="AudInv", config={},
               name=getattr(args, "wandb_name", None) or name,
               group=getattr(args, "wandb_group", None),
               job_type=job_type, mode=mode)
    wandb.config.update(vars(args))
    return wandb


def log_edit_artifacts(wandb, name: str, sr: int,
                       orig_audio: np.ndarray, gen_audio: np.ndarray,
                       orig_spec: Optional[np.ndarray] = None,
                       gen_spec: Optional[np.ndarray] = None) -> None:
    """Log the original and generated audio and their spectrograms."""
    if isinstance(wandb, WandbStub):
        return
    d = {
        "orig": wandb.Audio(np.asarray(orig_audio).squeeze(), caption="orig",
                            sample_rate=sr),
        "gen": wandb.Audio(np.asarray(gen_audio).squeeze(), caption=name,
                           sample_rate=sr),
    }
    if orig_spec is not None:
        d["orig_spec"] = wandb.Image(np.asarray(orig_spec), caption="orig")
    if gen_spec is not None:
        d["gen_spec"] = wandb.Image(np.asarray(gen_spec), caption=name)
    wandb.log(d)


def log_pc_corrs(wandb, corrs, in_corrs, eigvals, n_evs: int) -> None:
    """Log PC-extraction diagnostics: the power method's convergence
    correlations per PC and every window step's eigenvalues."""
    if isinstance(wandb, WandbStub):
        return
    corrs = np.asarray(corrs) if len(corrs) else np.zeros((0, n_evs))
    in_corrs = np.asarray(in_corrs) if len(in_corrs) else np.zeros((0, 1, n_evs))
    eigvals = np.asarray(eigvals) if len(eigvals) else np.zeros((0, n_evs))
    for ev in range(n_evs):
        if in_corrs.size:
            mean_conv = in_corrs.mean(axis=0)
            table = wandb.Table(
                data=[[int(i), float(c)] for i, c in enumerate(mean_conv[:, ev])],
                columns=["iter", "corr"])
            wandb.log({f"in_corr_{ev}": wandb.plot.line(
                table, "iter", "corr",
                title=f"Subspace iteration correlations #PC {ev}")})
    # the iteration is a data field, not step=: wandb drops a log whose step
    # goes backwards, and the plots above already advanced the auto-step
    if eigvals.size:
        try:
            wandb.define_metric("eigval_*", step_metric="eigval_iter")
        except AttributeError:  # older wandb without define_metric
            pass
        for it in range(eigvals.shape[0]):
            row = {f"eigval_{ev}": float(eigvals[it, ev]) for ev in range(n_evs)}
            row["eigval_iter"] = it
            wandb.log(row)
    if corrs.size:
        fig1, _ = plot_corrs(corrs, in_corrs, n_evs)
        if fig1 is not None:
            wandb.log({"pc_corrs": wandb.Image(fig1)})


class StageClock:
    """Seconds and denoiser forwards per stage of a run, for run_args.json.

    ``stage(name)`` times a block (synchronising the card on both sides);
    ``counted(name, fn)`` wraps a denoiser so that each call adds one
    forward to the stage."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.forwards: Dict[str, int] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            self.forwards.setdefault(name, 0)

    def counted(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **k):
            self.forwards[name] = self.forwards.get(name, 0) + 1
            return fn(*a, **k)

        return wrapped

    def record(self) -> dict:
        return {"stage_seconds": dict(self.seconds), "stage_forwards": dict(self.forwards)}
