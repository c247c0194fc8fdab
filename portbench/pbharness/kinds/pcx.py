"""PC extraction (traffic ``kind: pcx``): power iteration for a clip's top
posterior principal components, timestep after timestep of the drift
window (``editing.pc_drift.get_eigenvectors``: one CFG-pair forward of
2 n_evs rows, the norms and the QR per iteration).

Set-up builds what this traffic needs before it: the clip's encode, the
edit-friendly inversion and the drift-free trajectory (each step's input,
x0 prediction and incoming solver state), through the port's entry points
as its extraction CLI drives them. The window runs extractions back to
back, walking the drift window's timesteps in turn, each with its own
initial draw v0 from the seed and the extraction's index.

Judged after the window against the float32 reference:

- ``traj_rel``: the trajectory's input and x0 prediction at the sampled
  extraction's timestep, which the reference works out again from the clip
  and the draws;
- ``norm0_rel``: the first iteration's |Ab| per PC from v0, at the port's
  own trajectory state;
- ``step_norm_rel``: one iteration from the port's own iterate at its
  last snapshot: its |Ab| per PC, against the port's record of that
  iteration;
- ``qr_rel``: the returned PCs and eigenvalues against the reference's
  directional step, normalisation, QR and sort of the port's own last
  iteration (its input and its two CFG streams, kept in the window).

Two sound float32 extractions are not compared end to end: at the CLI's
probe of 1e-3 the iterates follow rounding, and two sound runs end at
uncorrelated PCs (``PERF.md``). Each stage is held from the port's own
input to it.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import torch

from .. import inputs, models, seeds
from ..readers import Context
from ..timing import StepClock, WindowEnd
from ..trace import DENOISER_SPAN, Tracer
from .common import DTYPES, Outcome, free, is_probe, reference_flags, rel_gap, sync

CHECKS = ("traj_rel", "norm0_rel", "step_norm_rel", "qr_rel")


def _modules(ref: bool):
    if ref:
        from pbreference.editing import cfg as cfg_mod, invert, pc_drift, solvers
        from pbreference.models import text_encoders
    else:
        from audioeditingcode_tpu_torch.editing import cfg as cfg_mod, invert, pc_drift, solvers
        from audioeditingcode_tpu_torch.models import text_encoders
    return cfg_mod, invert, pc_drift, solvers, text_encoders


class Extraction:
    """One side's pipeline, clip, trajectory and power iteration."""

    def __init__(self, pipe, cfg: dict, tr: dict, seed: int, device, ref: bool):
        self.pipe, self.cfg, self.tr, self.seed, self.device = pipe, cfg, tr, seed, device
        self.sa = cfg["family"] == models.STABLE_AUDIO
        (self.cfg_mod, self.invert, self.pc, solvers, self.text) = _modules(ref)
        self.solver = solvers.as_solver(pipe.sched, eta=1.0)
        self.n_ev = int(tr["n_evs"])
        src = tr["source_prompt"]
        self.uncond = pipe.encode_text([tr.get("negative_prompt", "")], negative=True)
        self.src = pipe.encode_text([src]) if src else None
        self.text_c = pipe.encode_text([src])
        self.empty = pipe.encode_text([""], negative=True)
        self.eps_pair = pipe.make_eps_pair(self.uncond, self.text_c)
        self.eps_pair_ev = pipe.make_eps_pair(self.text.repeat_cond(self.uncond, self.n_ev),
                                              self.text.repeat_cond(self.text_c, self.n_ev))

    def clip(self, mel_frontend=None) -> torch.Tensor:
        tr = self.tr
        if self.sa:
            max_s = self.pipe.audio_vae_length / self.pipe.sample_rate
            self.pipe.setup_duration(0.0, min(float(tr["clip_seconds"]), max_s))
            return inputs.waveform_batch(self.seed, 1, tr["clip_seconds"], self.cfg["sample_rate"],
                                         tr["channels"], self.device)
        return inputs.mel_batch(self.seed, 1, tr["clip_seconds"], self.pipe.mel_config,
                                self.device, mel_frontend)

    def trajectory(self, x: torch.Tensor) -> dict:
        """Encode, inversion and the drift-free trajectory, as the port's
        extraction CLI computes them, from the seed's draws."""
        tr, pipe, S = self.tr, self.pipe, self.pipe.sched.num_inference_steps
        g = seeds.generator(self.device, self.seed, "pcx")
        if self.sa:
            d = self.cfg["dit"]
            vn = torch.randn((1, d["in_channels"], d["sample_size"]), generator=g,
                             device=self.device)
            w0 = pipe.vae_encode(x, vn)
        else:
            w0 = pipe.vae_encode(x)
        inv_noise = torch.randn((S,) + tuple(w0.shape), generator=g, device=self.device)
        cfg_t, _ = self.cfg_mod.build_cfg_tensors(w0.shape, [tr["source_prompt"]],
                                                  [tr["cfg_tar"]], zero_empty_prompts=True,
                                                  device=self.device)
        fwd = pipe.make_denoiser(self.empty, self.src, cfg_t)
        _, zs, wts = self.invert.inversion_forward_process(pipe.sched, fwd, w0, inv_noise,
                                                           eta=1.0, numerical_fix=True)
        latents = torch.cat([wts[S: S + 1], torch.flip(zs, dims=(0,))], dim=0)
        xts, x0s, states = [latents[0]], [], []
        xt, state = latents[0], self.solver.init_state(latents[0])
        for it in range(S):
            states.append(state)
            xt, x0, state = self.pc.forward_directional(
                self.solver, self.eps_pair, xt, it, latents[it + 1], float(tr["cfg_tar"]),
                eta=1.0, state=state, return_state=True)
            xts.append(xt)
            x0s.append(x0)
        return {"latents": latents, "xts": xts, "x0s": x0s, "states": states,
                "mask": torch.ones(tuple(w0.shape), device=self.device)}

    def eig(self, traj: dict, it: int, v0: torch.Tensor, iters: int, eps_pair=None):
        n = self.n_ev
        return self.pc.get_eigenvectors(
            self.solver, eps_pair or self.eps_pair_ev, _widen(traj["xts"][it], n),
            _widen(traj["latents"][it + 1], n), traj["mask"], it, _widen(traj["x0s"][it], n),
            v0=v0, mode=self.pc.PCStreamChoice.BOTH, const=float(self.tr["const"]),
            cfg_tar=float(self.tr["cfg_tar"]), iters=iters, eta=1.0, n_ev=n,
            state=traj["states"][it])

    def last_stage(self, traj: dict, it: int, kept: tuple):
        """(PCs, eigenvalues) of the iteration whose input and two CFG
        streams are ``kept``: its directional step, then the normalisation,
        QR and sort, as ``get_eigenvectors`` returns them."""
        x_in, eps_u, eps_c = kept
        n, const = self.n_ev, float(self.tr["const"])
        _, x0_shift = self.pc.forward_directional(
            self.solver, lambda a, b, k: (eps_u, eps_c), x_in, it,
            _widen(traj["latents"][it + 1], n), float(self.tr["cfg_tar"]), eta=1.0,
            eigvecs=0.0, amount=0.0, mode=self.pc.PCStreamChoice.BOTH, state=traj["states"][it])
        mask = traj["mask"].bool().to(x_in.dtype)
        vecs, norm_ab = self.pc.orthonormalise(x0_shift * mask - _widen(traj["x0s"][it], n),
                                               mask, n)
        return vecs * const / const, norm_ab / const * self.pc._pc_sigma2(self.solver, it)


def _widen(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.repeat_interleave(n, dim=0)


def window_steps(tr: dict) -> List[int]:
    S = int(tr["steps"])
    return [it for it in range(S) if S - int(tr["drift_start"]) <= it < S - int(tr["drift_end"])]


def v0_draw(seed: int, unit: int, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=seeds.generator(device, seed, "v0", unit), device=device)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
        control: Optional[str] = None) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dtype = DTYPES[tr["dtype"]]
    S, iters, n_ev = int(tr["steps"]), int(tr["iters"]), int(tr["n_evs"])
    from audioeditingcode_tpu_torch.utils import audio_io

    pipe = models.build_port(cfg, seed, S, device, dtype)
    ex = Extraction(pipe, cfg, tr, seed, device, ref=False)
    x = ex.clip(audio_io)
    traj = ex.trajectory(x)
    its = window_steps(tr)
    shape = (n_ev,) + tuple(traj["xts"][0].shape[1:])

    clock = StepClock(device)
    tracer = Tracer(device) if trace else None
    host_ms: List[float] = []
    kept: Dict[int, tuple] = {}  # unit -> its last iteration's input and two streams
    state = {"step": 0, "unit": None, "iter": 0}
    t_first, t_n = int(tr["trace_first_step"]), int(tr["trace_steps"])
    stride = int(tr["host_probe_stride"])

    def timed(x_u, x_c, k):
        step = state["step"]
        in_window = clock.deadline is not None
        if tracer is not None and in_window and step == t_first:
            tracer.start()
        probe = tracer is not None and in_window and is_probe(step, stride, t_first, t_n)
        if probe:
            sync(device)
            h0 = time.perf_counter()
        if tracer is not None and tracer.active:
            with torch.profiler.record_function(DENOISER_SPAN):
                out = ex.eps_pair_ev(x_u, x_c, k)
        else:
            out = ex.eps_pair_ev(x_u, x_c, k)
        if probe:
            host_ms.append((time.perf_counter() - h0) * 1e3)
        if in_window and state["iter"] == iters - 1:
            kept[state["unit"]] = (x_u.detach().clone(),) + tuple(e.detach().clone()
                                                                  for e in out)
        state["iter"] += 1
        if in_window:
            state["step"] += 1
            if tracer is not None and tracer.active and state["step"] == t_first + t_n:
                tracer.stop()
            clock.step()
        return out

    # warm-up: two iterations at the window's shapes
    ex.eig(traj, its[0], v0_draw(seed, -1, shape, device), 2, eps_pair=timed)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    done = []
    clock.start(seconds)
    unit = 0
    try:
        while True:
            it = its[unit % len(its)]
            state["unit"], state["iter"] = unit, 0
            res = ex.eig(traj, it, v0_draw(seed, unit, shape, device), iters, eps_pair=timed)
            done.append((unit, it, res))
            clock.unit_done()
            unit += 1
            if clock.expired():
                break
    except WindowEnd:
        pass
    clock.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(1 for _, _, r in done
                 if not (bool(torch.isfinite(r.eigvecs).all())
                         and bool(torch.isfinite(r.eigvals).all())))
    steps = len(clock.steps)
    e2e = {"pc_iters_per_s": steps / clock.window_s if steps else 0.0}

    port_traj = {k: v for k, v in traj.items()}
    del ex, pipe, traj
    free(device)
    rng = random.Random(seeds.subseed(seed, "sample"))
    checks = judge(cell, seed, device, dtype, done, port_traj, kept, rng)
    out_notes = []
    if control is not None:
        out_notes.append({"control": control, "checks": judge(
            cell, seed, device, dtype, done, port_traj, kept,
            random.Random(seeds.subseed(seed, "sample")), control=control)})
    ctx = None
    if trace:
        from ..counting import count_forward

        fc = count_forward(cfg, shape[1:], 2 * n_ev)
        ctx = Context(dtype=dtype, forward=fc, trace=tracer.finish(), host_step_ms=host_ms,
                      window_forwards=steps, window_s=clock.window_s)
    out = Outcome(attempted=len(done), failed=failed, e2e=e2e, setup_s=setup_s,
                  memory_peak_bytes=peak, checks=checks, context=ctx)
    out.notes.extend(out_notes)
    return out


@torch.no_grad()
def judge(cell, seed: int, device, dtype, done, port_traj: dict, kept: Dict[int, tuple],
          rng: random.Random, control: Optional[str] = None) -> Dict[str, float]:
    from pbreference import audio, precision

    cfg, tr = cell.config, cell.traffic
    S, iters, n_ev = int(tr["steps"]), int(tr["iters"]), int(tr["n_evs"])
    reference_flags(tf32=False)
    checks: Dict[str, float] = {}
    if not done:
        return checks
    unit, it, res = done[rng.randrange(len(done))]
    precision.set_mode("f32")
    try:
        own = Extraction(models.build_reference(cfg, seed, S, device, dtype), cfg, tr, seed,
                         device, ref=True)
        # the start: the trajectory from the clip and the draws
        traj = own.trajectory(own.clip(audio))
        got, ex = port_traj, None
        if control is not None:
            precision.set_mode(control)
            ex = Extraction(models.build_reference(cfg, seed, S, device, dtype), cfg, tr, seed,
                            device, ref=True)
            got = ex.trajectory(ex.clip(audio))
            precision.set_mode("f32")
        checks["traj_rel"] = max(rel_gap(got["xts"][it], traj["xts"][it]),
                                 rel_gap(got["x0s"][it], traj["x0s"][it]))
        del traj, got
        shape = (n_ev,) + tuple(port_traj["xts"][0].shape[1:])
        v0 = v0_draw(seed, unit, shape, device)
        snap = res.snapshot_iters[-1] if res.snapshot_iters else None

        def both(fn):
            """(reference, compared): the reference in float32; compared is
            the port's (None), or the control's on the same inputs."""
            precision.set_mode("f32")
            r = fn(own)
            if control is None:
                return r, None
            precision.set_mode(control)
            return r, fn(ex)

        r0, c0 = both(lambda side: side.eig(port_traj, it, v0, 1))
        got0 = res.in_norms[0] if c0 is None else c0.in_norms[0]
        checks["norm0_rel"] = rel_gap(got0[None], r0.in_norms[0][None])
        if snap is not None and snap + 1 < iters:
            start = res.interm_eigvecs[-1]  # the iterate after iteration snap
            r1, c1 = both(lambda side: side.eig(port_traj, it, start, 1))
            norm = res.in_norms[snap + 1] if c1 is None else c1.in_norms[0]
            checks["step_norm_rel"] = rel_gap(norm[None], r1.in_norms[0][None])
        if unit in kept:
            (r_vecs, r_vals), c2 = both(lambda side: side.last_stage(port_traj, it, kept[unit]))
            g_vecs, g_vals = (res.eigvecs, res.eigvals) if c2 is None else c2
            checks["qr_rel"] = max(rel_gap(g_vecs, r_vecs), rel_gap(g_vals[:, None],
                                                                     r_vals[:, None]))
    finally:
        precision.set_mode("f32")
    return checks
