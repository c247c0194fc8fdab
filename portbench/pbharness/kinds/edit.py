"""Closed-loop batched text edits (traffic ``kind: edit``).

N clips under one prompt pair are one edit: the VAE encode of the N clips,
``editing.batched.edit_windows`` (the edit-friendly inversion and the
reverse pass from ``tstart``, 2N CFG rows in each denoiser forward), then
the decode to audio. The window runs whole edits back to back, each with
its own draws (the VAE sample's noise, the inversion noise) from the seed
and the edit's index, and ends at the first step past ``--seconds`` once an
edit is done.

Judged after the window against the float32 reference, which takes the
same clips and draws and works out everything else again. An edit at
cfg 12 amplifies any rounding step by step, so two sound float32 and
bfloat16 edits of one clip end far apart (``PERF.md``); the reference
therefore holds each stage from the port's own input to it:

- ``encode_rel``: the encode of a sampled edit, all N rows (the start);
- ``model_rel``: the denoiser's two CFG streams at sampled calls of the
  first edit, all 2N rows, at the port's own input of that call;
- ``step_rel``: one reverse solver step of the first edit from the port's
  own input, its noise map rebuilt from the port's forward-pass calls and
  its history from the previous reverse call, to the port's next input;
- ``decode_rel``: the decode to audio of the sampled edit's edited latents,
  all N rows.

Each is the largest over rows of |port - reference| / |reference|.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import inputs, models, seeds
from ..readers import Context
from ..timing import StepClock, WindowEnd
from ..trace import DENOISER_SPAN, Tracer
from .common import DTYPES, Outcome, free, is_probe, reference_flags, rel_gap, sync

CHECKS = ("encode_rel", "model_rel", "step_rel", "decode_rel")


@dataclasses.dataclass
class Api:
    """The editing entry points of one side: the port's or the reference's."""

    make_window_denoiser: Callable
    edit_windows: Callable
    build_cfg_tensors: Callable
    frontend: object
    make_sched: Callable  # (cfg, steps, device) -> the family's solver/schedule


def port_api(cfg: dict) -> Api:
    from audioeditingcode_tpu_torch.editing.batched import edit_windows, make_window_denoiser
    from audioeditingcode_tpu_torch.editing.cfg import build_cfg_tensors
    from audioeditingcode_tpu_torch.utils import audio_io

    if cfg["family"] == models.STABLE_AUDIO:
        from audioeditingcode_tpu_torch.editing.solvers import CosineDPMSolver
        from audioeditingcode_tpu_torch.schedulers.cosine_dpm import make_cosine_dpm_schedule

        spec = models.port_spec(cfg)

        def make_sched(steps, device):
            return CosineDPMSolver(make_cosine_dpm_schedule(spec.cosine_scheduler, steps,
                                                            device=device))
    else:
        from audioeditingcode_tpu_torch.schedulers.ddim import make_schedule

        spec = models.port_spec(cfg)

        def make_sched(steps, device):
            return make_schedule(spec.scheduler, steps, device=device)
    return Api(make_window_denoiser, edit_windows, build_cfg_tensors, audio_io, make_sched)


def reference_api(cfg: dict) -> Api:
    from pbreference import audio
    from pbreference.editing.batched import edit_windows, make_window_denoiser
    from pbreference.editing.cfg import build_cfg_tensors

    c = models.reference_configs(cfg)
    if cfg["family"] == models.STABLE_AUDIO:
        from pbreference.editing.solvers import CosineDPMSolver
        from pbreference.schedulers.cosine_dpm import make_cosine_dpm_schedule

        def make_sched(steps, device):
            return CosineDPMSolver(make_cosine_dpm_schedule(c["cosine_scheduler"], steps,
                                                            device=device))
    else:
        from pbreference.schedulers.ddim import make_schedule

        def make_sched(steps, device):
            return make_schedule(c["scheduler"], steps, device=device)
    return Api(make_window_denoiser, edit_windows, build_cfg_tensors, audio, make_sched)


class Side:
    """One side's pipeline with the cell's prompts, clips and denoisers."""

    def __init__(self, api: Api, pipe, cfg: dict, tr: dict, seed: int, device):
        self.api, self.pipe, self.cfg, self.tr, self.seed, self.device = (
            api, pipe, cfg, tr, seed, device)
        self.sa = cfg["family"] == models.STABLE_AUDIO
        src_p, tar_p = tr["source_prompt"], tr["target_prompt"]
        self.empty = pipe.encode_text([""], negative=True)
        self.uncond = pipe.encode_text([tr.get("negative_prompt", "")], negative=True)
        self.src = pipe.encode_text([src_p]) if src_p else None
        self.tgt = pipe.encode_text([tar_p])
        self._den = {}
        self.tap = None  # called with a forward's two CFG streams, when set

    def clips(self, n: int) -> torch.Tensor:
        """The n clips as the encoder takes them."""
        tr, cfg = self.tr, self.cfg
        if self.sa:
            self.durations(n)
            return inputs.waveform_batch(self.seed, n, tr["clip_seconds"], cfg["sample_rate"],
                                         tr["channels"], self.device)
        return inputs.mel_batch(self.seed, n, tr["clip_seconds"], self.pipe.mel_config,
                                self.device, self.api.frontend)

    def durations(self, n: int) -> None:
        if self.sa:
            max_s = self.pipe.audio_vae_length / self.pipe.sample_rate
            self.pipe.setup_clip_durations([min(float(self.tr["clip_seconds"]), max_s)] * n)

    def denoisers(self, shape):
        """(forward-pass, reverse-pass) window denoisers for latents of one
        row's ``shape``."""
        key = tuple(shape)
        if key not in self._den:
            tr, api, one = self.tr, self.api, (1,) + key
            cfg_src, _ = api.build_cfg_tensors(one, [tr["source_prompt"]], [tr["cfg_src"]],
                                               zero_empty_prompts=True, device=self.device)
            cfg_tar, _ = api.build_cfg_tensors(one, [tr["target_prompt"]], [tr["cfg_tar"]],
                                               device=self.device)
            fwd = api.make_window_denoiser(self._tapped(self.pair("fwd")),
                                           cfg_src if self.src is not None else None)
            rev = api.make_window_denoiser(self._tapped(self.pair("rev")), cfg_tar)
            self._den[key] = (fwd, rev)
        return self._den[key]

    def pair(self, tag: str):
        """The CFG pair of the forward (inversion) or reverse (edit) pass."""
        if tag == "fwd":
            return self.pipe.make_eps_pair(self.empty, self.src)
        return self.pipe.make_eps_pair(self.uncond, self.tgt)

    def _tapped(self, pair):
        def tapped(x_u, x_c, k):
            out = pair(x_u, x_c, k)
            if self.tap is not None:
                self.tap(out)
            return out

        return tapped

    def encode(self, x: torch.Tensor, draw) -> tuple:
        """(w0, inversion noise) of clips ``x`` under the draws named
        ``draw``: the VAE sample's noise (Stable Audio), then the (S, N, ...)
        inversion noise, from one generator."""
        g = seeds.generator(self.device, self.seed, "edit", draw)
        if self.sa:
            d = self.cfg["dit"]
            vn = torch.randn((x.shape[0], d["in_channels"], d["sample_size"]), generator=g,
                             device=self.device)
            w0 = self.pipe.vae_encode(x, vn)
        else:
            w0 = self.pipe.vae_encode(x)
        noise = torch.randn((self.pipe.sched.num_inference_steps,) + tuple(w0.shape),
                            generator=g, device=self.device)
        return w0, noise

    def edit(self, w0, noise, wrap=None, tstart=None) -> torch.Tensor:
        fwd, rev = self.denoisers(w0.shape[1:])
        if wrap is not None:
            fwd, rev = wrap(fwd, "fwd"), wrap(rev, "rev")
        tstart = int(self.tr["tstart"]) if tstart is None else tstart
        return self.api.edit_windows(self.pipe.sched, fwd, rev, w0, noise, tstart,
                                     eta=1.0, numerical_fix=True)

    def decode(self, w_edit) -> torch.Tensor:
        return self.pipe.decode_to_mel(self.pipe.vae_decode(w_edit))


@dataclasses.dataclass
class Call:
    """One denoiser call of the first edit, as the port made it."""

    tag: str  # "fwd" (inversion) or "rev" (edit)
    k: int
    xt: torch.Tensor  # its input
    out: torch.Tensor  # its guided output
    streams: tuple  # the forward's two CFG streams (unconditional, conditional)


@dataclasses.dataclass
class Done:
    index: int
    w0: torch.Tensor
    w_edit: torch.Tensor
    audio: torch.Tensor


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
        control: Optional[str] = None) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dtype = DTYPES[tr["dtype"]]
    S, T, N = int(tr["steps"]), int(tr["tstart"]), int(tr["clips"])
    api = port_api(cfg)
    pipe = models.build_port(cfg, seed, S, device, dtype)
    side = Side(api, pipe, cfg, tr, seed, device)
    x = side.clips(N)

    clock = StepClock(device)
    tracer = Tracer(device) if trace else None
    rng = random.Random(seeds.subseed(seed, "sample"))
    # the first edit's calls that are kept: three for the model, and the
    # five that one reverse step at k needs (forward k-1, k; reverse k-1,
    # k, k+1; the reverse call of step k is call T + k)
    model_at = {rng.randrange(S), S + rng.randrange(T), rng.randrange(S + T)}
    k_step = rng.randrange(S - T + 1, S - 1)
    step_at = {k_step - 1, k_step, T + k_step - 1, T + k_step, T + k_step + 1}
    captures: Dict[int, Call] = {}
    host_ms: List[float] = []
    state = {"edit": None, "call": 0, "step": 0}
    t_first, t_n = int(tr["trace_first_step"]), int(tr["trace_steps"])
    stride = int(tr["host_probe_stride"])

    def wrap(den, tag):
        def timed(xt, k):
            step = state["step"]
            in_window = clock.deadline is not None
            if tracer is not None and in_window and step == t_first:
                tracer.start()
            probe = tracer is not None and in_window and is_probe(step, stride, t_first, t_n)
            if probe:
                sync(device)
                h0 = time.perf_counter()
            keep = state["edit"] == 0 and state["call"] in model_at | step_at
            streams = []
            if keep:
                side.tap = lambda out: streams.extend(e.detach().clone() for e in out)
            if tracer is not None and tracer.active:
                with torch.profiler.record_function(DENOISER_SPAN):
                    out = den(xt, k)
            else:
                out = den(xt, k)
            side.tap = None
            if probe:
                host_ms.append((time.perf_counter() - h0) * 1e3)
            if keep:
                captures[state["call"]] = Call(tag, k, xt.detach().clone(), out.detach().clone(),
                                               tuple(streams))
            state["call"] += 1
            if in_window:
                state["step"] += 1
                if tracer is not None and tracer.active and state["step"] == t_first + t_n:
                    tracer.stop()
                clock.step()
            return out

        return timed

    # warm-up: one short edit at the cell's shapes (every kernel, both
    # solver orders, encode and decode), on a schedule of few steps
    main_sched = pipe.sched
    pipe.sched = api.make_sched(int(tr["warmup_steps"]), device)
    w0, noise = side.encode(x, "warmup")
    latent_shape = tuple(w0.shape[1:])
    side.decode(side.edit(w0, noise, tstart=max(1, int(tr["warmup_steps"]) // 2)))
    pipe.sched = main_sched
    side._den.clear()  # a denoiser holds the solver it was made with
    del w0, noise
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    done: List[Done] = []
    clock.start(seconds)
    i = 0
    try:
        while True:
            state["edit"], state["call"] = i, 0
            w0, noise = side.encode(x, i)
            w_edit = side.edit(w0, noise, wrap)
            done.append(Done(i, w0, w_edit, side.decode(w_edit)))
            clock.unit_done()
            i += 1
            if clock.expired():
                break
    except WindowEnd:
        pass
    clock.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(1 for d in done if not bool(torch.isfinite(d.audio).all()))
    steps = len(clock.steps)
    intervals = clock.intervals_ms()
    e2e = {"edit_steps_per_s": steps * N / clock.window_s if steps else 0.0}
    if intervals:
        e2e["edit_step_ms_p95"] = _percentile(intervals, 95.0)

    # ---- the comparison, once the window's state is freed
    del side, pipe
    free(device)
    sample = (sorted(model_at), k_step, random.Random(seeds.subseed(seed, "sample", 1)))
    checks = judge(cell, seed, device, dtype, done, captures, sample)
    control_checks = None
    if control is not None:
        sample = (sorted(model_at), k_step, random.Random(seeds.subseed(seed, "sample", 1)))
        control_checks = judge(cell, seed, device, dtype, done, captures, sample,
                               control=control)
    ctx = None
    if trace:
        from ..counting import count_forward

        fc = count_forward(cfg, latent_shape, 2 * N)
        ctx = Context(dtype=dtype, forward=fc, trace=tracer.finish(), host_step_ms=host_ms,
                      window_forwards=steps, window_s=clock.window_s)
    out = Outcome(attempted=len(done), failed=failed, e2e=e2e, setup_s=setup_s,
                  memory_peak_bytes=peak, checks=checks, context=ctx)
    if control_checks is not None:
        out.notes.append({"control": control, "checks": control_checks})
    return out


def _percentile(values: List[float], q: float) -> float:
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@torch.no_grad()
def judge(cell, seed: int, device, dtype, done: List[Done], captures: Dict[int, "Call"],
          sample, control: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared. The port's outputs are ``done`` and
    ``captures``; with ``control`` the reference in that precision stands
    in for the port, on the same samples and from the same inputs."""
    from pbreference import precision
    from pbreference.editing.solvers import as_solver

    cfg, tr = cell.config, cell.traffic
    S, T, N = int(tr["steps"]), int(tr["tstart"]), int(tr["clips"])
    model_at, k, rng = sample
    reference_flags(tf32=False)
    api = reference_api(cfg)
    checks: Dict[str, float] = {}
    if not done:
        return checks
    edit = done[rng.randrange(len(done))]
    precision.set_mode("f32")
    ref = Side(api, models.build_reference(cfg, seed, S, device, dtype), cfg, tr, seed, device)
    alt = None
    if control is not None:
        precision.set_mode(control)
        alt = Side(api, models.build_reference(cfg, seed, S, device, dtype), cfg, tr, seed,
                   device)
    precision.set_mode("f32")
    x = ref.clips(N)
    for side in filter(None, (ref, alt)):
        side.durations(N)

    def compare(name, fn_ref, port_value):
        """``name``'s gap: the port's value (or the control's, computed as
        the reference is, in its precision) against the reference's."""
        precision.set_mode("f32")
        r = fn_ref(ref)
        if alt is not None:
            precision.set_mode(control)
            try:
                port_value = fn_ref(alt)
            finally:
                precision.set_mode("f32")
        checks[name] = max(checks.get(name, 0.0), rel_gap(port_value, r))

    compare("encode_rel", lambda side: side.encode(x, edit.index)[0], edit.w0)
    for c in model_at:
        if c in captures:
            call = captures[c]
            compare("model_rel",
                    lambda side, call=call: torch.cat(side.pair(call.tag)(
                        call.xt.float(), call.xt.float(), call.k)),
                    torch.cat(call.streams))
    need = (k - 1, k, T + k - 1, T + k, T + k + 1)
    if all(c in captures for c in need):
        f1, f0, r1, r0, nxt = (captures[c] for c in need)
        w0 = done[0].w0.float()
        noise = ref.encode(x, done[0].index)[1]

        def step(side):
            q = precision.q  # the control rounds the step's operands too
            solver = as_solver(side.pipe.sched, eta=1.0, numerical_fix=True)
            raw = solver.sample_xts(w0, noise)
            init = solver.init_state(q(f0.xt.float()))
            st = solver.forward_step(init, k - 1, q(f1.xt.float()), q(raw[S - k]),
                                     q(f1.out.float()))[0]
            z = solver.forward_step(st, k, q(f0.xt.float()), q(raw[S - k - 1]),
                                    q(f0.out.float()))[1]
            st = solver.reverse_step(init, k - 1, q(r1.xt.float()), q(r1.out.float()),
                                     torch.zeros_like(z))[0]
            return solver.reverse_step(st, k, q(r0.xt.float()), q(r0.out.float()), z)[1]

        compare("step_rel", step, nxt.xt)
    compare("decode_rel", lambda side: side.decode(edit.w_edit.float()), edit.audio)
    return checks
