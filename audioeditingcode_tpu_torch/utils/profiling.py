"""Profiling and phase timing.

Counterpart of ``audioeditingcode_tpu/utils/profiling.py``: ``trace``
captures a ``torch.profiler`` trace around any phase (the JAX one captures
a ``jax.profiler`` trace), and ``PhaseTimer`` is the same wall-clock phase
timer with steps/sec reporting that the CLIs print.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """Capture a torch.profiler trace of the host and, where a card is
    present, of the device, written as a Chrome trace (viewable in Perfetto
    or chrome://tracing) to ``<profile_dir>/trace_<pid>.json`` when a
    directory is given; no-op otherwise. The pid keeps the traces of the
    ranks of a parallel run apart."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_{os.getpid()}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")


class PhaseTimer:
    """Wall-clock phase timing with steps/sec reporting.

    Usage::

        timer = PhaseTimer()
        with timer.phase("inversion", steps=200):
            ... run ...
        timer.report()
    """

    def __init__(self):
        self.phases: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, steps: Optional[int] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = {"seconds": dt}
            if steps:
                self.phases[name]["steps"] = steps
                self.phases[name]["steps_per_sec"] = steps / dt

    def report(self) -> None:
        for name, d in self.phases.items():
            extra = (f", {d['steps_per_sec']:.1f} steps/s"
                     if "steps_per_sec" in d else "")
            print(f"[timing] {name}: {d['seconds']:.3f}s{extra}")

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return dict(self.phases)
