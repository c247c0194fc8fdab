"""The window's clock: CUDA events recorded on the device's stream after
each denoiser step, with no synchronisation inside the window. A rate is
the work of the whole window over the events' span; an interval is the
device time between two successive steps' end events. On a CPU (the tests
only) host timestamps stand in for the events."""

from __future__ import annotations

import time
from typing import List, Optional

import torch


class WindowEnd(Exception):
    """The host clock passed the window's end: stop at this step."""


class _HostEvent:
    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class StepClock:
    """Step events of one window. ``step()`` records one (and raises
    :class:`WindowEnd` once the host passes the deadline, but never before
    the window's first unit of work, an edit or an extraction, is done:
    ``unit_done()``); the window's device span runs from ``start()`` to
    ``stop()``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.steps: List = []
        self.units = 0
        self.deadline: Optional[float] = None
        self.t_start = self.t_stop = None

    def _event(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
        else:
            e = _HostEvent()
        e.record()
        return e

    def start(self, seconds: float) -> None:
        self.t_start = self._event()
        self.deadline = time.perf_counter() + seconds

    def step(self) -> None:
        if self.deadline is None:
            return
        self.steps.append(self._event())
        if self.units and time.perf_counter() >= self.deadline:
            raise WindowEnd

    def unit_done(self) -> None:
        self.units += 1

    def expired(self) -> bool:
        return (self.deadline is not None and self.units > 0
                and time.perf_counter() >= self.deadline)

    def stop(self) -> None:
        self.t_stop = self._event()
        self.deadline = None
        if self.cuda:
            torch.cuda.synchronize()

    @property
    def window_s(self) -> float:
        return self.t_start.elapsed_time(self.t_stop) / 1e3

    def intervals_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in zip(self.steps, self.steps[1:])]
