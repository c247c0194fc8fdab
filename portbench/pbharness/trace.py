"""torch.profiler over a stretch of the window, reduced to what the
per-layer readers take: the device's busy and idle time, the kernels by
name, the kernels launched inside the harness's denoiser spans, and the
longest idle gaps with what the host was doing then.

The span ``pb.denoiser`` (``torch.profiler.record_function``) wraps each
denoiser call in the harness; a kernel belongs to it when the runtime call
that launched it (same correlation id) lies inside one.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DENOISER_SPAN = "pb.denoiser"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
KERNEL_KEYS = {"B1": ("attn_fwd_kernel", "attn_tc_kernel"),
               "B3": ("swiglu_tf32x3_kernel", "swiglu_tc_kernel")}


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # first device op's start to the last one's end
    busy_s: float  # union of device op intervals
    forwards: int  # denoiser spans in the trace
    denoiser_kernel_s: float  # kernels launched inside them
    kernel_s: Dict[str, float]  # B1, B3: device seconds
    kernel_launches: Dict[str, int]
    device_ops: List[Tuple[str, float]]  # the 10 names that took most time
    idle_gaps: List[Tuple[str, float]]  # the 10 longest gaps, by host activity


def kernel_of(name: str) -> Optional[str]:
    n = name.lower()
    for k, keys in KERNEL_KEYS.items():
        if any(key in n for key in keys):
            return k
    return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def summarize(events: List[dict]) -> Optional[TraceSummary]:
    """The reduction of a Chrome trace's events; None without device ops."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not dev:
        return None
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == DENOISER_SPAN)
    starts = [s for s, _ in spans]
    launches = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
    cpu_ops = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                      if e.get("cat") == "cpu_op"), key=lambda t: t[0])
    op_starts = [t[0] for t in cpu_ops]

    def in_denoiser(ts: float) -> bool:
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= spans[i][1]

    def host_at(ts: float) -> str:
        """The innermost host op open at ``ts`` (the latest-starting one)."""
        hi = bisect.bisect_right(op_starts, ts)
        for i in range(hi - 1, max(hi - 64, 0) - 1, -1):
            a, b, name = cpu_ops[i]
            if a <= ts <= b:
                return ("denoiser: " if in_denoiser(ts) else "") + name
        return "denoiser: python" if in_denoiser(ts) else "host: python"

    t0 = min(e["ts"] for e in dev)
    t1 = max(e["ts"] + e["dur"] for e in dev)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name: Dict[str, float] = {}
    kernel_s = {k: 0.0 for k in KERNEL_KEYS}
    kernel_n = {k: 0 for k in KERNEL_KEYS}
    den_s = 0.0
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
        k = kernel_of(e["name"])
        if k is not None:
            kernel_s[k] += e["dur"] * 1e-6
            kernel_n[k] += 1
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None and in_denoiser(launch["ts"]):
            den_s += e["dur"] * 1e-6
    # each gap between busy stretches, named by what the host was doing when
    # the kernel that ended it was launched
    by_start = sorted(dev, key=lambda e: e["ts"])
    dev_starts = [e["ts"] for e in by_start]
    gaps = []
    for (a0, a1), (b0, _) in zip(busy, busy[1:]):
        nxt = by_start[bisect.bisect_left(dev_starts, b0)]
        launch = launches.get(nxt.get("args", {}).get("correlation"))
        label = host_at(launch["ts"]) if launch is not None else "unknown"
        gaps.append((_short(label), (b0 - a1) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(
        window_s=(t1 - t0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
        forwards=len(spans), denoiser_kernel_s=den_s,
        kernel_s=kernel_s, kernel_launches=kernel_n,
        device_ops=sorted(((_short(n), s) for n, s in by_name.items()), key=lambda t: -t[1])[:10],
        idle_gaps=gaps[:10])


class Tracer:
    """torch.profiler started and stopped by hand (with a synchronisation on
    each side); after the window its Chrome trace is written to a temporary
    file, read back and deleted."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.stopped = False
        self.summary: Optional[TraceSummary] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        if self.prof is None or self.stopped:
            return
        self._sync()
        self.prof.stop()
        self.stopped = True

    def finish(self) -> Optional[TraceSummary]:
        """After the window: the trace written, read back, reduced."""
        self.stop()
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = summarize(events)
        return self.summary

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.stopped
