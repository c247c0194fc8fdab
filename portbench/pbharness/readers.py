"""What the per-layer metric files (``metrics/<name>.py``) read, from a
traced run's :class:`Context`. Each returns None where it finds nothing to
read (no trace, no device time, a launch count that does not match the
configuration's count), and the harness then leaves the metric out."""

from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional

import torch

from .counting import ForwardCount, peak_flops
from .trace import TraceSummary


@dataclasses.dataclass
class Context:
    dtype: torch.dtype  # the configuration's arithmetic
    forward: Optional[ForwardCount]  # one denoiser forward at the window's batch
    trace: Optional[TraceSummary]  # the traced stretch of the window
    host_step_ms: List[float]  # host spans of single steps into an empty queue
    window_forwards: int = 0  # denoiser forwards in the whole window
    window_s: float = 0.0  # the window's length on the device's clock


def host_ms_per_step(ctx: Context) -> Optional[float]:
    """The median host time to enqueue one step: the harness's span around
    a step's call at probes spread over the window outside the traced
    stretch, each timed after a synchronisation. Without one, a step that
    finds the launch queue full waits for the card, and its span reads the
    card's pace, not the host's."""
    return statistics.median(ctx.host_step_ms) if ctx.host_step_ms else None


def denoiser_ms(ctx: Context) -> Optional[float]:
    """Device time of the kernels launched inside one denoiser span, per
    span."""
    t = ctx.trace
    if t is None or not t.forwards or t.denoiser_kernel_s <= 0:
        return None
    return t.denoiser_kernel_s / t.forwards * 1e3


def roofline_pct(ctx: Context, kernel: str) -> Optional[float]:
    """A kernel's share of its roofline over the traced forwards: the least
    time its launches could take (``counting``), over the device time they
    took. None where the trace's launches are not the count's."""
    t, f = ctx.trace, ctx.forward
    if t is None or f is None or not t.forwards:
        return None
    per_forward = len(f.b1 if kernel == "B1" else f.b3)
    if not per_forward or t.kernel_launches[kernel] != per_forward * t.forwards:
        return None
    if t.kernel_s[kernel] <= 0:
        return None
    return 100.0 * t.forwards * f.kernel_bound_s(kernel, ctx.dtype) / t.kernel_s[kernel]


def mfu_pct(ctx: Context) -> Optional[float]:
    """The whole window's model FLOPs (its denoiser forwards, each counted
    from the configuration's shapes) over the window's length on the
    device's clock at the configuration's peak rate."""
    f = ctx.forward
    if f is None or not ctx.window_forwards or ctx.window_s <= 0:
        return None
    return 100.0 * f.flops * ctx.window_forwards / (ctx.window_s * peak_flops(ctx.dtype))


def idle_pct(ctx: Context) -> Optional[float]:
    """The share of the traced window in which no device op ran."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
