"""Timing of work on the card: by CUDA events, and on the device alone.

Both need a CUDA card; neither falls back to the CPU.
"""

from __future__ import annotations

import torch

# profiles device_ms takes before it gives up on one that shows device time
_PROFILE_ATTEMPTS = 3


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean time of fn() over reps back-to-back calls, by CUDA events: the
    device's time where it is busy throughout, else the host's time to
    issue each call."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn() over reps calls: the sum of the time of
    every kernel and copy it ran on the card, by torch.profiler, over reps.
    The host's time between launches is left out. A profile that delivers
    no device activity at all (CUPTI drops a session's buffers now and then
    among many short sessions in one process) is taken again, up to
    _PROFILE_ATTEMPTS profiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(_PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / reps
    raise RuntimeError(f"torch.profiler recorded no device time in {_PROFILE_ATTEMPTS} profiles")
