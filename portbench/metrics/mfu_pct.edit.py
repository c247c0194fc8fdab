"""mfu_pct.edit (%), whole step: the window's denoiser FLOPs over its device-clock
length at the peak rate."""

from pbharness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
