"""mfu_pct.pcx (%), whole step: the window's power-iteration FLOPs over its
device-clock length at the peak rate."""

from pbharness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
