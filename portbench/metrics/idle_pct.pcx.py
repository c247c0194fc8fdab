"""idle_pct.pcx (%), device: the share of PC extraction's traced window with no device op running."""

from pbharness import readers


def read(ctx):
    return readers.idle_pct(ctx)
