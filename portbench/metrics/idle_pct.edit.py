"""idle_pct.edit (%), device: the share of an edit's traced window with no device op running."""

from pbharness import readers


def read(ctx):
    return readers.idle_pct(ctx)
