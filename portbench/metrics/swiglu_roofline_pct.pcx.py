"""swiglu_roofline_pct.pcx (%), kernels: B3's share of its roofline in PC extraction."""

from pbharness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "B3")
