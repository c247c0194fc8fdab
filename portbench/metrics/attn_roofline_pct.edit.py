"""attn_roofline_pct.edit (%), kernels: B1's share of its roofline in an edit."""

from pbharness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "B1")
