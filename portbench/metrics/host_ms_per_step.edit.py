"""host_ms_per_step.edit (ms), editing loop: the host's time to enqueue one edit step."""

from pbharness import readers


def read(ctx):
    return readers.host_ms_per_step(ctx)
