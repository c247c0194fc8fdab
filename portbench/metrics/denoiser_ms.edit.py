"""denoiser_ms.edit (ms), denoiser: device time of the kernels inside one CFG forward of an edit."""

from pbharness import readers


def read(ctx):
    return readers.denoiser_ms(ctx)
