"""denoiser_ms.pcx (ms), denoiser: device time of the kernels inside one power-iteration forward."""

from pbharness import readers


def read(ctx):
    return readers.denoiser_ms(ctx)
