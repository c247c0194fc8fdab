"""Gaussian blur for the multi-prompt CFG masks.

Counterpart of ``audioeditingcode_tpu/ops/filters.py`` (torchvision
``gaussian_blur`` semantics: separable kernel, reflect padding).
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    """torchvision's 1-D gaussian kernel: exp(-x²/2σ²) normalized to sum 1."""
    x = np.linspace(-(kernel_size - 1) * 0.5, (kernel_size - 1) * 0.5, kernel_size)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def gaussian_blur_2d(x: torch.Tensor, kernel_size: int = 15, sigma: float = 1.0) -> torch.Tensor:
    """Separable gaussian blur over the last two dims with reflect padding,
    on any (..., H, W) input."""
    k = torch.as_tensor(_gaussian_kernel1d(kernel_size, sigma), dtype=x.dtype,
                        device=x.device)
    pad = kernel_size // 2
    h, w = x.shape[-2:]
    xr = x.reshape((-1, h, w))

    def taps(n):  # (n, kernel_size) reflect-padded source indices
        idx = np.arange(n)[:, None] + np.arange(kernel_size)[None, :] - pad
        idx = np.abs(idx)
        idx = np.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        return torch.as_tensor(idx, device=x.device)

    xh = torch.einsum("bhkw,k->bhw", xr[:, taps(h), :], k)  # blur along H
    xw = torch.einsum("bhwk,k->bhw", xh[:, :, taps(w)], k)  # blur along W
    return xw.reshape(x.shape)
