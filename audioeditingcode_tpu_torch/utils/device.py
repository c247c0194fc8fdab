"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda", device_num: int = 0) -> torch.device:
    """``cuda`` (card ``device_num``) or ``cpu``. A CUDA device that is
    missing is an error, never a silent CPU run.

    Selecting a card also turns TF32 off for float32 work, for the whole
    process: cuBLAS matmuls and cuDNN convolutions would otherwise round
    float32 inputs to TF32 (cuDNN does by default), which the JAX
    reference never does in float32."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if not 0 <= device_num < torch.cuda.device_count():
        raise RuntimeError(f"--device_num {device_num}: only "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", device_num)
