"""Elementwise numerics that round alike on every device.

The plain PyTorch versions of the CUDA kernels take these where PyTorch's
own operation rounds differently on the CPU or on the card than the kernels
do.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device. PyTorch's vectorized
    float32 sqrt on the CPU is one ulp off for about 0.6% of inputs, where
    the CUDA kernels' sqrtf and XLA's sqrt round correctly; the float64
    square root rounded once to float32 is exact. On a CUDA tensor
    PyTorch's sqrt already rounds correctly and is taken as it is."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, divided: PyTorch's CUDA division by a Python number multiplies
    by its reciprocal, one rounding more than the kernels and XLA take. The
    divisor is filled on x's device, so a CUDA caller does not wait for a
    host-to-device copy."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)
