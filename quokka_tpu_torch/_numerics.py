"""Elementwise numerics that round alike on every device.

The plain PyTorch versions of the CUDA kernels take these where PyTorch's
own operation rounds differently on the CPU than the kernels do on the card.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device. PyTorch's vectorized
    float32 sqrt on the CPU is one ulp off for about 0.6% of inputs, where
    the CUDA kernels' sqrtf and XLA's sqrt round correctly; the float64
    square root rounded once to float32 is exact. The radiation fluxes
    amplify such ulps, so the plain versions take this one."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
