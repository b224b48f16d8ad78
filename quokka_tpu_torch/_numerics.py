"""Elementwise numerics that round alike on every device.

The plain PyTorch versions of the CUDA kernels take these where PyTorch's
own operation rounds differently on the CPU or on the card than the kernels
do.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device. PyTorch's vectorized
    float32 sqrt on the CPU is one ulp off for about 0.6% of inputs, and its
    float64 sqrt for about 0.8%, where the CUDA kernels' sqrtf, CUDA's sqrt,
    NumPy's and XLA's round correctly: a float32 input takes the float64
    square root rounded once to float32, a float64 one NumPy's. On a CUDA
    tensor PyTorch's sqrt already rounds correctly and is taken as it is."""
    if x.device.type == "cpu":
        if x.dtype == torch.float32:
            return torch.sqrt(x.double()).float()
        if x.dtype == torch.float64 and not x.requires_grad:
            return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, divided: PyTorch's CUDA division by a Python number multiplies
    by its reciprocal, one rounding more than the kernels and XLA take. The
    divisor is filled on x's device, so a CUDA caller does not wait for a
    host-to-device copy."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _via_f64(fn, *args):
    """fn of float32 tensors evaluated in float64 and rounded once to
    float32, which the CPU and the card round alike (their float32 pow, log
    and expm1 differ in the last ulp); other dtypes as they are."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if tensors and tensors[0].dtype == torch.float32:
        return fn(*(a.double() if isinstance(a, torch.Tensor) else a for a in args)).float()
    return fn(*args)


def pow(x, y):  # noqa: A001  (the name of the function it rounds)
    """x**y, rounded alike on every device (`_via_f64`)."""
    return _via_f64(torch.pow, x, y)


def log(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.log, x)


def exp(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.exp, x)


def expm1(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.expm1, x)
