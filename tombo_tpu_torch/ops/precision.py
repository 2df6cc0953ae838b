"""Reproducible prefix sums (counterpart of ``tombo_tpu/ops/precision.py``).

float64 is the exact-parity mode: its prefix sums are sequential,
left to right, bitwise equal to ``np.cumsum`` and to the JAX package's
sequential f64 scan.  float32 prefix sums accumulate in float64.  A
double sum of float32 values is exact over the ranges these signals
span, so it does not depend on the summation order: the CPU, PyTorch's
CUDA scan and the hand-written block scan of the DP kernel
(csrc/banded_dp.cu) all give the same values.  :func:`prefix_sums` keeps
them in float64, so window sums and segment means taken as differences
are rounded to float32 once, at the end; :func:`seq_cumsum` rounds each
prefix sum.
"""
from __future__ import annotations

import torch


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (B, S + 1) float64 prefix sums along dim 1, with a
    leading zero column."""
    if x.dtype == torch.float64:
        # CPU cumsum walks the axis sequentially in double
        cs = torch.cumsum(x.cpu(), 1).to(x.device)
    else:
        cs = torch.cumsum(x, 1, dtype=torch.float64)
    return torch.nn.functional.pad(cs, (1, 0))


def seq_cumsum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    if x.dtype == torch.float64:
        return torch.cumsum(x.cpu(), dim).to(x.device)
    return torch.cumsum(x, dim, dtype=torch.float64).to(x.dtype)
