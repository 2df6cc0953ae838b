"""Reproducible prefix sums and row sums (counterpart of ``tombo_tpu/ops/precision.py``).

float64 is the exact-parity mode: its prefix sums are sequential,
left to right, bitwise equal to ``np.cumsum`` and to the JAX package's
sequential f64 scan.  float32 prefix sums accumulate in float64.  A
double sum of float32 values is exact over the ranges these signals
span, so it does not depend on the summation order: the CPU, PyTorch's
CUDA scan and the hand-written block scan of the DP kernel
(csrc/banded_dp.cu) all give the same values.  :func:`prefix_sums` keeps
them in float64, so window sums and segment means taken as differences
are rounded to float32 once, at the end; :func:`seq_cumsum` rounds each
prefix sum.  :func:`row_sums` adds a row's entries in an order fixed by
the row's length alone, so a read's sum does not depend on how many rows
its batch holds (PyTorch's CUDA reductions choose their order by the
tensor's shape).
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


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (B,) sums along dim 1.  float32 adds pairwise, halving
    the zero-padded power-of-two width step by step, each step one
    elementwise add: the order depends on S alone, on any device and at
    any B.  float64, the CPU parity mode, sums as the JAX package does."""
    if x.dtype == torch.float64:
        return x.sum(1)
    w = 1
    while w < x.shape[1]:
        w *= 2
    x = torch.nn.functional.pad(x, (0, w - x.shape[1]))
    while w > 1:
        w //= 2
        x = x[:, :w] + x[:, w:]
    return x[:, 0]
