"""Device and dtype policy of the port.

Every entry point takes ``device=None``, which means ``"cuda"``.  With no
card present the entry point raises instead of carrying on on the CPU;
the CPU is used only when the caller asks for it (the CPU tests pass
``device="cpu"``).  The card computes in float32; the CPU may also run
float64, the exact-parity mode of the tests.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card; raise when a card is asked for and none
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device: %s" % dev)
    return dev


def resolve_dtype(dtype, device: torch.device) -> torch.dtype:
    """float32 by default; float64 only on the CPU."""
    if dtype is None:
        return torch.float32
    dt = {"float32": torch.float32, "float64": torch.float64}.get(
        str(dtype).replace("torch.", "").replace("numpy.", ""), dtype)
    if dt not in (torch.float32, torch.float64):
        raise ValueError("unsupported dtype: %s" % (dtype,))
    if dt == torch.float64 and device.type != "cpu":
        raise ValueError("the card computes in float32; float64 is a "
                         "CPU-only parity mode")
    return dt
