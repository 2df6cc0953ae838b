"""Device and dtype policy of the port.

Every entry point takes ``device=None``, which means ``"cuda"``.  With no
card present the entry point raises instead of carrying on on the CPU;
the CPU is used only when the caller asks for it (the CPU tests pass
``device="cpu"``).  The card computes in float32; the CPU may also run
float64, the exact-parity mode of the tests.  A reads mesh
(:func:`resolve_mesh`) is a tuple of indexed devices of one type.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

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


def resolve_mesh(devices: Iterable[DeviceLike]) -> Tuple[torch.device, ...]:
    """The devices of a reads mesh, each resolved and indexed (``"cuda"``
    becomes ``cuda:<current>``).  A device may repeat: two shards on one
    card, or ``["cpu"] * n`` on the CPU.  Raises on an empty list, on a
    list that mixes device types, and on a CUDA mesh with no card."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    kinds = sorted({d.type for d in devs})
    if len(kinds) > 1:
        raise ValueError("a mesh may not mix device types (%s)" %
                         ", ".join(kinds))
    out = []
    for d in devs:
        d = resolve_device(d)
        if d.type == "cuda":
            idx = torch.cuda.current_device() if d.index is None else d.index
            if idx >= torch.cuda.device_count():
                raise ValueError("no CUDA device %d (%d visible)" % (
                    idx, torch.cuda.device_count()))
            d = torch.device("cuda", idx)
        out.append(d)
    return tuple(out)


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
