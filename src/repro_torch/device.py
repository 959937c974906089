"""Device resolution shared by every entry point of the port.

State is created on the CUDA card unless the caller asks for another
device (the tests pass ``device="cpu"``). Without a card and without an
explicit CPU device, creation raises: the port never quietly runs on the
host.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; raises if a CUDA device is asked for and none
    is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch state defaults to the CUDA device, but no CUDA "
            "device is available; pass device='cpu' to run on the host")
    return dev
