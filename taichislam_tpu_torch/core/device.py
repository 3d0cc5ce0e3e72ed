"""The device the port keeps its state on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` when one is given, else the CUDA card. Without a card and
    without a device this raises: the CPU runs only when the caller asks
    for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
