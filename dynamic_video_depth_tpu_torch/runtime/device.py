"""Where the port runs: its entry points run on the card unless the caller
asks for the CPU, and a CUDA request without a GPU raises."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a name or a ``torch.device``) as a ``torch.device``; a
    CUDA device where none is available raises: there is no silent CPU
    fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but no CUDA device "
                           "is available; pass device 'cpu' (--device cpu) "
                           "to run on the CPU")
    return device
