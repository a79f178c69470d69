"""Where the port runs: its entry points run on the card unless the caller
asks for the CPU, and a CUDA request without a GPU raises. ``--n_chips``
paths spread their work over one slot per chip (``slot_devices``)."""

from __future__ import annotations

import contextlib

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


def slot_devices(device: torch.device, n: int):
    """The device of each of ``n`` slots: ``cuda:0 .. n-1`` for a CUDA
    ``device`` (refused beyond the cards there are; one slot keeps
    ``device`` itself), else ``device`` n times."""
    if device.type != "cuda" or n == 1:
        return [device] * n
    if n > torch.cuda.device_count():
        raise ValueError(f"--n_chips {n} needs {n} CUDA devices, have "
                         f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(n)]


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (kernels
    launch on the current device); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def cyclic_pad(n: int, multiple: int):
    """Row indices that pad ``n`` rows up to a multiple of ``multiple`` by
    cycling through them (the batch may be smaller than the pad; JAX
    preprocess/frames.py:314-326)."""
    total = -(-n // multiple) * multiple
    return [i % n for i in range(total)]
