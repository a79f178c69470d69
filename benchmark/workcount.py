"""Work counts from shapes, and the card's peaks.

The depth net's convolutions are read once from the configuration's plain
reference net (the architecture that the program's net has to load the
weights of), run on the ``meta`` device with forward hooks: each
convolution's input, weight and output shapes and whether its input needs
a gradient. A main step computes each forward, each data gradient whose
input needs one (not the stem's: its input is the image) and each weight
gradient. The FLOP count of one convolution is ``2 * N * Ho * Wo * Cout *
(Cin / groups) * kh * kw`` (a copy of the port's ``tools/roofline.py::
conv_flops``); its bytes read each input and write each output once. The
scene-flow field's FLOPs are ``2 * points * sum(in * out)`` over its dense
layers a forward evaluation, three times that with the backward, for each
of the ``max(2, gap)`` evaluations a step makes.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s in bfloat16, 495
TFLOP/s for float32 operands (the TF32 tensor-core rate; no float32 route on
the card computes faster), 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn
from torch.func import functional_call

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def conv_flops(s: Dict) -> int:
    n, cout, ho, wo = s["output"]
    kh, kw = s["kernel"]
    return 2 * n * ho * wo * cout * (s["input"][1] // s["groups"]) * kh * kw


def conv_shapes(net: nn.Module, images: int, h: int, w: int) -> List[Dict]:
    """One dict per convolution call of a forward over ``images`` frames of
    ``h x w`` (``[images, h, w, 3]`` in, as the depth nets take them)."""
    tensors = {k: torch.empty(v.shape, dtype=torch.float32, device="meta",
                              requires_grad=v.requires_grad)
               for k, v in net.named_parameters()}
    tensors.update({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in net.named_buffers()})
    calls = []

    def hook(mod, inputs, out):
        calls.append({"input": tuple(inputs[0].shape),
                      "weight": tuple(mod.weight.shape),
                      "output": tuple(out.shape),
                      "kernel": tuple(mod.kernel_size),
                      "groups": mod.groups,
                      "dgrad": bool(inputs[0].requires_grad)})

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        with torch.enable_grad():
            functional_call(net, tensors, (torch.empty(
                images, h, w, 3, device="meta"),))
    finally:
        for handle in handles:
            handle.remove()
    return calls


def conv_work(calls: List[Dict], dtype: str) -> Dict[str, float]:
    """FLOPs and bytes of a main step's convolutions: forward, data
    gradient (where the input needs one) and weight gradient."""
    e = ELEMENT_BYTES[dtype]
    flops = nbytes = 0
    for c in calls:
        f = conv_flops(c)
        x, wt, y = (math.prod(c[k]) for k in ("input", "weight", "output"))
        flops += 2 * f + (f if c["dgrad"] else 0)
        nbytes += e * ((x + wt + y) + (x + y + wt)
                       + ((y + wt + x) if c["dgrad"] else 0))
    return {"flops": float(flops), "bytes": float(nbytes)}


def field_dims(field: dict) -> List[int]:
    width = 3 * (1 + 2 * field["n_freq_xyz"])
    if field["time_dependent"]:
        width += 1 + 2 * field["n_freq_t"]
    return ([width] + [field["net_width"]] * (field["n_layers"] + 1)
            + [field["output_dim"]])


def field_work(field: dict, points: int, gap: int) -> Dict[str, float]:
    """FLOPs and bytes of a main step's field evaluations, forward and
    backward: each evaluation reads a point and its time and writes its
    flow (and the backward the same again, twice), plus the weights."""
    dims = field_dims(field)
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    evals = max(2, gap)
    flops = 3 * 2 * points * macs * evals
    nbytes = 4 * evals * 3 * (points * (4 + dims[-1]) + params)
    return {"flops": float(flops), "bytes": float(nbytes)}


def least_seconds(work: Dict[str, float], dtype: str) -> float:
    """The least time the card could take: the larger of FLOPs over the
    type's peak and bytes over the memory's."""
    return max(work["flops"] / PEAK_FLOPS[dtype],
               work["bytes"] / PEAK_BYTES)
