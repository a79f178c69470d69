"""The DPT's work that ``workcount.conv_shapes`` does not see: its dense
layers (the blocks' ``qkv``, ``proj``, ``fc1``, ``fc2`` and the readouts'
projections), attention's two products and the transposed convolutions of
the reassembly. Counted from shapes as ``workcount.conv_work`` counts a
convolution: forward, data gradient (where the input needs one) and
weight gradient.

The calls are read once from the configuration's plain reference net
(``configs/dpt_large.py``) on the ``meta`` device with forward hooks:
each ``nn.Linear`` and ``nn.ConvTranspose2d`` call, and each call of a
module with a ``num_heads`` (the reference's attention, ``[B, N, C]`` in).

- A dense layer of ``M`` rows: ``2 * M * in * out`` a pass; its bytes read
  each input and write each output once a pass.
- A transposed convolution of input ``[N, Cin, H, W]`` and weight ``[Cin,
  Cout / groups, kh, kw]``: ``2 * N * H * W * Cin * (Cout / groups) * kh *
  kw`` a pass (each input pixel scatters a ``kh x kw`` patch).
- Attention over ``B`` sequences of ``N`` tokens in ``H`` heads of ``d``:
  ``q k^T`` and ``p v``, each ``2 * B * H * N * N * d`` a pass, three
  passes with the backward (a recomputation of the scores in the backward
  is not model work). Bytes are those of a fused kernel, which keeps the
  scores on chip: ``q, k, v`` read and the output written forward, ``q,
  k, v``, the output and its gradient read and three gradients written
  backward.

The per-layer readers ``depth_net.roofline.dpt`` and ``step.mfu.dpt`` add
this to the harness's ``RunRecord.depth_work`` (the convolutions) for the
cell they list, ``WORKLOAD``, and read nothing where the run's convolution
count is not that cell's.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call

from . import spec, workcount

WORKLOAD = "dpt_large.fast_b8_f32"


def shapes(net: nn.Module, images: int, h: int, w: int) -> List[Dict]:
    """One dict per dense, transposed-convolution or attention call of a
    forward over ``images`` frames of ``h x w`` (``[images, h, w, 3]``
    in): ``kind`` and its shapes."""
    tensors = {k: torch.empty(v.shape, dtype=torch.float32, device="meta",
                              requires_grad=v.requires_grad)
               for k, v in net.named_parameters()}
    tensors.update({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in net.named_buffers()})
    calls = []

    def hook(mod, inputs, out):
        x = inputs[0]
        if isinstance(mod, nn.Linear):
            calls.append({"kind": "linear", "input": tuple(x.shape),
                          "weight": tuple(mod.weight.shape),
                          "output": tuple(out.shape),
                          "dgrad": bool(x.requires_grad)})
        elif isinstance(mod, nn.ConvTranspose2d):
            calls.append({"kind": "conv_transpose", "input": tuple(x.shape),
                          "weight": tuple(mod.weight.shape),
                          "output": tuple(out.shape),
                          "groups": mod.groups,
                          "dgrad": bool(x.requires_grad)})
        else:
            b, n, c = x.shape
            calls.append({"kind": "attention", "batch": b, "tokens": n,
                          "heads": mod.num_heads,
                          "head_dim": c // mod.num_heads})

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Linear, nn.ConvTranspose2d))
               or hasattr(m, "num_heads")]
    try:
        with torch.enable_grad():
            functional_call(net, tensors, (torch.empty(
                images, h, w, 3, device="meta"),))
    finally:
        for handle in handles:
            handle.remove()
    return calls


def flops(c: Dict) -> int:
    """One forward pass of the call."""
    if c["kind"] == "linear":
        rows = math.prod(c["input"][:-1])
        return 2 * rows * c["weight"][1] * c["weight"][0]
    if c["kind"] == "conv_transpose":
        n, cin, h, w = c["input"]
        _, cout_g, kh, kw = c["weight"]
        return 2 * n * h * w * cin * cout_g * kh * kw
    b, n, heads, d = (c[k] for k in ("batch", "tokens", "heads",
                                     "head_dim"))
    return 2 * 2 * b * heads * n * n * d


def work(calls: List[Dict], dtype: str) -> Dict[str, float]:
    """FLOPs and bytes of a main step's calls, forward and backward."""
    e = workcount.ELEMENT_BYTES[dtype]
    total_flops = total_bytes = 0
    for c in calls:
        f = flops(c)
        if c["kind"] == "attention":
            qkvo = c["batch"] * c["heads"] * c["tokens"] * c["head_dim"]
            total_flops += 3 * f
            total_bytes += e * (4 * qkvo + 8 * qkvo)
            continue
        x, wt, y = (math.prod(c[k]) for k in ("input", "weight", "output"))
        total_flops += 2 * f + (f if c["dgrad"] else 0)
        total_bytes += e * ((x + wt + y) + (x + y + wt)
                            + ((y + wt + x) if c["dgrad"] else 0))
    return {"flops": float(total_flops), "bytes": float(total_bytes)}


@functools.lru_cache(maxsize=None)
def cell_work(workload: str = WORKLOAD):
    """``(convolutions, the rest)``: a main step's work in the cell at its
    traffic's shapes, each ``{'flops', 'bytes'}``."""
    cell = spec.load_cell(workload)
    tr = cell.traffic
    with torch.device("meta"):
        net = cell.build_reference(cell.config)
    images, hw = 2 * tr["batch_size"], (tr["height"], tr["width"])
    return (workcount.conv_work(workcount.conv_shapes(net, images, *hw),
                                tr["precision"]),
            work(shapes(net, images, *hw), tr["precision"]))


def full_depth_work(run) -> Optional[Dict[str, float]]:
    """``run.depth_work`` with the rest of the DPT's work added, or
    ``None`` where the run's convolutions are not ``WORKLOAD``'s."""
    convs, rest = cell_work()
    if run.depth_work != convs:
        return None
    return {k: run.depth_work[k] + rest[k] for k in ("flops", "bytes")}
