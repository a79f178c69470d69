"""The depth heads' first convolution: float32 3x3, stride 1, padding 1,
with bias, forward only.

Replaces no TPU kernel (the JAX package leaves the convolution to XLA). The
CUDA source is ``csrc/head_conv.cu``: it exists because cuDNN's float32
pick for the heads' shape (256 -> 128 at 112x192, TF32 off) is its FFT
route, ~1,100x slower than the convolution's FMA bound. The plain version,
``head_conv_plain``, is ``F.conv2d``.

Dispatch (``models/midas.py::HeadConv2d``): a float32 CUDA tensor goes
through ``HeadConvFn``, which launches the kernel or raises; any other
tensor, the CPU's among them, takes the plain version. There is no other
route. ``HeadConvFn``'s backward is the convolution's own
(``aten.convolution_backward`` with the arguments autograd's
``ConvolutionBackward0`` passes), so only the forward changes.

The kernel takes float32 ``[N, C, H, W]`` tensors as they lie, contiguous
or channels-last (the nets' own order: their stem takes a permuted NHWC
image and cuDNN keeps it), ``Cin`` a multiple of ``CIN_CHUNK`` and ``Cout``
of ``COUT_TILE``, and any N, H and W; its output has the input's memory
order, as ``nn.Conv2d``'s. Variants: channels-last (``"nhwc"``, 4-byte
copies), contiguous with a width that is a multiple of 4 and a 16-byte
aligned input (``"nchw4"``, 16-byte copies), other contiguous inputs
(``"nchw1"``, 4-byte copies).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

LIBRARY = "dvd_head_conv"
SOURCES = ("head_conv.cu",)
FLAGS = ()
REPLACES = None  # no TPU kernel: the JAX package leaves it to XLA
CIN_CHUNK = 8    # input channels a stage of the kernel
COUT_TILE = 128  # output channels of a block
_F32 = torch.float32
_LIB = None
# launches since the last reset, and the same launches by variant
launches = {"head_conv_fwd": 0}
variants = collections.Counter()


def reset_launches() -> None:
    launches["head_conv_fwd"] = 0
    variants.clear()


def device_type(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else t.device.type


def stream_handle(index: int) -> int:
    """The current CUDA stream of device ``index``, as an integer."""
    return torch._C._cuda_getCurrentRawStream(index)


def head_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor]) -> torch.Tensor:
    return F.conv2d(x, w, b, padding=1)


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load_library(LIBRARY, SOURCES, FLAGS)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvd_head_conv_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.dvd_head_conv_fwd.restype = i
        _LIB = lib
    return _LIB


def channels_last(x: torch.Tensor) -> bool:
    """Whether the kernel reads ``x`` as channels-last (NHWC in memory)."""
    return not x.is_contiguous() and \
        x.is_contiguous(memory_format=torch.channels_last)


def variant(x: torch.Tensor) -> str:
    """The kernel's path for ``x``, as it decides."""
    if channels_last(x):
        return "nhwc"
    return "nchw4" if x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0 \
        else "nchw1"


def _checked(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor]) -> tuple:
    """``(N, Cin, H, W, Cout, device index)`` of ``x [N,Cin,H,W]``
    (contiguous or channels-last), ``w [Cout,Cin,3,3]`` and ``b [Cout]`` (or
    None, both contiguous), float32 and on one CUDA device, with the channel
    counts the kernel takes; raises otherwise."""
    tensors = (x, w) if b is None else (x, w, b)
    for t in tensors:
        if device_type(t) != "cuda":
            raise RuntimeError(f"head conv kernel: a tensor is on {t.device}, "
                               "not a CUDA device")
        if t.dtype != _F32:
            raise TypeError(f"head conv kernel: needs float32, got {t.dtype}")
    index = x.get_device()
    if any(t.get_device() != index for t in tensors):
        raise RuntimeError("head conv kernel: tensors on different devices")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"head conv kernel: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} are not [N,Cin,H,W] / "
                         "[Cout,Cin,3,3]")
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    if b is not None and b.shape != (cout,):
        raise ValueError(f"head conv kernel: bias {tuple(b.shape)} is not "
                         f"[{cout}]")
    if cin % CIN_CHUNK or cout % COUT_TILE:
        raise ValueError(f"head conv kernel: takes Cin a multiple of "
                         f"{CIN_CHUNK} and Cout of {COUT_TILE}, got {cin} -> "
                         f"{cout}")
    if not (x.is_contiguous() or channels_last(x)) or not all(
            t.is_contiguous() for t in tensors[1:]):
        raise ValueError("head conv kernel: needs a contiguous or "
                         "channels-last x and a contiguous w and b")
    return n, cin, h, wd, cout, index


def head_conv_forward_cuda(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on the current stream: ``[N, Cout, H, W]``."""
    n, cin, h, wd, cout, index = _checked(x, w, b)
    nhwc = channels_last(x)
    y = torch.empty((n, cout, h, wd), device=x.device, dtype=_F32,
                    memory_format=torch.channels_last if nhwc
                    else torch.contiguous_format)
    rc = _lib().dvd_head_conv_fwd(x.data_ptr(), w.data_ptr(),
                                  None if b is None else b.data_ptr(),
                                  y.data_ptr(), n, cin, h, wd, cout,
                                  int(nhwc), stream_handle(index))
    if rc:
        build.check(rc, "dvd_head_conv_fwd")
    launches["head_conv_fwd"] += 1
    variants["head_conv_fwd", variant(x)] += 1
    return y


class HeadConvFn(torch.autograd.Function):
    """The kernel's forward; the backward of ``F.conv2d(x, w, b,
    padding=1)``."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bias_sizes = None if b is None else [b.shape[0]]
        return head_conv_forward_cuda(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return torch.ops.aten.convolution_backward(
            g, x, w, ctx.bias_sizes, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad))
