"""The depth heads' first convolution (``models/midas.py::HeadConv2d``) and
its kernel's wrapper (``ops/cuda/head_conv_kernel.py``) on the CPU: the
module is ``nn.Conv2d`` bit for bit here, the autograd Function's backward
is the convolution's own, the nets keep their checkpoint keys and their
work counts, and only a float32 CUDA input is routed to the kernel (the
routing with a stand-in library, as ``test_torch_package.py`` does). The
kernel itself is held on the card in ``test_torch_cuda.py``."""

import os

import pytest
import torch
from torch import nn
from torch.func import functional_call

from benchmark import spec, workcount
from dynamic_video_depth_tpu_torch.models import DPTDepthNet, MidasNet
from dynamic_video_depth_tpu_torch.models import midas
from dynamic_video_depth_tpu_torch.ops.cuda import head_conv_kernel as hk

from test_torch_dpt import TINY, config, port_net, reference_module
from test_torch_package import _FakeLib, _pretend_cuda
from torch_threads import one_torch_thread  # noqa: F401


def _pair(cin=16, cout=128, seed=0):
    """A ``HeadConv2d`` and an ``nn.Conv2d`` with the same weights."""
    g = torch.Generator().manual_seed(seed)
    head, plain = midas.HeadConv2d(cin, cout), nn.Conv2d(cin, cout, 3,
                                                          padding=1)
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=g))
        head.bias.copy_(torch.randn(head.bias.shape, generator=g))
    plain.load_state_dict(head.state_dict())
    return head, plain


@pytest.mark.parametrize("shape", [(2, 16, 12, 20), (1, 16, 7, 9)])
def test_module_equals_conv2d_bit_for_bit_on_the_cpu(shape):
    head, plain = _pair(cin=shape[1])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g)
    cot = torch.randn(shape[0], 128, *shape[2:], generator=g)
    outs = []
    for m in (head, plain):
        xi = x.clone().requires_grad_(True)
        y = m(xi)
        (y * cot).sum().backward()
        outs.append((y.detach(), xi.grad, m.weight.grad, m.bias.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert hk.launches["head_conv_fwd"] == 0


@pytest.mark.parametrize("bias", [True, False])
def test_function_backward_passes_gradcheck(monkeypatch, bias):
    """``HeadConvFn`` fed the plain forward: its backward
    (``aten.convolution_backward``) is the forward's derivative in
    float64."""
    monkeypatch.setattr(hk, "head_conv_forward_cuda", hk.head_conv_plain)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 5, 6, dtype=torch.float64, generator=g)
    w = torch.randn(4, 3, 3, 3, dtype=torch.float64, generator=g)
    b = torch.randn(4, dtype=torch.float64, generator=g) if bias else None
    args = [t.requires_grad_(True) for t in (x, w, b) if t is not None]
    assert torch.autograd.gradcheck(
        lambda *a: hk.HeadConvFn.apply(*(a if bias else (*a, None))), args)


def test_float32_cuda_input_routes_to_the_kernel(monkeypatch):
    """A float32 input on a (stand-in) CUDA device launches the kernel once
    a forward, whose backward is the convolution's own; the plain version
    is never taken. The output keeps the input's memory order, and the
    variants name the path: 16-byte copies of NCHW rows whose width is a
    multiple of 4, 4-byte ones otherwise, channels-last."""
    lib = _FakeLib()
    plain = _pretend_cuda(monkeypatch, hk, lib)
    monkeypatch.setattr(hk, "head_conv_plain", plain)
    monkeypatch.setattr(nn.Conv2d, "forward", plain)
    hk.reset_launches()
    head, _ = _pair()
    x = torch.randn(2, 16, 6, 8, requires_grad=True)
    head(x).sum().backward()
    head(torch.randn(1, 16, 5, 7))
    y = head(torch.randn(1, 16, 5, 7).to(memory_format=torch.channels_last))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert lib.calls == ["dvd_head_conv_fwd"] * 3
    assert [a[-2] for a in lib.args] == [0, 0, 1]  # the channels-last flag
    assert hk.launches == {"head_conv_fwd": 3}
    assert hk.variants == {("head_conv_fwd", "nchw4"): 1,
                           ("head_conv_fwd", "nchw1"): 1,
                           ("head_conv_fwd", "nhwc"): 1}
    assert x.grad is not None and head.weight.grad is not None \
        and head.bias.grad is not None
    hk.reset_launches()
    assert hk.launches == {"head_conv_fwd": 0} and not hk.variants


def test_bf16_functional_call_takes_conv2d(monkeypatch):
    """The bfloat16 depth compute (``functional_call`` on bfloat16 copies,
    as ``train/step.py::_depth_fn``) takes ``F.conv2d`` even on a CUDA
    device: no launch, and the result of a plain head bit for bit."""
    lib = _FakeLib()
    _pretend_cuda(monkeypatch, hk, lib)
    hk.reset_launches()
    head = midas.output_head(16, 128, nn.ReLU())
    plain = nn.Sequential(nn.Conv2d(16, 128, 3, padding=1), *head[1:])
    plain.load_state_dict(head.state_dict())
    g = torch.Generator().manual_seed(3)
    state = {k: torch.randn(v.shape, generator=g).to(torch.bfloat16)
             for k, v in head.state_dict().items()}
    x = torch.randn(1, 16, 6, 8, generator=g).to(torch.bfloat16)
    got = functional_call(head, state, (x,))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, functional_call(plain, state, (x,)))
    assert lib.calls == [] and hk.launches == {"head_conv_fwd": 0}


@pytest.mark.parametrize("what", ["device", "dtype", "contiguous", "cin",
                                  "cout", "weight", "bias"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(monkeypatch, what):
    lib = _FakeLib()
    x = torch.randn(1, 16, 5, 7)
    w = torch.randn(128, 16, 3, 3)
    b = torch.randn(128)
    if what == "device":
        error = RuntimeError  # the real device check: CPU tensors
    else:
        _pretend_cuda(monkeypatch, hk, lib)
        error = {"dtype": TypeError}.get(what, ValueError)
        if what == "dtype":
            x = x.double()
        elif what == "contiguous":
            x = torch.randn(1, 16, 7, 5).transpose(2, 3)
        elif what == "cin":
            x, w = torch.randn(1, 12, 5, 7), torch.randn(128, 12, 3, 3)
        elif what == "cout":
            w, b = torch.randn(64, 16, 3, 3), torch.randn(64)
        elif what == "weight":
            w = torch.randn(128, 16, 1, 1)
        else:
            b = torch.randn(127)
    with pytest.raises(error):
        hk.head_conv_forward_cuda(x, w, b)
    assert lib.calls == []


def _midas_reference(**over):
    cfg = dict(spec.load_json(os.path.join(spec.HERE, "configs",
                                           "midas_v2.json")), **over)
    return spec.load_module(os.path.join(spec.HERE, "configs",
                                         "midas_v2.py"),
                            "bench_ref_midas").build(cfg)


def test_state_dicts_keep_their_keys():
    """At full width the port's nets hold the keys and shapes of the plain
    references, whose heads are ``nn.Conv2d``."""
    with torch.device("meta"):
        pairs = [(MidasNet(), _midas_reference()),
                 (DPTDepthNet(), reference_module().build(config()))]
    for port, ref in pairs:
        assert {k: v.shape for k, v in port.state_dict().items()} == \
            {k: v.shape for k, v in ref.state_dict().items()}
        assert isinstance(port.scratch.output_conv[0], midas.HeadConv2d)
    keys = set(pairs[0][0].state_dict())
    assert {"scratch.output_conv.0.weight", "scratch.output_conv.0.bias"} \
        <= keys


def test_files_saved_with_plain_heads_load(tmp_path):
    """A file written by a net whose head is ``nn.Conv2d`` loads strictly
    into the port's (MiDaS's decoder at width 32, the tiny DPT) and gives
    the same head output bit for bit."""
    torch.manual_seed(4)
    cases = [(midas._Scratch(32, True, False),
              _midas_reference(features=32).scratch, 32),
             (port_net(config(**TINY)), reference_module().build(
                 config(**TINY)), TINY["features"])]
    for port, old, features in cases:
        path = str(tmp_path / "old.pt")
        torch.save(old.state_dict(), path)
        port.load_state_dict(torch.load(path, weights_only=True))
        x = torch.randn(1, features, 6, 8)
        head = port.output_conv if hasattr(port, "output_conv") \
            else port.scratch.output_conv
        want = old.output_conv if hasattr(old, "output_conv") \
            else old.scratch.output_conv
        with torch.no_grad():
            assert torch.equal(head(x), want(x))


def test_work_count_finds_every_convolution():
    """``workcount.conv_shapes`` (forward hooks on ``nn.Conv2d``, the
    ``meta`` device) finds the same convolutions in the port's nets as in
    the plain references."""
    with torch.device("meta"):
        pairs = [(MidasNet(), _midas_reference()),
                 (DPTDepthNet(), reference_module().build(config()))]
    for port, ref in pairs:
        got = workcount.conv_shapes(port, 2, 224, 384)
        assert got == workcount.conv_shapes(ref, 2, 224, 384)
        assert {"input": (2, 256, 112, 192), "weight": (128, 256, 3, 3),
                "output": (2, 128, 112, 192), "kernel": (3, 3), "groups": 1,
                "dgrad": True} in got
