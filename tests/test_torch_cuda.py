"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances are relative to the largest reference value: the warp forward
differs from its plain version only by FMA contraction; the warp backward
adds in atomic order; the MLP and the chain sum over points in another
order; the loss kernel is built without FMA contraction, so per pixel it
matches its plain version and only the order of the global sums differs.
"""

import pytest
import torch

from dynamic_video_depth_tpu_torch.ops.cuda import (chain_kernel, loss_kernel,
                                                  mlp_kernel, warp_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("c", [3, 4])
def test_warp_kernel_matches_plain(dev, c):
    gen = torch.Generator().manual_seed(c)
    src = torch.randn(1, 224, 384, c, generator=gen).to(dev)
    flow = (60.0 * torch.randn(1, 224, 384, 2, generator=gen)).to(dev)
    g = torch.randn(1, 224, 384, c, generator=gen).to(dev)
    s = src.clone().requires_grad_(True)
    ref = warp_kernel.backward_warp_plain(s, flow)
    (ref * g).sum().backward()
    warp_kernel.reset_launches()
    out = warp_kernel.backward_warp(src.clone().requires_grad_(True), flow)
    assert _rel(out, ref) <= 1e-6
    assert _rel(warp_kernel.warp_backward_cuda(g, flow), s.grad) <= 1e-5
    assert warp_kernel.launches["warp_fwd"] == 1


@pytest.mark.parametrize("n,width,layers,nfx,nft", [
    (86016, 256, 4, 16, 16), (1000, 256, 4, 16, 16), (777, 32, 2, 4, 2)])
def test_mlp_kernel_matches_plain(dev, n, width, layers, nfx, nft):
    from dynamic_video_depth_tpu_torch.models import SceneFlowFieldNet

    gen = torch.Generator().manual_seed(n)
    net = SceneFlowFieldNet(time_dependent=True, n_freq_xyz=nfx, n_freq_t=nft,
                            net_width=width, n_layers=layers, generator=gen)
    params = [p.detach().to(dev) for l in net.convs
              for p in (l.conv.weight, l.conv.bias)]
    pts = torch.randn(n, 3, generator=gen).to(dev)
    ts = torch.rand(n, 1, generator=gen).to(dev)
    g = torch.randn(n, 3, generator=gen).to(dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (pts, ts, *params)]
        out = fn(leaves[0], leaves[1], leaves[2::2], leaves[3::2],
                 nfx, nft, True)
        (out * g).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    mlp_kernel.reset_launches()
    got = run(mlp_kernel.mlp_embed)
    want = run(mlp_kernel.mlp_embed_plain)
    assert mlp_kernel.launches == {"mlp_fwd": 1, "mlp_bwd": 1}
    assert _rel(got[0], want[0]) <= 1e-4
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) <= 1e-3



@pytest.mark.parametrize("n,n_steps,n_evals", [
    (86016, 2, 2), (86016, 8, 8), (777, 1, 2), (777, 3, 4), (86016, 1, 2),
    (86016, 4, 4)])
def test_chain_kernel_matches_plain(dev, n, n_steps, n_evals):
    from dynamic_video_depth_tpu_torch.models import SceneFlowFieldNet

    gen = torch.Generator().manual_seed(n + n_evals)
    net = SceneFlowFieldNet(time_dependent=True, n_freq_xyz=16, n_freq_t=16,
                            net_width=256, n_layers=4, generator=gen)
    ws = [l.conv.weight.detach().to(dev) for l in net.convs]
    bs = [l.conv.bias.detach().to(dev) for l in net.convs]
    pts = torch.cat([2.0 * torch.rand(n, 2, generator=gen) - 1.0,
                     2.0 + 2.0 * torch.rand(n, 1, generator=gen)], 1).to(dev)
    ts = torch.rand(n, 1, generator=gen).to(dev)
    dt = torch.full((n, 1), 0.05).to(dev)
    gs = [torch.randn(n, 3, generator=gen).to(dev) for _ in range(3)]

    def run(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (pts, ts, dt, *ws, *bs)]
        outs = fn(leaves[0], leaves[1], leaves[2], leaves[3:9], leaves[9:],
                  16, 16, True, n_steps, n_evals, 100.0)
        sum((o * g).sum() for o, g in zip(outs, gs)).backward()
        return [o.detach() for o in outs] + [t.grad for t in leaves]

    chain_kernel.reset_launches()
    mlp_kernel.reset_launches()
    got = run(chain_kernel.mlp_embed_chain)
    assert chain_kernel.launches == {"chain_bwd": 1}
    assert mlp_kernel.launches == {"mlp_fwd": n_evals, "mlp_bwd": 0}
    want = run(chain_kernel.chain_plain)
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= 1e-4
    for a, b in zip(got[3:], want[3:]):
        assert _rel(a, b) <= 1e-5


def _loss_inputs(dev, b, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    gp1 = torch.randn(b, h, w, 3, generator=gen) * 0.5
    gp1[..., 2] += 3.0
    w3 = torch.randn(b, h, w, 3, generator=gen) * 0.5
    w3[..., 2] += 3.0
    sf = torch.randn(b, h, w, 3, generator=gen) * 0.05
    gp1[:, :8, :8, 2] = -5.0           # behind camera 2: dead pixels
    sf[:, :8, :8, 2] = 0.0
    w3[:, 8:12, :16, 2] = torch.rand(b, 4, 16, generator=gen) * 1e-3
    w3[:, 20:24, 20:40, 2] = 150.0     # far field
    flow = torch.randn(b, h, w, 2, generator=gen) * 2.0
    mask = torch.rand(b, h, w, generator=gen)
    depth = torch.rand(b, h, w, generator=gen) * 5.0 + 0.5
    depth[:, 30:34, :50] = 120.0
    cam = torch.zeros(b, 24)
    cam[:, 0:9] = torch.eye(3).reshape(9)
    cam[:, 9:12] = torch.randn(b, 3, generator=gen) * 0.1
    cam[:, 12:21] = torch.tensor([0.8 * w, 0, w / 2, 0, 0.8 * w, h / 2,
                                  0, 0, 1.0])
    return [t.to(dev) for t in (gp1, w3, sf, flow, mask, depth, cam)]


@pytest.mark.parametrize("h,w", [(224, 384), (320, 576)])
@pytest.mark.parametrize("use_disp,use_disp_ratio,midas,warm", [
    (True, False, True, False), (True, False, True, True),
    (False, True, False, False), (False, False, False, False)])
def test_loss_kernel_matches_plain(dev, h, w, use_disp, use_disp_ratio,
                                   midas, warm):
    args = _loss_inputs(dev, 1, h, w, seed=h)
    flags = (use_disp, use_disp_ratio, midas, warm)
    cot = (torch.randn(4, generator=torch.Generator().manual_seed(1))
           / (h * w)).to(dev)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in args[:3]]
        sums = fn(*leaves, *args[3:], *flags)
        (sums * cot).sum().backward()
        return [sums.detach()] + [t.grad for t in leaves]

    loss_kernel.reset_launches()
    got = run(loss_kernel.projection_loss)
    assert loss_kernel.launches == {"loss_fwd": 1, "loss_bwd": 1}
    want = run(loss_kernel.projection_loss_plain)
    # each of the four sums on its own: they span five orders of magnitude
    assert ((got[0] - want[0]).abs()
            / want[0].abs().clamp_min(1e-30)).max() <= 1e-5
    for a, b in zip(got[1:], want[1:]):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= 1e-5
