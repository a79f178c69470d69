"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``dynamic_video_depth_tpu_torch.ops.cuda`` runs
its plain PyTorch version; the JAX side runs its Pallas kernel in interpret
mode, as the JAX package's own tests do. Inputs come from numpy with a
seed.

The MLP kernels' arithmetic on the card (3xTF32 tensor-core products) is
emulated here in torch and held against the JAX package, and the
leaky-relu flip mask of the card's gradient checks is tested."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from chip_smoke import FLIP_TAU, chain_features, flip_points, zero_rows
from dynamic_video_depth_tpu.ops import embedding as jax_embedding
from dynamic_video_depth_tpu.ops.pallas.mlp_kernel import fused_mlp_embed
from dynamic_video_depth_tpu.ops.pallas.warp_kernel import fused_backward_warp
from dynamic_video_depth_tpu_torch.ops import embedding
from dynamic_video_depth_tpu_torch.ops.cuda import (chain_kernel, loss_kernel,
                                                  mlp_kernel, warp_kernel)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("c", [3, 4])
def test_warp_matches_pallas_warp(rng, c):
    """Value and source gradient at 20x24 with flows past every border."""
    src = rng.randn(1, 20, 24, c).astype(np.float32)
    flow = (rng.randn(1, 20, 24, 2) * 6.0).astype(np.float32)
    g = rng.randn(1, 20, 24, c).astype(np.float32)

    def loss(s):
        return jnp.sum(fused_backward_warp(s, jnp.asarray(flow), None) * g)

    ref = fused_backward_warp(jnp.asarray(src), jnp.asarray(flow), None)
    ref_dsrc = jax.grad(loss)(jnp.asarray(src))

    src_t = torch.from_numpy(src).requires_grad_(True)
    out = warp_kernel.backward_warp(src_t, torch.from_numpy(flow))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(src_t.grad.numpy(), np.asarray(ref_dsrc),
                               rtol=1e-5, atol=1e-5)


def _emulated_warp_grad(g, flow):
    """The warp backward as the CUDA kernel decomposes it, in plain torch:
    the output cut into the rows of ``TILE`` tiles (a warp each), each
    row's window placed by ``window_plan``, every tap added into its row's
    window when it lands there (and the row uses its window) and into the
    image otherwise, then every window added into the image. Returns the
    gradient and the share of taps in a window."""
    b, h, w, c = g.shape
    tile_x, win_x = warp_kernel.TILE[0], warp_kernel.WINDOW[0]
    rows = warp_kernel.window_rows(c)
    org, steps = warp_kernel.window_plan(flow, c)  # [B, H, tiles_x, ...]
    xs, ys = torch.arange(w), torch.arange(h)[:, None]
    bi, ti, tj = torch.broadcast_tensors(torch.arange(b)[:, None, None], ys,
                                         xs // tile_x)
    ox, oy, used = org[bi, ti, tj, 0], org[bi, ti, tj, 1], steps[bi, ti, tj] > 0
    x = (xs + flow[..., 0]).clamp(0.0, w - 1.0)
    y = (ys + flow[..., 1]).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    windows = torch.zeros(b, *org.shape[1:3], rows, win_x, c, dtype=g.dtype)
    image = torch.zeros(b, h, w, c, dtype=g.dtype)
    inside_taps = 0
    for iy, wy in ((y0, 1.0 - fy), ((y0 + 1).clamp(max=h - 1), fy)):
        for ix, wx in ((x0, 1.0 - fx), ((x0 + 1).clamp(max=w - 1), fx)):
            v = (g * wy) * wx
            lx, ly = ix - ox, iy - oy
            inside = used & (lx >= 0) & (lx < win_x) & (ly >= 0) & (ly < rows)
            inside_taps += int(inside.sum())
            windows.index_put_((bi[inside], ti[inside], tj[inside],
                                ly[inside], lx[inside]), v[inside],
                               accumulate=True)
            out = ~inside
            image.index_put_((bi[out], iy[out], ix[out]), v[out],
                             accumulate=True)
    # the flush: each window cell that lies in the image adds into it
    wb, gy, gx = torch.broadcast_tensors(
        torch.arange(b)[:, None, None, None, None],
        org[..., 1, None, None] + torch.arange(rows)[:, None],
        org[..., 0, None, None] + torch.arange(win_x))
    keep = (gy < h) & (gx < w)
    assert not windows[~keep].any()  # no tap lands off the image
    image.index_put_((wb[keep], gy[keep], gx[keep]), windows[keep],
                     accumulate=True)
    return image, inside_taps / (4 * b * h * w)


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("h,w", [(37, 53), (64, 96)])
@pytest.mark.parametrize("kind", ["smooth", "random", "alternating150",
                                  "alternating12"])
def test_warp_window_decomposition_is_exact(rng, kind, h, w, c):
    """The kernel's row / window / straight-to-the-image split of the
    backward adds up to the plain warp's gradient for any flow: the
    synthetic track's gap-2 flow (most taps in a window), the random +-60
    px flow and 0 / +150 px alternating between columns (at these widths
    every row falls back: its targets may collide, or a tap is clamped at
    the border), and 0 / +12 px alternating (rows in two steps, taps both
    in and out of their window)."""
    from chip_smoke import random_flow, track_flows

    b = 2
    if kind == "smooth":
        flow = track_flows(h, w, 2, n=b)
    elif kind == "random":
        flow = random_flow(b, h, w, seed=h)
    else:
        flow = torch.zeros(b, h, w, 2)
        flow[..., 0] = float(kind[len("alternating"):]) * (torch.arange(w) % 2)
    # float64 sums on both sides: the check is of the split, not of the
    # order of float32 additions (the flow stays float32, as the kernel's)
    g = torch.from_numpy(rng.randn(b, h, w, c))
    src = torch.zeros(b, h, w, c, dtype=torch.float64, requires_grad=True)
    (warp_kernel.backward_warp_plain(src, flow) * g).sum().backward()
    got, share = _emulated_warp_grad(g, flow)
    err = (got - src.grad).abs().max() / src.grad.abs().max()
    assert err <= 1e-6
    assert {"smooth": share > 0.5, "random": share < 0.5,
            "alternating150": share < 0.5,
            "alternating12": 0.2 < share < 0.8}[kind], share


def test_embedded_mlp_matches_pallas_mlp(rng):
    """fused_mlp_embed at N=1000, width 256: value, dpts, dts, dW, db."""
    n, dims = 1000, [132, 256, 256, 256, 256, 256, 3]
    pts = rng.randn(n, 3).astype(np.float32)
    ts = rng.rand(n, 1).astype(np.float32)
    # the step's cotangent reaches the field through sf / sf_mag_div (100)
    g = (rng.randn(n, 3) / 100.0).astype(np.float32)
    ws = [(rng.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.randn(b) * 0.01).astype(np.float32) for b in dims[1:]]
    consts = [jnp.asarray(c) for c in
              jax_embedding.sceneflow_embed_consts(16, 16, True)]

    def loss(p, t, w, b):
        return jnp.sum(fused_mlp_embed(p, t, *consts, tuple(w), tuple(b)) * g)

    args = (jnp.asarray(pts), jnp.asarray(ts),
            [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    ref = fused_mlp_embed(args[0], args[1], *consts, tuple(args[2]),
                          tuple(args[3]))
    ref_grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)

    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (pts, ts, *[w.T.copy() for w in ws], *bs)]
    out = mlp_kernel.mlp_embed(leaves[0], leaves[1], leaves[2:8], leaves[8:],
                               16, 16, True)
    (out * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(leaves[0].grad.numpy(),
                               np.asarray(ref_grads[0]), **tol)
    np.testing.assert_allclose(leaves[1].grad.numpy(),
                               np.asarray(ref_grads[1]), **tol)
    for i in range(6):
        np.testing.assert_allclose(leaves[2 + i].grad.numpy().T,
                                   np.asarray(ref_grads[2][i]), **tol)
        np.testing.assert_allclose(leaves[8 + i].grad.numpy(),
                                   np.asarray(ref_grads[3][i]), **tol)


@pytest.mark.parametrize("nfx,nft,td", [(16, 16, True), (4, 2, True),
                                        (3, 0, False)])
def test_embed_consts_bit_equal(nfx, nft, td):
    ours = embedding.sceneflow_embed_consts(nfx, nft, td)
    ref = jax_embedding.sceneflow_embed_consts(nfx, nft, td)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if (nfx, nft, td) == (16, 16, True):
        assert ours[0].shape == (3, 132)


def test_sceneflow_features_match(rng):
    pts = rng.randn(2, 5, 7, 3).astype(np.float32)
    ts = rng.rand(2, 5, 7, 1).astype(np.float32)
    ref = jax_embedding.sceneflow_features(jnp.asarray(pts), jnp.asarray(ts),
                                           16, 16, True)
    ours = embedding.sceneflow_features(torch.from_numpy(pts),
                                        torch.from_numpy(ts), 16, 16, True)
    assert ours.shape == (2, 5, 7, 132)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


# freqs 4/2 (C0 = 27 + 5), width 32, 2 layers
CHAIN_DIMS = [3 * (1 + 2 * 4) + (1 + 2 * 2), 32, 32, 32, 3]


def _chain_parity(rng, n_steps, n_evals, monkeypatch=None):
    """fused_mlp_embed_chain at N=600, width 32, 2 layers, freqs 4/2, and
    the port's chain: the three outputs, and dpts, dts, ddt, dW, db from
    random cotangents, zeroed at the flip-mask points. Given
    ``monkeypatch``, the port's chain takes the other leaky-relu slope at
    every pre-activation that the mask covers, as another summation order
    may."""
    from dynamic_video_depth_tpu.ops.pallas.mlp_kernel import (
        fused_mlp_embed_chain)

    n, dims, sf_div = 600, CHAIN_DIMS, 100.0
    pts = rng.randn(n, 3).astype(np.float32)
    ts = rng.rand(n, 1).astype(np.float32)
    dt = np.full((n, 1), 0.1, np.float32)
    ws = [(rng.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.randn(b) * 0.01).astype(np.float32) for b in dims[1:]]
    ws_t = [torch.from_numpy(w.T.copy()) for w in ws]
    bs_t = [torch.from_numpy(b) for b in bs]
    near = flip_points(chain_features(
        *map(torch.from_numpy, (pts, ts, dt)), ws_t, bs_t, 4, 2, True,
        n_evals, sf_div), ws_t, bs_t)
    gs = [g.numpy() for g in zero_rows(near, *(
        torch.from_numpy(rng.randn(n, 3).astype(np.float32))
        for _ in range(3)))]
    flipped = []
    if monkeypatch is not None:
        def leaky_flipped(x):
            close = x.abs() < FLIP_TAU * x.abs().max()
            flipped.append(int(close.sum()))
            return torch.where((x >= 0) != close, x, mlp_kernel.SLOPE * x)

        monkeypatch.setattr(mlp_kernel, "leaky", leaky_flipped)
    consts = [jnp.asarray(c) for c in
              jax_embedding.sceneflow_embed_consts(4, 2, True)]

    def loss(p, t, d, w, b):
        outs = fused_mlp_embed_chain(p, t, d, *consts, tuple(w), tuple(b),
                                     n_steps, n_evals, sf_div)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs)), outs

    args = (jnp.asarray(pts), jnp.asarray(ts), jnp.asarray(dt),
            [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    ref_grads, ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4),
                              has_aux=True)(*args)

    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (pts, ts, dt, *[w.T.copy() for w in ws], *bs)]
    nl = len(ws)
    outs = chain_kernel.mlp_embed_chain(
        leaves[0], leaves[1], leaves[2], leaves[3:3 + nl], leaves[3 + nl:],
        4, 2, True, n_steps, n_evals, sf_div)
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, gs)).backward()
    assert near.any() and (monkeypatch is None or sum(flipped) > 0)
    tol = dict(rtol=1e-4, atol=1e-6)
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), **tol)
    for i, name in enumerate(("dpts", "dts", "ddt")):
        np.testing.assert_allclose(leaves[i].grad.numpy(),
                                   np.asarray(ref_grads[i]), **tol,
                                   err_msg=name)
    for i in range(nl):
        np.testing.assert_allclose(leaves[3 + i].grad.numpy().T,
                                   np.asarray(ref_grads[3][i]), **tol,
                                   err_msg=f"dW{i}")
        np.testing.assert_allclose(leaves[3 + nl + i].grad.numpy(),
                                   np.asarray(ref_grads[4][i]), **tol,
                                   err_msg=f"db{i}")


@pytest.mark.parametrize("n_steps,n_evals", [(1, 2), (2, 2), (3, 3), (4, 4)])
def test_chain_matches_pallas_chain(rng, n_steps, n_evals):
    """fused_mlp_embed_chain at N=600, width 32, 2 layers, freqs 4/2: the
    three outputs, and dpts, dts, ddt, dW, db from random cotangents, zeroed
    at the flip-mask points. Unmasked, the gradients depend on the CPU's
    summation order: point 272 has a pre-activation at 2.4e-7 of its
    layer's max |z| in the first evaluation, and that one unit taking the
    other slope moves dW about 2,400x past the tolerance, while every other
    element stays within 0.12 of it."""
    _chain_parity(rng, n_steps, n_evals)


@pytest.mark.parametrize("n_steps,n_evals", [(2, 2), (4, 4)])
def test_masked_chain_matches_pallas_chain(rng, monkeypatch, n_steps,
                                           n_evals):
    """The mask makes the check immune to flips: with the other leaky-relu
    slope at every pre-activation it covers, the port's plain chain still
    matches the JAX package at the same tolerance."""
    _chain_parity(rng, n_steps, n_evals, monkeypatch)


def test_flip_points_marks_exactly_the_near_zero_points():
    """A hand-built stack 2 -> 2 -> 2 -> 1 (both hidden layers identity,
    the second with bias (-1, 0)): rows with a pre-activation within
    2e-6 * max |z| of 0 at either hidden layer are marked, no other, and
    their cotangents become exactly 0."""
    feat = torch.tensor([[1.0, 2.0],      # layer 2: 1 - 1 = 0
                         [1e-7, 3.0],     # layer 1: 1e-7 < 1e-5
                         [-2.0, 5.0],     # clear of 0 at both
                         [0.5, -1e-8],    # layer 1
                         [3.0, 4.0]])     # clear
    eye = torch.eye(2)
    ws = [eye, eye, torch.ones(1, 2)]
    bs = [torch.zeros(2), torch.tensor([-1.0, 0.0]), torch.zeros(1)]
    near = flip_points([feat], ws, bs)
    assert near.tolist() == [True, True, False, True, False]
    # a second evaluation marks its own rows too (the union)
    shifted = feat + torch.tensor([[0.0, 0.0]] * 4 + [[-3.0, 0.0]])
    assert flip_points([feat, shifted], ws, bs).tolist() == [
        True, True, False, True, True]
    g = torch.arange(10.0).reshape(5, 2) + 1.0
    masked, = zero_rows(near, g)
    assert (masked[near] == 0).all()
    assert torch.equal(masked[~near], g[~near])
    # a stack with no hidden layer marks nothing
    assert not flip_points([feat], ws[2:], bs[2:]).any()


# 3xTF32 on the card, emulated: TF32 keeps 10 mantissa bits; cvt.rna rounds
# to nearest with ties away from zero, which on the float's bits is adding
# half of the 13 dropped bits and clearing them.
def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _trunc32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mm_3xtf32_k8(a, b):
    """3xTF32 in the point tiles' order (csrc/mlp_tile.cuh): per k8 step
    the products lo*hi, hi*lo and hi*hi (each 8-term sum exact) go into a
    fresh accumulator that adds by truncation, as the tensor cores do, and
    the step's total reaches the float32 sum by one rounded add. All steps
    at once (few, large ops)."""
    pad = -a.shape[1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)

    def steps(x, y):  # [k8 steps, M, N]: each step's exact products
        return (x.double().unflatten(1, (-1, 8)).transpose(0, 1)
                @ y.double().unflatten(0, (-1, 8)))

    t = _trunc32(steps(al, bh))
    t = _trunc32(t.double() + steps(ah, bl))
    t = _trunc32(t.double() + steps(ah, bh))
    out = torch.zeros(a.shape[0], b.shape[1])
    for step in t:
        out = out + step
    return out


# the products of the point tiles (forward, dX) and of the dW pass
MM = {"3xtf32": (_mm_3xtf32, _mm_3xtf32), "tf32": (_mm_tf32, _mm_tf32),
      "3xtf32_k8": (_mm_3xtf32_k8, _mm_3xtf32)}


class _EmuLinear(torch.autograd.Function):
    """``x W^T + b`` whose three products run in the given emulated
    arithmetic, as the kernels run them: the forward and dX in ``mm`` (the
    point tiles), dW in ``mm_dw`` (the weight-gradient pass)."""

    @staticmethod
    def forward(ctx, x, w, b, mm, mm_dw):
        ctx.save_for_backward(x, w)
        ctx.mm, ctx.mm_dw = mm, mm_dw
        return mm(x, w.t()) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return ctx.mm(g, w), ctx.mm_dw(g.t(), x), g.sum(0), None, None


def _emu_field(mm, mm_dw=None):
    def field(pts, ts, weights, biases, nfx, nft, td):
        h = embedding.sceneflow_features(pts, ts, nfx, nft, td)
        for i, (w, b) in enumerate(zip(weights, biases)):
            h = _EmuLinear.apply(h, w, b, mm, mm_dw or mm)
            if i < len(weights) - 1:
                h = torch.where(h >= 0, h, 0.2 * h)
        return h
    return field


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


EMU_DIMS = [132, 256, 256, 256, 256, 256, 3]


@pytest.mark.parametrize("arith", ["3xtf32", "tf32", "3xtf32_k8"])
def test_tf32_split_emulation_matches_pallas_mlp(rng, arith):
    """The embedded MLP at the canonical widths, N = 2048, every product in
    emulated 3xTF32, against fused_mlp_embed: forward within 1e-4 and every
    gradient within 1e-5 of max |ref| (the card checks' tolerances, with
    their flip mask), also in the point tiles' order (a truncating
    accumulator per k8 step, promoted by a rounded add,
    ``_mm_3xtf32_k8``, for the forward and dX). Single-pass TF32 must miss
    the gradient tolerance."""
    n = 2048
    pts = rng.randn(n, 3).astype(np.float32)
    ts = rng.rand(n, 1).astype(np.float32)
    ws = [(rng.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(EMU_DIMS[:-1], EMU_DIMS[1:])]
    bs = [(rng.randn(b) * 0.01).astype(np.float32) for b in EMU_DIMS[1:]]
    ws_t = [torch.from_numpy(w.T.copy()) for w in ws]
    bs_t = [torch.from_numpy(b) for b in bs]
    near = flip_points([embedding.sceneflow_features(
        torch.from_numpy(pts), torch.from_numpy(ts), 16, 16, True)],
        ws_t, bs_t)
    g, = zero_rows(near, torch.from_numpy(
        (rng.randn(n, 3) / 100.0).astype(np.float32)))
    g = g.numpy()
    consts = [jnp.asarray(c) for c in
              jax_embedding.sceneflow_embed_consts(16, 16, True)]

    def loss(p, t, w, b):
        return jnp.sum(fused_mlp_embed(p, t, *consts, tuple(w), tuple(b)) * g)

    args = (jnp.asarray(pts), jnp.asarray(ts),
            [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    ref = fused_mlp_embed(args[0], args[1], *consts, tuple(args[2]),
                          tuple(args[3]))
    ref_grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)

    mm, mm_dw = MM[arith]
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (pts, ts, *[w.T.copy() for w in ws], *bs)]
    out = _emu_field(mm, mm_dw)(leaves[0], leaves[1], leaves[2:8],
                                leaves[8:], 16,
                         16, True)
    (out * torch.from_numpy(g)).sum().backward()
    fwd = _max_rel(out.detach(), ref)
    grads = [_max_rel(leaves[0].grad, ref_grads[0]),
             _max_rel(leaves[1].grad, ref_grads[1])]
    grads += [_max_rel(leaves[2 + i].grad.T, ref_grads[2][i])
              for i in range(6)]
    grads += [_max_rel(leaves[8 + i].grad, ref_grads[3][i])
              for i in range(6)]
    if arith != "tf32":
        assert fwd <= 1e-4
        assert max(grads) <= 1e-5, grads
    else:
        assert max(grads) > 1e-5, grads


def test_tf32_split_emulation_matches_pallas_chain(rng):
    """The Euler chain at (n_steps, n_evals) = (2, 2), the canonical widths,
    N = 2048, every product in emulated 3xTF32, against
    fused_mlp_embed_chain: values within 1e-5 and every gradient within
    1e-5 of max |ref|, with the flip mask on the cotangents."""
    _chain_emulation(rng, *MM["3xtf32"], 2, 2)


def test_tf32_k8_promotion_emulation_matches_pallas_chain(rng):
    """The chain as above with the point tiles' products (the recompute
    and dX) in their order: a truncating accumulator per k8 step, promoted
    by a rounded float32 add (``_mm_3xtf32_k8``); the same tolerances, at
    N = 512 (the order's emulation costs ~10x the plain one)."""
    _chain_emulation(rng, *MM["3xtf32_k8"], 2, 2, n=512)


def _chain_emulation(rng, mm, mm_dw, n_steps, n_evals, n=2048):
    from dynamic_video_depth_tpu.ops.pallas.mlp_kernel import (
        fused_mlp_embed_chain)

    sf_div = 100.0
    pts = np.concatenate([rng.rand(n, 2) * 2.0 - 1.0,
                          rng.rand(n, 1) * 2.0 + 2.0], 1).astype(np.float32)
    ts = rng.rand(n, 1).astype(np.float32)
    dt = np.full((n, 1), 1.0 / 6.0, np.float32)
    ws = [(rng.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(EMU_DIMS[:-1], EMU_DIMS[1:])]
    bs = [(rng.randn(b) * 0.01).astype(np.float32) for b in EMU_DIMS[1:]]
    ws_t = [torch.from_numpy(w.T.copy()) for w in ws]
    bs_t = [torch.from_numpy(b) for b in bs]
    near = flip_points(chain_features(
        *map(torch.from_numpy, (pts, ts, dt)), ws_t, bs_t, 16, 16, True,
        n_evals, sf_div), ws_t, bs_t)
    gs = [g.numpy() for g in zero_rows(near, *(
        torch.from_numpy(rng.randn(n, 3).astype(np.float32))
        for _ in range(3)))]
    consts = [jnp.asarray(c) for c in
              jax_embedding.sceneflow_embed_consts(16, 16, True)]

    def loss(p, t, d, w, b):
        outs = fused_mlp_embed_chain(p, t, d, *consts, tuple(w), tuple(b),
                                     n_steps, n_evals, sf_div)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gs)), outs

    args = (jnp.asarray(pts), jnp.asarray(ts), jnp.asarray(dt),
            [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    ref_grads, ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4),
                              has_aux=True)(*args)

    field = _emu_field(mm, mm_dw)
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (pts, ts, dt, *[w.T.copy() for w in ws], *bs)]
    p, t = leaves[0], leaves[1]
    acc = torch.zeros_like(p)
    outs = []
    for k in range(n_evals):
        sf = field(p, t, leaves[3:9], leaves[9:], 16, 16, True) / sf_div
        outs.append(sf)
        if k < n_steps:
            acc = acc + sf
        if k + 1 < n_evals:
            p, t = p + sf, t + leaves[2]
    outs = [acc] + outs
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, gs)).backward()
    for o, r in zip(outs, ref):
        assert _max_rel(o.detach(), r) <= 1e-5
    got = [leaves[i].grad for i in range(3)]
    got += [leaves[3 + i].grad.T for i in range(6)]
    got += [leaves[9 + i].grad for i in range(6)]
    want = [*ref_grads[:3], *ref_grads[3], *ref_grads[4]]
    errs = [_max_rel(a, b) for a, b in zip(got, want)]
    assert max(errs) <= 1e-5, errs


LOSS_VARIANTS = [
    dict(use_disp=True, use_disp_ratio=False, midas=True, warm=False),
    dict(use_disp=True, use_disp_ratio=False, midas=True, warm=True),
    dict(use_disp=False, use_disp_ratio=True, midas=False, warm=False),
    dict(use_disp=False, use_disp_ratio=False, midas=False, warm=False),
]


def _loss_inputs(rng, b=2, h=20, w=24):
    """World points a few metres out and a rotated camera 2, with a block of
    pixels behind the camera (z < 1e-3: dead), a block whose warped z is
    below the 1e-3 clip, and far-field pixels for the MiDaS masks."""
    def rot(a):
        c, s = np.cos(a), np.sin(a)
        return (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                @ np.array([[1, 0, 0], [0, c, s], [0, -s, c]]))

    gp1 = rng.randn(b, h, w, 3) * 0.5 + np.array([0, 0, 3.0])
    w3 = rng.randn(b, h, w, 3) * 0.5 + np.array([0, 0, 3.0])
    sf = rng.randn(b, h, w, 3) * 0.05
    gp1[:, :4, :4, 2] = -5.0
    sf[:, :4, :4, 2] = 0.0
    w3[:, 4:7, :5, 2] = rng.rand(b, 3, 5) * 1e-3 - 5e-4
    w3[:, 8:10, 10:14, 2] = 150.0
    depth_1 = rng.rand(b, h, w) * 5.0 + 0.5
    depth_1[:, 12:14, :6] = 120.0
    cam = np.zeros((b, 24))
    for i in range(b):
        cam[i, :9] = rot(0.1 * (i + 1)).reshape(9)
        cam[i, 9:12] = rng.randn(3) * 0.1
        cam[i, 12:21] = [50.0, 0, 12.0, 0, 50.0, 10.0, 0, 0, 1.0]
    arrays = (gp1, w3, sf, rng.randn(b, h, w, 2) * 2.0, rng.rand(b, h, w),
              depth_1, cam)
    return [np.asarray(a, np.float32) for a in arrays]


@pytest.mark.parametrize("variant", LOSS_VARIANTS)
def test_projection_loss_matches_pallas_loss(rng, variant):
    """fused_projection_loss at B=2, 20x24 (the JAX side pads it to 24x128):
    the four sums and the three gradients from a random cotangent."""
    from dynamic_video_depth_tpu.ops.pallas import fused_projection_loss

    arrays = _loss_inputs(rng)
    # the step's cotangent: the loss weights over the mask mass
    cot = (rng.randn(4) / arrays[4].size).astype(np.float32)
    flags = (variant["use_disp"], variant["use_disp_ratio"],
             variant["midas"], variant["warm"])

    def loss(gp1, w3, sf):
        sums = fused_projection_loss(gp1, w3, sf, *map(jnp.asarray,
                                                       arrays[3:]), *flags)
        return jnp.sum(sums * cot), sums

    ref_grads, ref = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, arrays[:3]))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    sums = loss_kernel.projection_loss(
        *leaves, *map(torch.from_numpy, arrays[3:]), *flags)
    (sums * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(ref), **tol)
    assert 0 < float(sums[3].detach()) < float(np.sum(arrays[4]))  # masks
    for name, leaf, r in zip(("gp1", "w3", "sf"), leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **tol,
                                   err_msg=name)
        assert np.isfinite(leaf.grad.numpy()).all()


def _dense_params(rng, dims):
    """``fused_mlp`` weights as tests/test_pallas_mlp.py makes them ([in,
    out], the JAX layout) and the port's transposes ([out, in])."""
    ws = [(rng.randn(a, b) * 0.05).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.randn(b) * 0.01).astype(np.float32) for b in dims[1:]]
    return ws, bs, [torch.from_numpy(w.T.copy()) for w in ws]


def test_fused_mlp_forward_matches_pallas(rng):
    """fused_mlp at N=700 (not a multiple of the tile), 132 -> 64 -> 64 -> 3:
    values to rtol 1e-5."""
    from dynamic_video_depth_tpu.ops.pallas.mlp_kernel import fused_mlp

    ws, bs, ws_t = _dense_params(rng, [132, 64, 64, 3])
    feat = rng.randn(700, 132).astype(np.float32)
    ref = fused_mlp(jnp.asarray(feat), tuple(map(jnp.asarray, ws)),
                    tuple(map(jnp.asarray, bs)), 256)
    out = mlp_kernel.fused_mlp(torch.from_numpy(feat), ws_t,
                               [torch.from_numpy(b) for b in bs])
    assert out.shape == (700, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_fused_mlp_gradients_match_pallas(rng):
    """fused_mlp's backward at N=300, 20 -> 32 -> 32 -> 3: dfeat, every dW
    and db from a random cotangent, to rtol 1e-4 / atol 1e-5."""
    from dynamic_video_depth_tpu.ops.pallas.mlp_kernel import fused_mlp

    ws, bs, ws_t = _dense_params(rng, [20, 32, 32, 3])
    feat = rng.randn(300, 20).astype(np.float32)
    cot = rng.randn(300, 3).astype(np.float32)

    def loss(f, w, b):
        return jnp.sum(fused_mlp(f, tuple(w), tuple(b), 128) * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(feat), list(map(jnp.asarray, ws)),
        list(map(jnp.asarray, bs)))
    leaves = [torch.from_numpy(feat).requires_grad_(True),
              *(w.requires_grad_(True) for w in ws_t),
              *(torch.from_numpy(b).requires_grad_(True) for b in bs)]
    out = mlp_kernel.fused_mlp(leaves[0], leaves[1:4], leaves[4:])
    (out * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(ref[0]),
                               **tol, err_msg="dfeat")
    for i in range(3):
        np.testing.assert_allclose(leaves[1 + i].grad.numpy().T,
                                   np.asarray(ref[1][i]), **tol,
                                   err_msg=f"dW{i}")
        np.testing.assert_allclose(leaves[4 + i].grad.numpy(),
                                   np.asarray(ref[2][i]), **tol,
                                   err_msg=f"db{i}")
