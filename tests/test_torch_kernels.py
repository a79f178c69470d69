"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``dynamic_video_depth_tpu_torch.ops.cuda`` runs
its plain PyTorch version; the JAX side runs its Pallas kernel in interpret
mode, as the JAX package's own tests do. Inputs come from numpy with a
seed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.ops import embedding as jax_embedding
from dynamic_video_depth_tpu.ops.pallas.mlp_kernel import fused_mlp_embed
from dynamic_video_depth_tpu.ops.pallas.warp_kernel import fused_backward_warp
from dynamic_video_depth_tpu_torch.ops import embedding
from dynamic_video_depth_tpu_torch.ops.cuda import (chain_kernel, loss_kernel,
                                                  mlp_kernel, warp_kernel)


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


@pytest.mark.parametrize("n_steps,n_evals", [(1, 2), (2, 2), (3, 3), (4, 4)])
def test_chain_matches_pallas_chain(rng, n_steps, n_evals):
    """fused_mlp_embed_chain at N=600, width 32, 2 layers, freqs 4/2: the
    three outputs, and dpts, dts, ddt, dW, db from random cotangents."""
    from dynamic_video_depth_tpu.ops.pallas.mlp_kernel import (
        fused_mlp_embed_chain)

    n, dims, sf_div = 600, CHAIN_DIMS, 100.0
    pts = rng.randn(n, 3).astype(np.float32)
    ts = rng.rand(n, 1).astype(np.float32)
    dt = np.full((n, 1), 0.1, np.float32)
    ws = [(rng.randn(a, b) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.randn(b) * 0.01).astype(np.float32) for b in dims[1:]]
    gs = [rng.randn(n, 3).astype(np.float32) for _ in range(3)]
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
