"""The port's RAFT against the JAX package's: the correlation lookup's plain
version against the XLA tent-einsum lookup and the Pallas lookup (interpret
mode), the pyramid, the convex upsampling, the whole net with weights carried
by ``runtime/weights.py``, and the official-checkpoint loader. Inputs and
weights come from numpy with a seed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.models import raft as jax_raft
from dynamic_video_depth_tpu.ops.pallas.correlation import (
    fused_lookup_correlation)
from dynamic_video_depth_tpu_torch.models import raft
from dynamic_video_depth_tpu_torch.ops.cuda import corr_kernel
from dynamic_video_depth_tpu_torch.runtime import weights
from torch_threads import one_torch_thread  # noqa: F401


def _pyramid(rng, b, h, w, levels):
    pyr, hl, wl = [], h, w
    for _ in range(levels):
        pyr.append(rng.randn(b, h * w, hl, wl).astype(np.float32))
        hl, wl = hl // 2, wl // 2
    return pyr


@pytest.mark.parametrize("b,h,w,radius,levels,spill", [
    (1, 16, 24, 4, 4, 0.1),   # coordinates past every border
    (2, 8, 16, 3, 2, 0.0),
])
def test_lookup_matches_jax(rng, b, h, w, radius, levels, spill):
    """The plain gather against ``lookup_correlation`` (tent einsums) and
    ``fused_lookup_correlation`` (Pallas, interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu

    pyr = _pyramid(rng, b, h, w, levels)
    coords = (rng.rand(b, h, w, 2) * [w * (1 + 2 * spill), h * (1 + 2 * spill)]
              - [w * spill, h * spill]).astype(np.float32)
    # exact integers and exact borders take the y1 = y0 / x1 = x0 taps
    coords[0, 0, :4] = [[0.0, 0.0], [w - 1.0, h - 1.0], [3.0, 2.0],
                        [-50.0, 90.0]]
    out = corr_kernel.lookup_correlation(
        [torch.from_numpy(p) for p in pyr], torch.from_numpy(coords), radius)
    assert out.shape == (b, h, w, levels * (2 * radius + 1) ** 2)
    jpyr = [jnp.asarray(p) for p in pyr]
    ref = jax_raft.lookup_correlation(jpyr, jnp.asarray(coords), radius)
    with pltpu.force_tpu_interpret_mode():
        fused = fused_lookup_correlation(jpyr, jnp.asarray(coords), radius)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(fused), **tol)


def test_pyramid_and_upsample_match_jax(rng):
    b, h, w, c = 2, 12, 20, 16
    f1 = rng.randn(b, h, w, c).astype(np.float32)
    f2 = rng.randn(b, h, w, c).astype(np.float32)
    ours = raft.correlation_pyramid(torch.from_numpy(f1),
                                    torch.from_numpy(f2), 4)
    ref = jax_raft.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    assert [tuple(o.shape) for o in ours] == [
        (b, h * w, 12, 20), (b, h * w, 6, 10), (b, h * w, 3, 5),
        (b, h * w, 1, 2)]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)

    flow = rng.randn(b, 5, 7, 2).astype(np.float32)
    mask = rng.randn(b, 5, 7, 576).astype(np.float32)
    up = raft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    ref = jax_raft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    assert up.shape == (b, 40, 56, 2)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _jax_variables(rng, h=64, w=96):
    """JAX RAFT variables from numpy: lecun-scale kernels, small biases and
    randomised batch-norm statistics, so eval-mode parity exercises them."""
    net = jax_raft.RAFT()
    zeros = jnp.zeros((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), zeros,
                                             zeros, iters=1))

    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "mean":
            return (0.05 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.7, 1.3, x.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return (0.02 * rng.randn(*x.shape)).astype(np.float32)

    return net, jax.tree_util.tree_map_with_path(fill, dict(shapes))


def test_raft_matches_jax(rng):
    """The full net at 64x96, 3 iterations, both flows."""
    h, w = 64, 96
    jnet, variables = _jax_variables(rng, h, w)
    im1 = (rng.rand(2, h, w, 3) * 255).astype(np.float32)
    im2 = (rng.rand(2, h, w, 3) * 255).astype(np.float32)
    ref8, ref_up = jax.jit(lambda v, a, b: jnet.apply(v, a, b, iters=3))(
        variables, jnp.asarray(im1), jnp.asarray(im2))

    net = weights.load_flax(raft.RAFT(), variables)
    with torch.no_grad():
        flow8, flow_up = net(torch.from_numpy(im1), torch.from_numpy(im2),
                             iters=3)
    assert flow8.shape == (2, 8, 12, 2) and flow_up.shape == (2, h, w, 2)
    tol = dict(rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(flow8.numpy(), np.asarray(ref8), **tol)
    np.testing.assert_allclose(flow_up.numpy(), np.asarray(ref_up), **tol)


def test_raft_keys_follow_official_checkpoint():
    keys = raft.RAFT().state_dict().keys()
    for key in ("fnet.conv1.weight", "fnet.layer2.0.conv1.weight",
                "fnet.layer2.0.downsample.0.bias",
                "cnet.norm1.running_mean", "cnet.layer3.0.downsample.1.weight",
                "cnet.layer1.1.norm2.num_batches_tracked",
                "update_block.encoder.convc1.weight",
                "update_block.gru.convz1.weight",
                "update_block.gru.convq2.bias",
                "update_block.flow_head.conv2.weight",
                "update_block.mask.0.weight", "update_block.mask.2.bias"):
        assert key in keys, key
    # the feature encoder's instance norms carry no state
    assert not any(k.startswith("fnet.") and "norm" in k for k in keys)


def test_load_raft_checkpoint_official_layout(tmp_path):
    """A ``module.``-prefixed state dict loads strictly; an extra key, or a
    missing one, raises."""
    src = raft.RAFT(generator=torch.Generator().manual_seed(1))
    sd = {"module." + k: v for k, v in src.state_dict().items()}
    path = str(tmp_path / "raft-sintel.pth")
    torch.save(sd, path)
    net = weights.load_raft_checkpoint(raft.RAFT(), path)
    for k, v in src.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k

    bad = dict(sd)
    bad["module.update_block.phantom.weight"] = torch.zeros(1)
    torch.save(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(KeyError, match="not consumed"):
        weights.load_raft_checkpoint(raft.RAFT(), str(tmp_path / "bad.pth"))

    short = {k: v for k, v in sd.items() if "flow_head.conv2" not in k}
    torch.save(short, str(tmp_path / "short.pth"))
    with pytest.raises(RuntimeError, match="flow_head.conv2"):
        weights.load_raft_checkpoint(raft.RAFT(), str(tmp_path / "short.pth"))


def test_raft_refuses_train_mode():
    net = raft.RAFT()
    net.train()
    with pytest.raises(RuntimeError, match="eval mode"):
        net(torch.zeros(1, 64, 64, 3), torch.zeros(1, 64, 64, 3), iters=1)
