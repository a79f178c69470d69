"""The port's MidasNet_mod (``MidasNet(mask_branch=True,
freeze_backbone=True)``) against the JAX package's, at full width and
64x64, with numpy-random weights carried across by
``runtime/weights.py`` (the mask head's flax paths
``scratch__output_conv_mask__{0,2,4}`` included).

Tolerances: the depth and the mask at relative 1e-4 (as
``tests/test_torch_midas.py`` holds the depth), the head's gradients at
relative 1e-4 with an absolute floor of 1e-4 of the largest entry."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.models import MidasNet as JaxMidas
from dynamic_video_depth_tpu_torch.models import MidasNet
from dynamic_video_depth_tpu_torch.runtime import weights
from torch_threads import one_torch_thread  # noqa: F401

HW = 64


def _jax_net(**kw):
    return JaxMidas(non_negative=True, normalize_input=True,
                    dense_group_width=0, merge_group_width=0,
                    mask_branch=True, **kw)


@pytest.fixture(scope="module")
def jax_mod():
    """MidasNet_mod's variables from numpy with a seed (shapes from
    ``eval_shape``), the output conv biased so the depth is about 50."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(_jax_net().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 3), jnp.float32))

    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return (0.05 * rng.randn(*x.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    variables["params"]["scratch__output_conv__4"]["bias"] = np.full(
        (1,), 200.0, np.float32)
    return variables


def test_mask_head_and_freeze_match_jax(jax_mod):
    """Depth, mask and the gradients of a weighted sum of both: the mask
    head's (and the depth head's) parameters match JAX's; the backbone's
    get no gradient in the port and zero ones in JAX."""
    rng = np.random.RandomState(1)
    img = rng.rand(1, HW, HW, 3).astype(np.float32)
    wd = rng.randn(1, HW, HW).astype(np.float32)
    wm = rng.randn(1, HW, HW).astype(np.float32)
    net = _jax_net(freeze_backbone=True)
    stats = jax_mod["batch_stats"]

    def loss(params):
        depth, mask = net.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(img))
        return jnp.sum(depth * wd) + jnp.sum(mask * wm), (depth, mask)

    (_, (ref_d, ref_m)), ref_g = jax.value_and_grad(loss, has_aux=True)(
        jax_mod["params"])
    port = weights.load_flax(MidasNet(mask_branch=True, freeze_backbone=True),
                             jax_mod)
    depth, mask = port(torch.from_numpy(img))
    ((depth * torch.from_numpy(wd)).sum()
     + (mask * torch.from_numpy(wm)).sum()).backward()

    assert depth.shape == mask.shape == (1, HW, HW)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(ref_d),
                               rtol=1e-4)
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(ref_m),
                               rtol=1e-4, atol=1e-6)
    assert 0.0 < float(mask.detach().min()) and float(mask.detach().max()) < 1.0
    ref_grads = weights.flax_to_state_dict({"params": ref_g})
    checked = 0
    for name, p in port.named_parameters():
        g = ref_grads[name].numpy()
        if name.startswith("pretrained."):
            assert p.grad is None, name
            assert not g.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=name)
        checked += name.startswith("scratch.output_conv_mask.")
    assert checked == 6


def test_mask_head_resize_and_unfrozen_backbone():
    """With ``resize`` the net runs at 64x64 and both outputs come back to
    the input's 40x56 by the bicubic resize (align_corners) of the
    unresized net's outputs on the resized input, bit for bit; without
    ``freeze_backbone`` the backbone's outputs carry gradients."""
    from dynamic_video_depth_tpu_torch.ops.resize import resize_bicubic

    gen = torch.Generator().manual_seed(4)
    net = weights.bias_midas_output(
        MidasNet(mask_branch=True, resize=(HW, HW), generator=gen))
    stages = []
    net.pretrained.register_forward_hook(lambda m, i, out: stages.extend(out))
    img = torch.rand(1, 40, 56, 3, generator=gen)
    depth, mask = net(img)
    assert depth.shape == mask.shape == (1, 40, 56)
    assert len(stages) == 4 and all(t.requires_grad for t in stages)
    net.resize = None
    with torch.no_grad():
        x = (img - net.mean) / net.std
        net.normalize_input = False
        d_in, m_in = net(resize_bicubic(x, (HW, HW), align_corners=True))
    for out, inner in ((depth, d_in), (mask, m_in)):
        back = resize_bicubic(inner[..., None], (40, 56),
                              align_corners=True)[..., 0]
        assert torch.equal(out.detach(), back)


def test_mask_keys_and_midas_mod_checkpoint(tmp_path, jax_mod):
    """The mask head's keys are ``scratch.output_conv_mask.{0,2,4}``; a
    MidasNet_mod file (the ``{"model", "optimizer"}`` wrapper) loads into
    MidasNet_mod, and into the plain MidasNet, which leaves the mask keys
    unused; the plain net has no mask keys and returns the depth alone."""
    sd = weights.flax_to_state_dict(jax_mod)
    keys = {k for k in sd if "output_conv_mask" in k}
    assert keys == {f"scratch.output_conv_mask.{i}.{p}" for i in (0, 2, 4)
                    for p in ("weight", "bias")}
    path = str(tmp_path / "midas_mod.pt")
    torch.save({"model": sd, "optimizer": {}}, path)
    mod = weights.load_midas_checkpoint(MidasNet(mask_branch=True), path)
    plain = weights.load_midas_checkpoint(MidasNet(), path)
    assert not any("mask" in k for k in plain.state_dict())
    img = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        depth, _ = mod(img)
        assert torch.equal(plain(img), depth)
    for k in keys:
        assert torch.equal(mod.state_dict()[k], sd[k])
    os.remove(path)  # ~350 MB
