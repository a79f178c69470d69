"""The port's resizing and MiDaS net against the JAX package's, with weights
carried across by ``dynamic_video_depth_tpu_torch.runtime.weights``
(strict loading). Inputs and weights come from numpy with a seed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.models import MidasNet as JaxMidas
from dynamic_video_depth_tpu.ops import resize as jax_resize
from dynamic_video_depth_tpu_torch.models import MidasNet
from dynamic_video_depth_tpu_torch.ops import resize
from dynamic_video_depth_tpu_torch.runtime import weights


@pytest.mark.parametrize("h,w,c", [(5, 7, 3), (8, 3, 2)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_upsample2x_bilinear_matches_jax(rng, h, w, c, align_corners):
    x = rng.randn(2, h, w, c).astype(np.float32)
    ref = jax_resize.upsample2x_bilinear(jnp.asarray(x), align_corners)
    out = resize.upsample2x_bilinear(torch.from_numpy(x), align_corners)
    assert out.shape == (2, 2 * h, 2 * w, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("out_hw", [(11, 13), (4, 5), (9, 7)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_matches_jax(rng, out_hw, align_corners):
    """Bilinear and bicubic at odd sizes, up and down: torch's bicubic
    border handling (taps clamped to the edge, a = -0.75) is the JAX
    package's ``_cubic_matrix``."""
    x = rng.randn(1, 7, 9, 2).astype(np.float32)
    for name in ("resize_bilinear", "resize_bicubic"):
        ref = getattr(jax_resize, name)(jnp.asarray(x), out_hw, align_corners)
        out = getattr(resize, name)(torch.from_numpy(x), out_hw,
                                    align_corners)
        assert out.shape == (1,) + tuple(out_hw) + (2,)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_midas():
    """The JAX MiDaS with plain grouped convs, numpy-random weights and
    random frozen batch statistics, and the output conv biased so the depth
    (about 50) lies inside the far-field masks. Shapes come from
    ``eval_shape``."""
    rng = np.random.RandomState(0)
    net = JaxMidas(non_negative=True, normalize_input=True,
                   dense_group_width=0, merge_group_width=0)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))

    def fill(path, x):
        name = path[-1].key
        if name == "kernel":  # HWIO, lecun-normal scale
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return (0.05 * rng.randn(*x.shape)).astype(np.float32)  # bias

    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    variables["params"]["scratch__output_conv__4"]["bias"] = np.full(
        (1,), 200.0, np.float32)
    return net, variables


def test_midas_matches_jax(rng, jax_midas):
    """Full width at 64x64, batch 2: the depth agrees to 1e-4 relative."""
    net, variables = jax_midas
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(img)))
    port = weights.load_flax(MidasNet(), variables)
    with torch.no_grad():
        out = port(torch.from_numpy(img)).numpy()
    assert out.shape == (2, 64, 64)
    assert 10.0 < out.min() and out.max() < 100.0  # the masks are live
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_midas_resize_matches_jax(rng, jax_midas):
    """With ``resize`` the net runs at 64x64 on a 40x56 input (bicubic,
    align_corners) and resizes the depth back."""
    _, variables = jax_midas
    net = JaxMidas(non_negative=True, normalize_input=True, resize=(64, 64),
                   dense_group_width=0, merge_group_width=0)
    img = rng.rand(1, 40, 56, 3).astype(np.float32)
    ref = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(img)))
    port = weights.load_flax(MidasNet(resize=(64, 64)), variables)
    with torch.no_grad():
        out = port(torch.from_numpy(img)).numpy()
    assert out.shape == (1, 40, 56)
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_midas_round_trip(jax_midas):
    """JAX -> port (strict load) -> JAX gives back identical arrays."""
    _, variables = jax_midas
    port = weights.load_flax(MidasNet(), variables)
    back = weights.state_dict_to_flax(port.state_dict(), variables)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_midas_keys_follow_checkpoint():
    net = MidasNet()
    keys = net.state_dict().keys()
    for key in ("pretrained.layer1.0.weight",
                "pretrained.layer1.1.running_var",
                "pretrained.layer1.4.0.conv2.weight",
                "pretrained.layer1.4.0.downsample.0.weight",
                "pretrained.layer3.22.bn3.bias",
                "scratch.layer4_rn.weight",
                "scratch.refinenet4.resConfUnit2.conv1.weight",
                "scratch.refinenet1.resConfUnit1.conv2.bias",
                "scratch.output_conv.4.bias"):
        assert key in keys, key
    assert "scratch.refinenet4.resConfUnit1.conv1.weight" not in keys
    # the grouped 3x3: [cout, cin / 32, 3, 3]
    assert net.pretrained.layer2[0].conv2.weight.shape == (512, 16, 3, 3)


def test_biased_output_puts_depth_in_range():
    """Random weights put the depth near 1e6, past the far-field masks; the
    fixture helper brings it near 10000 / 200 = 50."""
    net = MidasNet(generator=torch.Generator().manual_seed(0))
    img = torch.rand(1, 32, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert float(net(img).max()) >= 1e5
        depth = weights.bias_midas_output(net)(img)
    assert 40.0 < float(depth.min()) and float(depth.max()) < 60.0


def test_midas_refuses_train_mode():
    net = MidasNet()
    net.train()
    with pytest.raises(RuntimeError, match="eval mode"):
        net(torch.zeros(1, 32, 32, 3))
