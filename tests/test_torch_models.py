"""The port's nets against the JAX package's, with weights carried across by
``dynamic_video_depth_tpu_torch.runtime.weights`` (strict loading)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.models import HourglassModelEmbed as JaxHourglass
from dynamic_video_depth_tpu.models import SceneFlowFieldNet as JaxField
from dynamic_video_depth_tpu.models.tiny import TinyDepthNet as JaxTiny
from dynamic_video_depth_tpu_torch.models import (HourglassModelEmbed,
                                                  SceneFlowFieldNet,
                                                  TinyDepthNet)
from dynamic_video_depth_tpu_torch.runtime import weights
from torch_threads import one_torch_thread  # noqa: F401


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), dict(tree))


def _jax_hourglass(rng, h=32, w=48):
    """The plain JAX hourglass with numpy-random weights AND random frozen
    batch statistics (so eval-mode normalization is exercised). Shapes come
    from ``eval_shape``: running flax's init here costs tens of seconds."""
    net = JaxHourglass(s2d_min_pixels=0, merge_reducers=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3), jnp.float32))

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

    return net, jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _jax_field():
    net = JaxField(net_width=32, n_layers=2, time_dependent=True,
                   n_freq_xyz=4, n_freq_t=2)
    z = jnp.zeros((1, 2, 3, 3)), jnp.zeros((1, 2, 3, 1))
    return net, _numpy_tree(net.init(jax.random.PRNGKey(1), *z))


def _port_field():
    return SceneFlowFieldNet(net_width=32, n_layers=2, time_dependent=True,
                             n_freq_xyz=4, n_freq_t=2)


def test_hourglass_matches_jax(rng):
    net, variables = _jax_hourglass(rng)
    img = rng.rand(2, 32, 48, 3).astype(np.float32)
    ref = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(img)))
    port = weights.load_flax(HourglassModelEmbed(), variables)
    with torch.no_grad():
        out = port(torch.from_numpy(img)).numpy()
    assert out.shape == (2, 32, 48)
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_hourglass_refuses_train_mode():
    net = HourglassModelEmbed()
    net.train()
    with pytest.raises(RuntimeError, match="eval mode"):
        net(torch.zeros(1, 16, 16, 3))


def test_sceneflow_field_matches_jax(rng):
    net, variables = _jax_field()
    pts = rng.randn(1, 5, 6, 3).astype(np.float32)
    ts = rng.rand(1, 5, 6, 1).astype(np.float32)
    ref = np.asarray(net.apply(variables, jnp.asarray(pts), jnp.asarray(ts)))
    port = weights.load_flax(_port_field(), variables)
    with torch.no_grad():
        out = port(torch.from_numpy(pts), torch.from_numpy(ts)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_hourglass_keys_follow_reference():
    keys = HourglassModelEmbed().state_dict().keys()
    assert "net_depth.seq.0.weight" in keys
    assert "net_depth.seq.1.running_var" in keys
    assert "net_depth.seq.3.list.0.1.convs.2.3.weight" in keys
    assert "net_depth.pred_layer.bias" in keys


@pytest.mark.parametrize("which", ["hourglass", "field", "tiny"])
def test_weights_round_trip(rng, which):
    """JAX -> port (strict load) -> JAX gives back identical arrays."""
    if which == "hourglass":
        _, variables = _jax_hourglass(rng)
        port = HourglassModelEmbed()
    elif which == "field":
        _, variables = _jax_field()
        port = _port_field()
    else:
        variables = _numpy_tree(JaxTiny().init(
            jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 3))))
        port = TinyDepthNet()
    weights.load_flax(port, variables)
    back = weights.state_dict_to_flax(port.state_dict(), variables)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_strict_load_rejects_missing_weights():
    _, variables = _jax_field()
    del variables["params"]["convs__0__conv"]
    with pytest.raises(RuntimeError, match="Missing key"):
        weights.load_flax(_port_field(), variables)
