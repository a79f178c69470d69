"""The port's variant nets against the JAX package's, on the CPU, with the
helpers of ``test_torch_variants.py``.

Each test takes its inputs from a numpy seed, runs the JAX function and the
port's counterpart from the same weights, and states its tolerance:

- ``FCNUnet`` (``--use_cnn``): forward and input/parameter gradients at
  rtol 1e-5 / atol 1e-6; a ``--use_cnn`` step with the fused loss on (the
  plain versions of kernels A and D here) and off, at the step tolerances
  of ``test_torch_step.py``.
- ``ConvBlock`` (every norm), ``MLP`` and ``EmbeddedMLP``: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_video_depth_tpu.models import EmbeddedMLP as JaxEmbeddedMLP
from dynamic_video_depth_tpu.models import FCNUnet as JaxFCNUnet
from dynamic_video_depth_tpu.models import MLP as JaxMLP
from dynamic_video_depth_tpu.models.blocks import ConvBlock as JaxConvBlock
from dynamic_video_depth_tpu_torch.models import (MLP, ConvBlock, EmbeddedMLP,
                                                  FCNUnet)
from dynamic_video_depth_tpu_torch.runtime import weights
from test_torch_variants import (NET, SGD, _assert_step_parity, _configs,
                                 _fill, _numpy, _run_steps)
from torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------------------------ FCNUnet


def _grad_check(jax_fn, variables, port, x, tol, relative_atol=False):
    """Forward, input gradient and parameter gradients of
    ``sum(out * cot)`` at ``tol`` (with ``relative_atol`` its ``atol``
    scaled by each reference's largest magnitude)."""

    def close(a, b, **kw):
        t = dict(tol)
        if relative_atol:
            t["atol"] *= float(np.abs(b).max())
        np.testing.assert_allclose(a, b, **t, **kw)

    y = np.asarray(jax_fn(variables, jnp.asarray(x)))
    cot = np.random.RandomState(7).randn(*y.shape).astype(np.float32)

    def loss(v, xx):
        return jnp.sum(jax_fn(v, xx) * cot)

    g_vars, g_x = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    close(out.detach().numpy(), y)
    close(xt.grad.numpy(), np.asarray(g_x))
    grads = {k: p.grad for k, p in port.named_parameters()}
    ref = weights.flax_to_state_dict({"params": _numpy(g_vars["params"])})
    assert set(grads) == set(ref)
    for k in ref:
        close(grads[k].numpy(), ref[k].numpy(), err_msg=k)


CNN = dict(n_down=3, feat=32, block_type="double_conv", out_channel=3,
           norm="none", activation="lrelu", pad_type="reflect")


def test_fcn_unet_matches_jax(rng):
    """The canonical ``--use_cnn`` instance on [pts, t] at 16x24, in float32
    at rtol 1e-5 with ``atol`` 1e-6 of the largest reference magnitude
    (the outputs are O(1) and each sums ~16 convolutions of up to 2,304
    terms: float32 roundoff alone reaches a few 1e-6 absolute on outputs
    near 0), and in float64 at rtol 1e-6 / atol 1e-7: there only the JAX
    upsampling's interpolation matrices, float32 constants, round."""
    net = JaxFCNUnet(**CNN)
    x = rng.randn(2, 16, 24, 4).astype(np.float32)
    variables = _numpy(net.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    port = weights.load_flax(FCNUnet(4, **CNN), variables)
    _grad_check(net.apply, variables, port, x, dict(rtol=1e-5, atol=1e-6),
                relative_atol=True)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ref = np.asarray(net.apply(v64, jnp.asarray(x, jnp.float64)))
    with torch.no_grad():
        out = port.double()(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(n_down=2, block_type="conv", down_sample_type="maxpool",
         output_activation="tanh", pad_type="zero"),
    dict(n_down=1, block_type="double_conv", output_activation="sigmoid",
         activation="prelu")])
def test_fcn_unet_options_match_jax(rng, kw):
    net = JaxFCNUnet(out_channel=5, feat=8, **kw)
    x = rng.randn(1, 8, 12, 3).astype(np.float32)
    variables = _numpy(net.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    port = weights.load_flax(FCNUnet(3, out_channel=5, feat=8, **kw),
                             variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(net.apply(variables, x)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["none", "batch", "inst", "ln", "weight"])
@pytest.mark.parametrize("activation,pad_type", [("lrelu", "reflect"),
                                                 ("prelu", "zero"),
                                                 ("selu", "reflect")])
def test_conv_block_matches_jax(rng, norm, activation, pad_type):
    kw = dict(features=6, kernel_size=3, padding=1, norm=norm,
              activation=activation, pad_type=pad_type)
    block = JaxConvBlock(**kw)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(_fill(rng), dict(shapes))
    port = weights.load_flax(ConvBlock(3, **kw), variables)
    y = np.asarray(block.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), y,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_cnn_step_matches_jax(fused):
    """A warm-up and a main step with ``--use_cnn`` (n_down 3 at 16x24),
    the fused loss on (kernels A and D's plain versions) and off; neither
    kernel B nor the chain is on the path. The steps update by SGD, the
    variant recipe's optimizer, at the SGD test's tolerances (under Adam
    one of the CNN's 18,432 weights parts by 1.9e-5 after the main step:
    its near-zero gradient, normalised, becomes a step of ~lr)."""
    net = dict(NET, use_cnn=True, n_down=3)
    jax_cfg, cfg = _configs(fused, net=net, **SGD)
    _, state, ref_logs, step, logs, init, _ = _run_steps(
        jax_cfg, cfg, [(1, True), (2, False)])
    assert type(step.net_sf) is FCNUnet
    assert (step.chain_fused, step.loss_fused) == (False, fused)
    _assert_step_parity(ref_logs, logs, state, step, init,
                        dict(rtol=1e-5, atol=1e-7))


# ----------------------------------------------------- MLP, EmbeddedMLP


@pytest.mark.parametrize("cls,port_cls,kw", [
    (JaxMLP, MLP, dict(out_ch=3, depth=3, width=16, activation="lrelu",
                       output_activation="tanh")),
    (JaxEmbeddedMLP, EmbeddedMLP, dict(out_ch=2, depth=5, width=16,
                                       n_freq=3, skip=2, init_val=0.5)),
    (JaxEmbeddedMLP, EmbeddedMLP, dict(out_ch=3, depth=3, width=8,
                                       n_freq=4, skip=3))])
def test_mlps_match_jax(rng, cls, port_cls, kw):
    net = cls(**kw)
    x = rng.randn(2, 5, 3).astype(np.float32)
    variables = _numpy(net.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    port = weights.load_flax(port_cls(3, **kw), variables)
    _grad_check(net.apply, variables, port, x, dict(rtol=1e-5, atol=1e-6))
    fresh = port_cls(3, **kw, generator=torch.Generator().manual_seed(0))
    assert set(fresh.state_dict()) == set(port.state_dict())
    if kw.get("init_val") is not None:
        last = f"layer_{kw['depth']:03d}.linear.bias"
        assert torch.all(fresh.state_dict()[last] == kw["init_val"])
