"""The port's variant recipes against the JAX package's, on the CPU.

Each test takes its inputs from a numpy seed, runs the JAX function and the
port's counterpart from the same weights, and states its tolerance:

- bfloat16 depth compute (``--mixed_precision_training``): a warm-up and a
  main step of the tiny-net step against the JAX step's bfloat16 path. Two
  right bfloat16 computations round differently, so the yardstick is
  relative: the port's bfloat16 result is no further (max-abs) from JAX's
  bfloat16 result than JAX's bfloat16 result is from its float32 one, for
  the depth, the losses and each net's updated parameters; and the port's
  bfloat16 result differs from its own float32 one, so the cast cannot be a
  no-op. The steps update by SGD: Adam's first update moves every weight by
  about ``lr`` whatever its gradient's size, so where two computations
  disagree on the sign of a near-zero gradient the weights part by 2 ``lr``
  on both sides of the comparison alike. The JAX bfloat16 side is compiled
  with ``xla_allow_excess_precision`` off (``NO_EXCESS``): by default XLA
  keeps float32 between the fused elementwise ops of a bfloat16 program
  (its depth is then not even bfloat16-representable), while the program,
  and the port on every device, rounds each op's result to bfloat16.
  Compiled so, the tiny net's JAX depth equals the port's bit for bit.
- The hourglass and MiDaS forwards in bfloat16 against the JAX
  ``_apply_depth``. Through tens of layers two bfloat16 computations that
  round at different points (torch's batch norm is one fused op, flax's
  four) part chaotically, by one or two units in the last place of the
  depth, as far as each lies from float32 (MiDaS at 64x64: 0.5 apart, each
  0.30-0.34 from float32; the hourglass: 0.0156 apart, 0.0127 and 0.0102).
  So the yardstick there is the one two independent roundings can meet:
  the port's bfloat16 depth lies no further from the float32 depth than
  JAX's bfloat16 depth does, plus one bfloat16 unit at the depth's
  magnitude, which bounds its distance to JAX's bfloat16 depth by twice
  JAX's own distance plus that unit.
- ``--remat_depth``: equal to the plain step at rtol 1e-6, losses and
  gradients, in float32 and bfloat16.
- SGD with momentum, dampening and weight decay: three steps against the
  JAX SGD chain at rtol 1e-5 / atol 1e-7, with a narrow scene-flow MLP (no
  Adam normalisation to spread a leaky-relu slope flip).
- ``FCNUnet`` (``--use_cnn``): forward and input/parameter gradients at
  rtol 1e-5 / atol 1e-6; a ``--use_cnn`` step with the fused loss on (the
  plain versions of kernels A and D here) and off, at the step tolerances
  of ``test_torch_step.py``.
- ``--log_grad_stats``: the four statistics at rtol 1e-5, the depth terms
  exactly 0 in warm-up.
- ``ConvBlock`` (every norm), ``MLP`` and ``EmbeddedMLP``: rtol 1e-5.
- ShutterStock: the train and validation items and the integer
  ``--track_id`` selection against the JAX ``Dataset``.
"""

import json
import os
import shlex
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from chip_smoke import state_equal
from dynamic_video_depth_tpu.models import EmbeddedMLP as JaxEmbeddedMLP
from dynamic_video_depth_tpu.models import FCNUnet as JaxFCNUnet
from dynamic_video_depth_tpu.models import MLP as JaxMLP
from dynamic_video_depth_tpu.models.blocks import ConvBlock as JaxConvBlock
from dynamic_video_depth_tpu.train import LossConfig as JaxLossConfig
from dynamic_video_depth_tpu.train import TrainStepConfig as JaxConfig
from dynamic_video_depth_tpu.train.step import SceneFlowMotionFieldStep as JaxStep
from dynamic_video_depth_tpu_torch.models import (MLP, ConvBlock, EmbeddedMLP,
                                                  FCNUnet)
from dynamic_video_depth_tpu_torch.runtime import weights
from dynamic_video_depth_tpu_torch.train import (LossConfig,
                                                 SceneFlowMotionFieldStep,
                                                 TrainStepConfig)
from dynamic_video_depth_tpu_torch.train import cli

LOG_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")
GRAD_KEYS = ("grad_norm_depth", "grad_norm_sf", "grad_max_depth",
             "grad_max_sf")
NET = dict(lr=1e-4, scene_lr_mul=10.0, depth_net="tiny", net_width=32,
           n_layers=2, n_freq_xyz=4, n_freq_t=2)
STEP_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
HERE = os.path.dirname(os.path.abspath(__file__))


def _numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), dict(tree))


def _configs(fused: bool = False, net=NET, **kw):
    """(JAX config, port config) of the same step: the plain paths, or with
    ``fused`` the fused projection loss (kernels A and D) and, for the MLP
    field, the chain."""
    loss = dict(flow_mul=1.0, disp_mul=1.0, acc_mul=1.0, use_disp=True,
                midas=fused)
    mode = "on" if fused else "off"
    kw.setdefault("compute_dtype", "float32")  # the JAX default is bf16
    jax_cfg = JaxConfig(
        **net, **kw, loss=JaxLossConfig(**loss), use_pallas_sf=mode,
        use_pallas_sf_chain=mode, use_pallas_warp=mode,
        pallas_warp_window=None, use_pallas_loss=mode)
    return jax_cfg, TrainStepConfig(**net, **kw, loss=LossConfig(**loss),
                                    use_pallas_sf_chain=mode,
                                    use_pallas_loss=mode)


NO_EXCESS = {"xla_allow_excess_precision": False}


def _compiled(jitted, *args, **static):
    """``jitted`` compiled for ``args`` with each op rounded to its type
    (``NO_EXCESS``); the result takes the dynamic arguments only."""
    return jitted.lower(*args, **static).compile(compiler_options=NO_EXCESS)


def _run_steps(jax_cfg, cfg, schedule, seed=0, h=16, w=24):
    """Both steps from the JAX init over ``schedule`` [(gap, warm), ...]:
    (JAX state, JAX logs, port step, port logs, initial depth and field
    params, the batch). A bfloat16 JAX step is compiled with
    ``NO_EXCESS``."""
    from jax.experimental.pallas import tpu as pltpu

    batch = graft._synthetic_batch(1, h, w, np.random.RandomState(seed))
    jax_step = JaxStep(jax_cfg)
    state = jax_step.init_state(jax.random.PRNGKey(3), batch["img_1"])
    init = ({"params": _numpy(state.params_depth)},
            {"params": _numpy(state.params_sf)})
    step = SceneFlowMotionFieldStep(cfg, device="cpu")
    weights.load_flax(step.net_depth, init[0])
    weights.load_flax(step.net_sf, init[1])
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    ref_logs, logs = [], []
    state = jax.tree.map(jnp.copy, state)
    with pltpu.force_tpu_interpret_mode():
        for steps, warm in schedule:
            if jax_cfg.compute_dtype == "bfloat16":
                state, ref = _compiled(JaxStep.train_step, jax_step, state,
                                       batch, steps=steps,
                                       warm=warm)(state, batch)
            else:
                state, ref = jax_step.train_step(state, batch, steps=steps,
                                                 warm=warm)
            ref_logs.append({k: float(v) for k, v in ref.items()
                             if k != "_packed"})
            logs.append({k: float(v) for k, v in
                         step.train_step(tbatch, steps=steps,
                                         warm=warm).items()})
    return jax_step, state, ref_logs, step, logs, init, (batch, tbatch)


def _port_params(step, init):
    """Both port nets' parameters as flat lists in the JAX trees' order."""
    out = []
    for net, tmpl in ((step.net_depth, init[0]), (step.net_sf, init[1])):
        tree = weights.state_dict_to_flax(net.state_dict(), tmpl)
        out.append(jax.tree.leaves(tree))
    return out


def _jax_params(state):
    return [jax.tree.leaves(_numpy(state.params_depth)),
            jax.tree.leaves(_numpy(state.params_sf))]


def _assert_step_parity(ref_logs, logs, state, step, init, param_tol):
    for ref, ours in zip(ref_logs, logs):
        for k in LOG_KEYS:
            np.testing.assert_allclose(ours[k], ref[k], rtol=STEP_RTOL,
                                       err_msg=k)
    for ours, ref in zip(_port_params(step, init), _jax_params(state)):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, **param_tol)


def _maxabs(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                   - np.asarray(y, np.float64))))
               for x, y in zip(a, b))


# ------------------------------------------------------------ bfloat16


@pytest.fixture(scope="module")
def bf16_runs():
    """The tiny-net step, a warm-up and a main step, in bfloat16 (JAX and
    port) and in float32 (JAX and port), from the same weights, updating by
    SGD with momentum."""
    schedule = [(1, True), (2, False)]
    out = {}
    for dtype in ("bfloat16", "float32"):
        jax_cfg, cfg = _configs(compute_dtype=dtype, optim="sgd")
        jax_step, state, ref_logs, step, logs, init, (batch, tbatch) = \
            _run_steps(jax_cfg, cfg, schedule)
        img = jnp.concatenate([batch["img_1"], batch["img_2"]], 0)
        params = init[0]["params"]
        jax_depth = np.asarray(_compiled(jax.jit(jax_step._apply_depth),
                                         params, {}, img)(params, {}, img))
        with torch.no_grad():
            depth = step._apply_depth(torch.cat(
                [tbatch["img_1"], tbatch["img_2"]], 0)).numpy()
        out[dtype] = dict(jax_depth=jax_depth, depth=depth,
                          jax_logs=ref_logs, logs=logs,
                          jax_params=_jax_params(state),
                          params=_port_params(step, init))
    return out


@pytest.mark.parametrize("what", ["depth", "losses", "params_depth",
                                  "params_sf"])
def test_bf16_step_matches_jax_bf16(bf16_runs, what):
    """Port bf16 to JAX bf16 no further than JAX bf16 to JAX f32 (max-abs),
    and port bf16 unlike port f32."""
    bf, f32 = bf16_runs["bfloat16"], bf16_runs["float32"]

    def pick(run, jax_side):
        if what == "depth":
            return [run["jax_depth" if jax_side else "depth"]]
        if what == "losses":
            logs = run["jax_logs" if jax_side else "logs"]
            return [np.asarray([r[k] for k in LOG_KEYS]) for r in logs]
        i = 0 if what == "params_depth" else 1
        return run["jax_params" if jax_side else "params"][i]

    port_vs_jax = _maxabs(pick(bf, False), pick(bf, True))
    jax_bf16_vs_f32 = _maxabs(pick(bf, True), pick(f32, True))
    assert jax_bf16_vs_f32 > 0.0
    assert port_vs_jax <= jax_bf16_vs_f32, (port_vs_jax, jax_bf16_vs_f32)
    assert _maxabs(pick(bf, False), pick(f32, False)) > 0.0
    assert bf["depth"].dtype == np.float32


def _bf16_forward_check(net_cfg, variables, img):
    """One depth forward through the JAX step's ``_apply_depth`` in
    bfloat16 and float32 and the port step's from the same ``variables``;
    returns the port's bfloat16 depth."""
    jax_out = {}
    args = (variables["params"], variables.get("batch_stats", {}),
            jnp.asarray(img))
    for dtype in ("bfloat16", "float32"):
        jax_step = JaxStep(JaxConfig(**net_cfg, compute_dtype=dtype))
        jax_out[dtype] = np.asarray(
            _compiled(jax.jit(jax_step._apply_depth), *args)(*args))
    step = SceneFlowMotionFieldStep(
        TrainStepConfig(depth_net=net_cfg["depth_net"],
                        compute_dtype="bfloat16"), device="cpu")
    weights.load_flax(step.net_depth, variables)
    x = torch.from_numpy(img)
    with torch.no_grad():
        out = step._apply_depth(x)
        out_f32 = step.net_depth(x).numpy()  # the float32 step's forward
    assert out.dtype == torch.float32
    out = out.numpy()
    jax_gap = _maxabs([jax_out["bfloat16"]], [jax_out["float32"]])
    # one bfloat16 unit in the last place at the depth's largest magnitude
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jax_out["float32"]).max())) - 7)
    assert jax_gap > 0.0
    assert _maxabs([out], [jax_out["float32"]]) <= jax_gap + ulp
    assert _maxabs([out], [jax_out["bfloat16"]]) <= 2 * jax_gap + ulp
    assert _maxabs([out], [out_f32]) > 0.0
    return out


def test_bf16_hourglass_forward_matches_jax(rng):
    from test_torch_models import _jax_hourglass

    _, variables = _jax_hourglass(rng)
    img = rng.rand(2, 32, 48, 3).astype(np.float32)
    _bf16_forward_check(dict(depth_net="hourglass", s2d_min_pixels=0,
                             merge_reducers=False), variables, img)


def test_bf16_midas_forward_matches_jax(rng):
    """Full width at 64x64 with random frozen statistics and the biased
    output conv (depth about 50, inside the far-field masks)."""
    from dynamic_video_depth_tpu.models import MidasNet as JaxMidas

    net = JaxMidas(non_negative=True, normalize_input=True,
                   dense_group_width=0, merge_group_width=0)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = jax.tree_util.tree_map_with_path(
        _fill(np.random.RandomState(0), spread=0.05, bias=0.05),
        dict(shapes))
    variables["params"]["scratch__output_conv__4"]["bias"] = np.full(
        (1,), 200.0, np.float32)
    img = rng.rand(1, 64, 64, 3).astype(np.float32)
    depth = _bf16_forward_check(dict(depth_net="midas", dense_group_width=0,
                                     merge_group_width=0), variables, img)
    assert 10.0 < depth.min() and depth.max() < 100.0


# -------------------------------------------------------- --remat_depth


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_depth_equals_plain_step(dtype):
    """Recomputing the depth forward in the backward changes nothing:
    losses and both nets' gradients at rtol 1e-6."""
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             graft._synthetic_batch(1, 16, 24,
                                    np.random.RandomState(1)).items()}
    results = []
    for remat in (False, True):
        _, cfg = _configs(compute_dtype=dtype, remat_depth=remat)
        step = SceneFlowMotionFieldStep(cfg, device="cpu", seed=4)
        total, logs = step.loss_and_logs(batch, 2, warm=False)
        total.backward()
        grads = [p.grad.clone() for net in (step.net_depth, step.net_sf)
                 for p in net.parameters()]
        results.append(([float(logs[k].detach()) for k in LOG_KEYS], grads))
    (logs_a, grads_a), (logs_b, grads_b) = results
    np.testing.assert_allclose(logs_b, logs_a, rtol=1e-6)
    assert len(grads_a) == len(grads_b)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------- SGD


SGD = dict(optim="sgd", sgd_momentum=0.9, sgd_dampening=0.1, wdecay=1e-3)
NARROW = dict(NET, net_width=8, n_layers=1, lr=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_sgd_steps_match_jax_sgd_chain(fused):
    """Three steps (warm-up, then two main ones: the depth net's buffer is
    seeded at the first main step, the field's at the first step) at rtol
    1e-5 / atol 1e-7."""
    jax_cfg, cfg = _configs(fused, net=NARROW, **SGD)
    _, state, ref_logs, step, logs, init, _ = _run_steps(
        jax_cfg, cfg, [(1, True), (2, False), (1, False)])
    assert isinstance(step.opt_sf, torch.optim.SGD)
    _assert_step_parity(ref_logs, logs, state, step, init,
                        dict(rtol=1e-5, atol=1e-7))
    # the depth net's SGD kept no state through warm-up and has it now
    assert all("momentum_buffer" in step.opt_depth.state[p]
               for p in step.net_depth.parameters())


# ----------------------------------------------------- --log_grad_stats


def test_grad_stats_match_jax():
    jax_cfg, cfg = _configs(log_grad_stats=True)
    _, _, ref_logs, step, logs, _, _ = _run_steps(
        jax_cfg, cfg, [(1, True), (2, False)])
    for ref, ours in zip(ref_logs, logs):
        for k in GRAD_KEYS:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5,
                                       err_msg=k)
    for k in ("grad_norm_depth", "grad_max_depth"):
        assert logs[0][k] == ref_logs[0][k] == 0.0
        assert logs[1][k] > 0.0
    assert logs[0]["grad_norm_sf"] > 0.0


# ------------------------------------------------------------ FCNUnet


def _fill(rng, spread=0.2, bias=0.1):
    """Random values of every leaf kind (batch statistics included), so
    that each norm does real work: kernels at the lecun-normal scale,
    scales ``1 + spread * N(0, 1)``, biases ``bias * N(0, 1)``."""
    def fill(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        if name in ("scale", "weight") or name.endswith("/scale"):
            return (1.0 + spread * rng.randn(*x.shape)).astype(np.float32)
        return (bias * rng.randn(*x.shape)).astype(np.float32)
    return fill


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


# --------------------------------------------------------- ShutterStock


@pytest.fixture(scope="module")
def ss_root(tmp_path_factory):
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("shutterstock"))
    for i, track in enumerate(("beach", "alley", "cliff")):
        make_track(root, track=track, n_frames=4, h=32, w=48, gaps=(1, 2),
                   seed=i)
    return root


def _ss_opt(root, track):
    return Namespace(track_id=track, data_root=root, gaps="1,2",
                     subsample=False, repeat=1, overfit=False, cache=False)


@pytest.mark.parametrize("track,name", [("0", "alley"), ("2", "cliff"),
                                        ("4", "beach"), ("cliff", "cliff")])
def test_shutterstock_items_match_jax(ss_root, track, name):
    """An integer ``--track_id`` picks the sorted index (mod the count);
    the train and validation items equal the JAX reader's."""
    from dynamic_video_depth_tpu.data import get_dataset as jax_dataset
    from dynamic_video_depth_tpu_torch.data import get_dataset

    for mode in ("train", "vali"):
        opt, ref_opt = _ss_opt(ss_root, track), _ss_opt(ss_root, track)
        ours = get_dataset("shutterstock")(opt, mode)
        ref = jax_dataset("shutterstock")(ref_opt, mode)
        assert opt.track_id == ref_opt.track_id == name
        assert len(ours) == len(ref) > 0
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            # the JAX reader adds its TPU warp's row window to a pair
            assert set(b) - set(a) <= {"warp_window"} and set(a) <= set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)


def _shutterstock_flags(track="0"):
    """The flags between ``python train.py`` and ``"$@"`` in
    ``experiments/shutterstock/train_sequence.sh``."""
    path = os.path.join(HERE, "..", "experiments", "shutterstock",
                        "train_sequence.sh")
    with open(path) as f:
        body = f.read().split("python train.py", 1)[1].split('"$@"', 1)[0]
    return shlex.split(body.replace("\\\n", " ").replace("${track}", track))


def test_shutterstock_recipe_flag_list_parses():
    opt = cli.build_parser().parse_args(_shutterstock_flags())
    assert (opt.dataset, opt.track_id, opt.gaps, opt.midas) == (
        "shutterstock", "0", "1,2,4,6,8", True)
    assert opt.test_template.endswith("shutterstock/test_cmd.txt")
    cfg = cli.step_config(opt)
    assert (cfg.optim, cfg.compute_dtype, cfg.use_cnn) == ("adam", "float32",
                                                            False)


@pytest.mark.parametrize("extra,want", [
    ([], dict(compute_dtype="float32", optim="adam")),
    (["--mixed_precision_training", "--loss_scaling", "128"],
     dict(compute_dtype="bfloat16")),
    (["--mixed_precision_training", "--full_precision"],
     dict(compute_dtype="float32")),
    (["--optim", "sgd", "--sgd_momentum", "0.5", "--sgd_dampening", "0.1",
      "--wdecay", "1e-4"],
     dict(optim="sgd", sgd_momentum=0.5, sgd_dampening=0.1, wdecay=1e-4)),
    (["--use_cnn", "--n_down", "2", "--use_embedding", "--remat_depth",
      "--log_grad_stats"],
     dict(use_cnn=True, n_down=2, use_embedding=True, remat_depth=True,
          log_grad_stats=True))])
def test_step_config_maps_variant_flags(extra, want):
    opt = cli.build_parser().parse_args(["--track_id", "dog"] + extra)
    cfg = cli.step_config(opt)
    assert {k: getattr(cfg, k) for k in want} == want


# ------------------------------------------------ the entries, end to end


VARIANTS = ["--use_cnn", "--optim", "sgd", "--sgd_dampening", "0.1",
            "--wdecay", "1e-4", "--log_grad_stats", "--remat_depth"]


def test_variant_recipe_through_the_entries(ss_root, tmp_path, monkeypatch):
    """The ShutterStock recipe's flags with the variants (``--use_cnn``,
    SGD, ``--log_grad_stats``, ``--remat_depth``) and an integer track id,
    the tiny depth net on the CPU: a warm-up and a main epoch, the grad-stat
    columns of ``epoch_loss.csv`` (depth terms 0 in warm-up, above 0 after),
    SGD momentum buffers in ``checkpoint.pt`` restored bit for bit by
    ``--resume -1``, and the chained test command of
    ``experiments/shutterstock/test_cmd.txt`` (its output directory is
    relative to the working directory)."""
    import csv

    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        read_checkpoint)

    monkeypatch.chdir(tmp_path)
    common = ["--epoch_batches", "3", "--vali_batches", "2", "--batch_size",
              "1", "--device", "cpu"]
    flags = _shutterstock_flags("0") + common + VARIANTS + [
        "--depth_net", "tiny", "--data_root", ss_root, "--gaps", "1,2",
        "--epoch", "2", "--warm_sf", "1", "--logdir", str(tmp_path / "runs"),
        "--manual_seed", "0", "--lr", "1e-4", "--scene_lr_mul", "10",
        "--test_template", os.path.join(HERE, "..", "experiments",
                                        "shutterstock", "test_cmd.txt")]
    run = cli.build_run(flags)
    step = run.model.step
    assert run.opt.track_id == "alley"  # index 0 of the sorted tracks
    assert run.logdir.endswith("shutterstock_track_0_midas_True/0")
    assert type(step.net_sf) is FCNUnet and not step.chain_fused
    assert isinstance(step.opt_depth, torch.optim.SGD)
    run.train()

    with open(os.path.join(run.logdir, "epoch_loss.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [1, 2]
    for r in rows:
        assert all(np.isfinite(float(r[k])) for k in GRAD_KEYS)
    assert float(rows[0]["grad_norm_depth"]) == 0.0
    assert float(rows[0]["grad_max_depth"]) == 0.0
    assert float(rows[1]["grad_norm_depth"]) > 0.0
    assert float(rows[1]["grad_max_depth"]) > 0.0
    assert all(float(r["grad_norm_sf"]) > 0.0 for r in rows)

    ckpt = read_checkpoint(os.path.join(run.logdir, "checkpoint.pt"))
    for sd in ckpt["optimizers"]:
        assert sd["state"] and all("momentum_buffer" in s
                                   for s in sd["state"].values())
        assert sd["param_groups"][0]["dampening"] == 0.1
    resumed = cli.build_run(["--full_logdir", run.logdir, "--resume", "-1",
                             "--epoch", "3"] + common)
    rstep = resumed.model.step
    assert resumed.start_epoch == 3
    assert isinstance(rstep.opt_sf, torch.optim.SGD)
    assert state_equal([o.state_dict() for o in rstep.optimizers],
                        ckpt["optimizers"])
    assert state_equal([rstep.net_depth.state_dict(),
                         rstep.net_sf.state_dict()], ckpt["nets"])

    out = tmp_path / "test_results" / "shutterstock" / "track_alley"
    with open(out / "epochbest_test.json") as f:
        summary = json.load(f)
    assert summary["frames"] == 4 and summary["launches"]["mlp_fwd"] == 0
    assert (out / "epochbest_test" / "batch0003.npz").is_file()


def test_bf16_run_and_test_entry(tmp_path):
    """``--mixed_precision_training`` through the train entry and the test
    entry: the test entry predicts in the checkpoint's compute dtype, so
    its npz depth equals an in-process bfloat16 ``predict`` of ``best.pt``
    bit for bit, and differs from a float32 one."""
    from dynamic_video_depth_tpu_torch import test as test_entry
    from dynamic_video_depth_tpu_torch.data import get_dataset
    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        load_checkpoint, load_opt)
    from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import (
        Model)

    root = str(tmp_path / "davis")
    make_track(root, track="dog", n_frames=4, h=32, w=48, gaps=(1,))
    logdir = str(tmp_path / "run")
    run = cli.build_run([
        "--track_id", "dog", "--gaps", "1", "--data_root", root,
        "--depth_net", "tiny", "--mixed_precision_training", "--epoch", "2",
        "--warm_sf", "1", "--epoch_batches", "2", "--vali_batches", "2",
        "--batch_size", "1", "--time_dependent", "--use_disp", "--device",
        "cpu", "--full_logdir", logdir, "--manual_seed", "0"])
    assert run.model.step.compute_dtype == torch.bfloat16
    hist = run.train().history
    assert all(np.isfinite(r["loss"]) for r in hist)
    test_entry.main(["--checkpoint_path", logdir, "--output_dir",
                     str(tmp_path / "test"), "--device", "cpu"])

    opt = Namespace(**load_opt(logdir))
    preds = {}
    for dtype in (True, False):
        opt.mixed_precision_training = dtype
        model = Model(opt, device="cpu", pretrained=False)
        load_checkpoint(os.path.join(logdir, "best.pt"), model.step)
        ds = get_dataset(opt.dataset)(opt, "vali")
        preds[dtype] = [model.step.predict(to_device(ds[i], "cpu"))
                        ["depth"].numpy() for i in range(len(ds))]
    for i, depth in enumerate(preds[True]):
        dump = np.load(tmp_path / "test" / "epochbest_test" /
                       f"batch{i:04d}.npz")
        np.testing.assert_array_equal(dump["depth"], depth)
        assert not np.array_equal(depth, preds[False][i])
