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
- ``--log_grad_stats``: the four statistics at rtol 1e-5, the depth terms
  exactly 0 in warm-up.

The variant nets are held in ``test_torch_variant_nets.py`` and the
ShutterStock recipe and the entries in ``test_torch_variant_entries.py``,
with this module's helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dynamic_video_depth_tpu.train import LossConfig as JaxLossConfig
from dynamic_video_depth_tpu.train import TrainStepConfig as JaxConfig
from dynamic_video_depth_tpu.train.step import SceneFlowMotionFieldStep as JaxStep
from dynamic_video_depth_tpu_torch.runtime import weights
from dynamic_video_depth_tpu_torch.train import (LossConfig,
                                                 SceneFlowMotionFieldStep,
                                                 TrainStepConfig)
from torch_threads import one_torch_thread  # noqa: F401

LOG_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")
GRAD_KEYS = ("grad_norm_depth", "grad_norm_sf", "grad_max_depth",
             "grad_max_sf")
NET = dict(lr=1e-4, scene_lr_mul=10.0, depth_net="tiny", net_width=32,
           n_layers=2, n_freq_xyz=4, n_freq_t=2)
STEP_RTOL = 1e-5


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
