"""The port's data-parallel and fleet steps (``parallel/``) against the JAX
package's single-device step, on gloo ranks on the CPU.

One ``torch.multiprocessing.spawn`` per world size (2 and 4) runs every
case in ``tests/torch_parallel_worker.py`` (a ``file://`` rendezvous in
``tmp_path``, one thread a rank); the parent holds the ranks' results
against the oracles at the tiny configuration of ``tests/test_parallel.py``
at 16x24, a warm-up step at gap 1 and a main step at gap 2:

- ``DataParallelStep`` at batch 4 over 2 and 4 ranks, unfused, fused (the
  plain versions of kernels C and D, MiDaS masks) and with SGD, against the
  JAX step at batch 4 (``rtol 1e-5`` on the losses, ``rtol 1e-4, atol
  1e-6`` on both nets' parameters, the tolerances of
  ``test_torch_step.py``) and against the port's own one-process step at
  batch 4 (``OWN_LOSS_RTOL``, ``OWN_PARAM_TOL``: the ranks' sums differ from
  the one-process sums by float32 rounding only);
- ``MultiVideoOptimizer`` with 4 videos on 4 ranks, each against the JAX
  step on its own video, and ``MultiVideoDataParallel`` with 2 videos x 2
  ranks, each video against the JAX step at its batch of 2;
- every rank of a video ends with its row's parameters bit for bit (the
  ranks start from different nets, which the broadcast equalizes);
- ``place`` refuses a batch of 3 over 2 and over 4 ranks before any
  collective.

The batch's mask density and flow scale differ from pair to pair, so a
per-rank mask mass gives other losses than the global one, and the SGD
case moves the parameters far past the tolerance, so a mean of the
ranks' gradients in place of their sum gives other parameters:
``test_fixture_tells_global_from_per_rank_reductions`` checks both
margins.
"""

import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
import torch_parallel_worker as worker
from dynamic_video_depth_tpu.train import LossConfig as JaxLossConfig
from dynamic_video_depth_tpu.train import TrainStepConfig as JaxConfig
from dynamic_video_depth_tpu.train.step import (
    SceneFlowMotionFieldStep as JaxStep)
from dynamic_video_depth_tpu_torch.runtime import weights
from dynamic_video_depth_tpu_torch.train import LossConfig, TrainStepConfig
from torch_threads import one_torch_thread  # noqa: F401

LOG_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")
SCHEDULE = ((1, True), (2, False))
H, W = 16, 24
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
OWN_LOSS_RTOL = 1e-6
OWN_PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
MASK_DENSITY = (0.9, 0.4, 0.7, 0.2)
FLOW_SCALE = (1.0, 3.0, 0.5, 2.0)
CONFIGS = ("unfused", "fused", "sgd")
WORLDS = (2, 4)


def _configs(name):
    """(JAX config on its plain XLA paths, port config) of a case."""
    fused = name == "fused"
    net = dict(lr=1e-2 if name == "sgd" else 1e-4, scene_lr_mul=10.0,
               depth_net="tiny", net_width=16, n_layers=1, n_freq_xyz=2,
               n_freq_t=1, optim="sgd" if name == "sgd" else "adam")
    loss = dict(flow_mul=1.0, disp_mul=1.0, acc_mul=1.0, use_disp=True,
                midas=fused)
    mode = "on" if fused else "off"
    jax_cfg = JaxConfig(**net, loss=JaxLossConfig(**loss),
                        compute_dtype="float32", use_pallas_sf="off",
                        use_pallas_sf_chain="off", use_pallas_warp="off",
                        use_pallas_loss="off")
    return jax_cfg, TrainStepConfig(**net, loss=LossConfig(**loss),
                                    use_pallas_sf_chain=mode,
                                    use_pallas_loss=mode)


def _batch(b, seed, first=0):
    """The synthetic pairs with their own mask densities and flow scales
    from pair ``first`` of ``MASK_DENSITY`` / ``FLOW_SCALE`` on."""
    rng = np.random.RandomState(seed)
    batch = {k: np.array(v) for k, v in
             graft._synthetic_batch(b, H, W, rng).items()}
    dens = np.asarray(MASK_DENSITY[first:first + b], np.float32)
    batch["mask_2"] = (rng.rand(b, H, W) < dens[:, None, None]).astype(
        np.float32)
    batch["flow_1_2"] *= np.asarray(FLOW_SCALE[first:first + b],
                                    np.float32)[:, None, None, None]
    return batch


def _jax_run(jax_cfg, init_state, batch):
    """The JAX step over ``SCHEDULE``: (logs, final state)."""
    step = JaxStep(jax_cfg)
    state = jax.tree.map(jnp.copy, init_state)
    logs = []
    for s, w in SCHEDULE:
        state, out = step.train_step(state, batch, steps=s, warm=w)
        logs.append({k: float(out[k]) for k in LOG_KEYS})
    return logs, state


def _init(jax_cfg, batch):
    state = JaxStep(jax_cfg).init_state(jax.random.PRNGKey(3),
                                        batch["img_1"][:1])
    np_tree = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32),
                                     dict(t))
    return state, ({"params": np_tree(state.params_depth)},
                   {"params": np_tree(state.params_sf)})


@pytest.fixture(scope="module")
def oracle():
    """Per case: its inputs and the JAX and one-process port results."""
    out = {}
    full = _batch(4, seed=0)
    for name in CONFIGS:
        jax_cfg, cfg = _configs(name)
        state0, init = _init(jax_cfg, full)
        jax_logs, jax_state = _jax_run(jax_cfg, state0, full)
        step = worker.make_step(cfg, init)
        own_logs = worker.run_steps(step, worker._tensors(full), SCHEDULE)
        out[name] = dict(cfg=cfg, init=init, batch=full, jax_logs=jax_logs,
                         jax_state=jax_state, own_logs=own_logs,
                         own_state=worker.numpy_state(step))
    jax_cfg, cfg = _configs("unfused")
    videos = [_batch(1, seed=10 + v, first=v) for v in range(4)]
    rows = [_batch(2, seed=20 + v, first=2 * v) for v in range(2)]
    state0, init = _init(jax_cfg, videos[0])
    out["videos"] = dict(cfg=cfg, init=init, batches=videos,
                         jax=[_jax_run(jax_cfg, state0, b) for b in videos])
    out["rows"] = dict(cfg=cfg, init=init, batches=rows,
                       jax=[_jax_run(jax_cfg, state0, b) for b in rows])
    return out


def _spawn(tmp_path, world, cases):
    d = tmp_path / f"world{world}"
    d.mkdir()
    cases_file = str(d / "cases.pkl")
    with open(cases_file, "wb") as f:
        pickle.dump(cases, f)
    torch.multiprocessing.spawn(
        worker.run, args=(world, str(d / "rendezvous"), cases_file, str(d)),
        nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def runs(oracle, tmp_path_factory):
    """Every world size's cases, one spawn each: {world: [rank results]}."""
    tmp = tmp_path_factory.mktemp("parallel")
    out = {}
    for world in WORLDS:
        cases = {f"dp_{n}": dict(kind="dp", cfg=oracle[n]["cfg"],
                                 init=oracle[n]["init"],
                                 batch=oracle[n]["batch"], schedule=SCHEDULE)
                 for n in CONFIGS}
        bad = {k: (v[:3] if np.ndim(v) else v)
               for k, v in oracle["unfused"]["batch"].items()}
        cases["place"] = dict(kind="place", cfg=oracle["unfused"]["cfg"],
                              init=oracle["unfused"]["init"], batch=bad)
        if world == 4:
            for kind, key in (("mvo", "videos"), ("mvdp", "rows")):
                o = oracle[key]
                cases[kind] = dict(kind=kind, cfg=o["cfg"], init=o["init"],
                                   batches=o["batches"], schedule=SCHEDULE)
        out[world] = _spawn(tmp, world, cases)
    return out


def _check_logs(logs, ref, rtol):
    assert len(logs) == len(ref) == len(SCHEDULE)
    for ours, want in zip(logs, ref):
        for k in LOG_KEYS:
            np.testing.assert_allclose(ours[k], want[k], rtol=rtol,
                                       err_msg=k)
    assert logs[0]["acc_reg"] == 0.0 and logs[1]["acc_reg"] > 0.0


def _check_params_jax(state, init, jax_state):
    for sd, tmpl, ref in ((state[0], init[0], jax_state.params_depth),
                          (state[1], init[1], jax_state.params_sf)):
        ours = weights.state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in sd.items()}, tmpl)["params"]
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree.leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), **PARAM_TOL,
                                       err_msg=str(path))


def _check_bit_equal(states):
    for other in states[1:]:
        for a, b in zip(states[0], other):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_matches_jax_step(runs, oracle, world, name):
    o = oracle[name]
    for r in range(world):
        res = runs[world][r][f"dp_{name}"]
        _check_logs(res["logs"], o["jax_logs"], LOSS_RTOL)
        _check_params_jax(res["state"], o["init"], o["jax_state"])


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_matches_one_process_step(runs, oracle, world, name):
    o = oracle[name]
    res = runs[world][0][f"dp_{name}"]
    _check_logs(res["logs"], o["own_logs"], OWN_LOSS_RTOL)
    for ours, want in zip(res["state"], o["own_state"]):
        for k in want:
            np.testing.assert_allclose(ours[k], want[k], **OWN_PARAM_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_replicas_stay_bit_equal(runs, world):
    for name in CONFIGS:
        _check_bit_equal([runs[world][r][f"dp_{name}"]["state"]
                          for r in range(world)])
    if world == 4:
        for row in ((0, 1), (2, 3)):
            _check_bit_equal([runs[4][r]["mvdp"]["state"] for r in row])


@pytest.mark.parametrize("video", range(4))
def test_multi_video_optimizer_matches_jax_step(runs, oracle, video):
    o = oracle["videos"]
    res = runs[4][video]["mvo"]
    jax_logs, jax_state = o["jax"][video]
    _check_logs(res["logs"], jax_logs, LOSS_RTOL)
    _check_params_jax(res["state"], o["init"], jax_state)


@pytest.mark.parametrize("video", range(2))
def test_multi_video_data_parallel_matches_jax_step(runs, oracle, video):
    o = oracle["rows"]
    jax_logs, jax_state = o["jax"][video]
    for r in (2 * video, 2 * video + 1):
        res = runs[4][r]["mvdp"]
        _check_logs(res["logs"], jax_logs, LOSS_RTOL)
        _check_params_jax(res["state"], o["init"], jax_state)


@pytest.mark.parametrize("world", WORLDS)
def test_place_refuses_an_indivisible_batch(runs, world):
    for r in range(world):
        err = runs[world][r]["place"]["error"]
        assert err is not None and "not divisible" in err


def test_fixture_tells_global_from_per_rank_reductions(oracle):
    """A per-rank mask mass or a mean of the ranks' gradients would miss
    the oracles by far more than the tolerances."""
    o = oracle["unfused"]
    step = worker.make_step(o["cfg"], o["init"])
    whole = o["jax_logs"][0]["loss"]
    for world in WORLDS:
        n = 4 // world
        shares = [{k: (v[i:i + n] if np.ndim(v) else v)
                   for k, v in o["batch"].items()} for i in range(0, 4, n)]
        with torch.no_grad():
            per_rank = np.mean([float(step.loss_and_logs(
                worker._tensors(h), 1, True)[1]["loss"]) for h in shares])
        assert abs(per_rank - whole) > 100 * LOSS_RTOL * abs(whole)
    # SGD: the updates are lr x the gradient; a mean over two ranks would
    # move the parameters half as far
    s = oracle["sgd"]
    init = weights.flax_to_state_dict(s["init"][1])
    margin = max(np.max(np.abs(v - init[k].numpy()) / 2
                        / (PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(v)))
                 for k, v in s["own_state"][1].items())
    assert margin > 10
