"""The port's input pipeline and profiler against the JAX package's: the
reader thread's order, early exit and errors; the prefetcher's host/device
split; the dataset's ``--repeat``, ``--overfit``/``--capat`` and ``--cache``
samples bit for bit; gap bucketing; the device cache; ``trace_if`` and
``annotate``; and the trainer's data path: cached and streaming runs give
the same losses bit for bit and visit the JAX trainer's pairs, the
pipelined logs reach the loggers complete and in order, a NaN stops the run
within ``LOG_PIPELINE_DEPTH`` steps, and ``--profile_dir`` traces epoch
``min(2, --epoch)``. Inputs are synthetic tracks made from a seed."""

import argparse
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dynamic_video_depth_tpu_torch.data import prefetch
from dynamic_video_depth_tpu_torch.data.batches import to_device
from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
from dynamic_video_depth_tpu_torch.data.synthetic import make_track
from dynamic_video_depth_tpu_torch.runtime import profiling
from dynamic_video_depth_tpu_torch.runtime.loggers import (BaseLogger,
                                                           ComposeLogger,
                                                           TerminateOnNaN)
from dynamic_video_depth_tpu_torch.train import cli, loop
from dynamic_video_depth_tpu_torch.train.loop import (LOG_KEYS,
                                                      LOG_PIPELINE_DEPTH)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("prefetch"))
    make_track(r, track="dog", n_frames=8, h=16, w=24, gaps=(1, 2))
    return r


def opt_for(root, **kw):
    base = dict(track_id="dog", gaps="1,2", repeat=1, subsample=False,
                cache=False, overfit=False, capat=1, select=False,
                data_root=root)
    base.update(kw)
    return argparse.Namespace(**base)


# ------------------------------------------------------- loader, prefetcher

def test_loader_preserves_order(root):
    ds = Dataset(opt_for(root))
    order = [3, 0, 2, 3]
    assert [i for i, _ in prefetch.BatchLoader(ds, order)] == order


def test_loader_converts_on_its_thread_without_pinning_on_the_cpu(root):
    ds = Dataset(opt_for(root))
    (i, batch), = list(prefetch.BatchLoader(ds, [1], device="cpu"))
    assert i == 1 and isinstance(batch["img_1"], torch.Tensor)
    assert not batch["img_1"].is_pinned()
    assert torch.equal(batch["img_1"], torch.from_numpy(ds[1]["img_1"]))
    assert batch["steps"] == ds[1]["steps"]


def test_prefetcher_yields_all_with_the_host_device_split(root):
    ds = Dataset(opt_for(root))
    out = list(prefetch.DevicePrefetcher(
        prefetch.BatchLoader(ds, range(4), device="cpu"), "cpu"))
    assert [i for i, _, _ in out] == list(range(4))
    for i, dev, host in out:
        assert set(host) == {"pair_path", "steps"}
        assert "img_1" in dev and "steps" not in dev
        want = to_device(ds[i], "cpu")
        assert dev.keys() == want.keys()
        assert all(torch.equal(dev[k], want[k]) for k in want)


def test_split_host_device_matches_jax_apart_from_the_window():
    from dynamic_video_depth_tpu.data import prefetch as jax_prefetch

    batch = {"img_1": np.zeros(2), "pair_path": "p", "steps": 2,
             "time_step": np.float32(0.1)}
    assert prefetch.split_host_device(batch) == \
        jax_prefetch.split_host_device(batch)
    assert set(jax_prefetch._HOST_KEYS_SKIP) - set(prefetch.HOST_KEYS) == \
        {"warp_window"}


def test_loader_early_exit_leaves_no_thread():
    """Abandoning the iterator (the NaN guard, an exception) ends the
    reader thread instead of leaving it parked on a full queue."""

    class Slow:
        def __getitem__(self, i):
            return {"x": i}

    before = threading.active_count()
    it = iter(prefetch.BatchLoader(Slow(), order=list(range(100)),
                                   queue_size=2))
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_loader_raises_a_reader_error_on_the_main_thread():
    class Broken:
        def __getitem__(self, i):
            if i == 2:
                raise KeyError("no such pair")
            return {"x": np.float32(i)}

    seen = []
    with pytest.raises(KeyError, match="no such pair"):
        for i, _ in prefetch.BatchLoader(Broken(), range(5)):
            seen.append(i)
    assert seen == [0, 1]


# ---------------------------------------------------------- dataset flags

def _samples_equal(a, b):
    assert sorted(set(a) - {"warp_window"}) == sorted(set(b)
                                                      - {"warp_window"})
    for k in a:
        if k == "warp_window":
            continue
        if isinstance(a[k], str) or np.ndim(a[k]) == 0 and \
                not isinstance(a[k], np.ndarray):
            assert a[k] == b[k], k
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("mode", ["train", "vali"])
@pytest.mark.parametrize("flags", [
    {"repeat": 3}, {"overfit": True, "capat": 2},
    {"overfit": True, "capat": 3, "repeat": 2}, {"cache": True},
    {"select": True}])
def test_dataset_flags_give_the_jax_samples(root, flags, mode):
    from dynamic_video_depth_tpu.data import get_dataset

    opt = opt_for(root, **flags)
    ours = Dataset(opt, mode)
    ref = get_dataset("davis_sequence")(opt, mode)
    assert len(ours) == len(ref)
    assert ours.file_list == ref.file_list
    for i in range(len(ref)):
        if mode == "train":
            assert ours.gap_of(i) == ref.gap_of(i)
        _samples_equal(ours[i], ref[i])


def test_repeat_and_overfit(root):
    ds = Dataset(opt_for(root, repeat=3))
    assert len(ds) == 3 * len(ds.file_list)
    ds = Dataset(opt_for(root, overfit=True, capat=2))
    assert ds[0]["frame_id_1"][0] == ds[2]["frame_id_1"][0]  # 2 -> 0


@pytest.mark.parametrize("repeat", [1, 2])
def test_gap_bucketing_matches_jax(root, repeat):
    from dynamic_video_depth_tpu.train.loop import group_by_gap as jax_groups

    ds = Dataset(opt_for(root, repeat=repeat))
    ours = loop.group_by_gap(ds)
    assert ours == jax_groups(ds.gap_of, len(ds.file_list))
    assert set(ours) == {1, 2}
    for g, idxs in ours.items():
        for i in idxs:
            s = ds[i]
            assert int(s["frame_id_2"][0] - s["frame_id_1"][0]) == g


def test_host_cache_hits(root):
    ds = Dataset(opt_for(root, cache=True, repeat=2))
    n = len(ds.file_list)
    assert ds[0] is ds[0] and ds[n] is ds[0]  # keyed by the reduced index


def test_device_cache_keeps_what_to_device_gives(root):
    ds = Dataset(opt_for(root))
    cache = prefetch.DeviceCache(ds, "cpu")
    dev, host = cache.get(1)
    again, _ = cache.get(1)
    assert all(again[k] is dev[k] for k in dev)
    want = to_device(ds[1], "cpu")
    assert all(torch.equal(dev[k], want[k]) for k in want)
    assert host == {"pair_path": ds.file_list[1], "steps": ds[1]["steps"]}
    assert 1 in cache and 0 not in cache
    cache.get(0)
    assert cache.nbytes == sum(t.numel() * t.element_size()
                               for i in cache.keys()
                               for t in cache.get(i)[0].values())
    assert cache[1]["steps"] == host["steps"]
    small = prefetch.DeviceCache(ds, "cpu", max_bytes=cache.nbytes // 2)
    small.get(0)
    small.get(1)
    assert list(small.keys()) == [0] and small.nbytes == cache.nbytes // 2


def test_device_cache_needs_a_device(root):
    with pytest.raises(TypeError):
        prefetch.DeviceCache(Dataset(opt_for(root)))


# ------------------------------------------------------------- profiling

def test_trace_if_writes_a_trace(tmp_path):
    out = str(tmp_path / "prof")
    with profiling.trace_if(out, True):
        with profiling.annotate("dvd/probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(out, profiling.TRACE_NAME)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "dvd/probe" in names
    with profiling.trace_if(str(tmp_path / "prof2"), False):
        pass
    with profiling.trace_if(None, True):
        pass
    assert not os.path.exists(tmp_path / "prof2")


def test_annotate_off_builds_no_record_function(monkeypatch):
    """With no profiler active a span is the one shared null context."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.annotate("dvd/a"), profiling.annotate("dvd/b")
    assert a is b
    with a, b:
        pass


# ------------------------------------------------------------ the trainer

class PairList:
    """A DAVIS-like training set of packed-pair file names by gap, with
    ``--repeat``'s index mapping; a sample carries only its file index."""

    def __init__(self, repeat=1):
        self.file_list = [f"shuffle_False_gap_{g:02d}_{k:03d}.pt"
                          for g, n in ((1, 9), (2, 8), (4, 6))
                          for k in range(n)]
        self.repeat = repeat

    def __len__(self):
        return len(self.file_list) * self.repeat

    def gap_of(self, idx):
        return int(self.file_list[idx % len(self.file_list)]
                   .split("_gap_")[1][:2])

    def __getitem__(self, idx):
        idx = idx % len(self.file_list)
        return {"idx": np.array([idx], np.int64), "steps": self.gap_of(idx)}


def _opt(batch_size, no_device_cache, epoch_batches=None, **kw):
    base = dict(manual_seed=0, batch_size=batch_size, no_batching=False,
                epoch=3, epoch_batches=epoch_batches, warm_sf=1,
                vali_batches=None, vali_at_start=False, steps_per_dispatch=1,
                no_device_cache=no_device_cache, log_time=False,
                profile_dir=None)
    base.update(kw)
    return SimpleNamespace(**base)


class _Recorder:
    """Stands in for the port's step: records each step's file indices and
    returns the step's number as its loss (NaN at ``nan_at``)."""

    device = "cpu"

    def __init__(self, nan_at=None):
        self.seen, self.nan_at = [], nan_at

    def train_step(self, batch, steps, warm):
        self.seen.append(tuple(int(v) for v in batch["idx"].tolist()))
        n = len(self.seen) - 1
        loss = float("nan") if n == self.nan_at else float(n)
        return {k: torch.tensor(loss if k == "loss" else 0.0)
                for k in LOG_KEYS}


class _JaxRecorder:
    def __init__(self):
        self.seen = []

    def train_on_batch(self, epoch, i, dev, warm=False, steps=None,
                       warp_window=None):
        self.seen.append(tuple(int(v) for v in np.asarray(dev["idx"])))
        return {"loss": 0.0}


@pytest.mark.parametrize("no_device_cache", [False, True])
@pytest.mark.parametrize("batch_size", [1, 4])
@pytest.mark.parametrize("repeat", [1, 2])
def test_trainers_visit_the_jax_pairs(repeat, batch_size, no_device_cache):
    from dynamic_video_depth_tpu.runtime.loggers import ComposeLogger as JC
    from dynamic_video_depth_tpu.train.loop import Trainer as JaxTrainer

    opt = _opt(batch_size, no_device_cache)
    model = _JaxRecorder()
    JaxTrainer(model, PairList(repeat), None, JC([]), opt).train()
    step = _Recorder()
    loop.Trainer(step, PairList(repeat), None, opt).train()
    assert step.seen == model.seen
    n_files = len(PairList().file_list)
    if batch_size == 1:
        assert len(step.seen) == 3 * n_files * repeat
    else:  # the groups come from the files, once each
        assert len(step.seen) == 3 * (9 // 4 + 8 // 4 + 6 // 4)


def test_cache_and_reader_thread_under_fast_switching():
    """The reader thread checks the cache while the consumer fills it: with
    a switch interval of a microsecond and every index used many times,
    each index is kept once, every use hands back the kept tensors, and
    the cache's bytes are its batches' sizes."""
    trainer = loop.Trainer(_Recorder(), PairList(), None, _opt(1, False))
    cache = trainer.train_source
    order = list(np.random.RandomState(1).randint(0, len(cache), 600))
    first = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for gi, dev, host in trainer.iter_batches(cache, order):
            kept = first.setdefault(gi, dev)
            assert all(dev[k] is kept[k] for k in kept)
            assert int(dev["idx"][0]) == trainer.groups[gi][0]
    finally:
        sys.setswitchinterval(old)
    assert sorted(cache.keys()) == sorted(first)
    assert cache.nbytes == sum(t.numel() * t.element_size()
                               for d in first.values() for t in d.values())


class _Recording(BaseLogger):
    def __init__(self):
        super().__init__()
        self.batches = []

    def on_batch_end(self, batch, logs=None):
        self.batches.append((batch, logs["loss"], logs["size"]))


def test_pipelined_logs_reach_the_loggers_in_order():
    steps = 2 * LOG_PIPELINE_DEPTH + 3
    rec = _Recording()
    step = _Recorder()
    trainer = loop.Trainer(step, PairList(), None,
                           _opt(1, False, epoch_batches=steps, epoch=2),
                           logger=ComposeLogger([rec, TerminateOnNaN()]))
    trainer.train()
    want = [(i, float(e * steps + i), 1) for e in range(2)
            for i in range(steps)]
    assert rec.batches == want
    assert [r["loss"] for r in trainer.history] == [float(n) for n in
                                                   range(2 * steps)]
    assert [r["epoch"] for r in trainer.history] == [1] * steps + [2] * steps
    assert all(r["seconds"] >= 0 and r["interval"] >= 0
               for r in trainer.history)


def test_nan_stops_the_run_within_the_pipeline_depth():
    nan_at = 5
    step = _Recorder(nan_at=nan_at)
    trainer = loop.Trainer(step, PairList(), None,
                           _opt(1, False, epoch_batches=60, epoch=1))
    before = threading.active_count()
    with pytest.raises(FloatingPointError):
        trainer.train()
    assert nan_at < len(step.seen) <= nan_at + 1 + LOG_PIPELINE_DEPTH
    losses = [r["loss"] for r in trainer.history]
    assert losses[:nan_at] == [float(n) for n in range(nan_at)]
    assert len(losses) == nan_at + 1 and np.isnan(losses[-1])
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


FLAGS = ["--net", "scene_flow_motion_field", "--dataset", "davis_sequence",
         "--track_id", "dog", "--gaps", "1,2", "--warm_sf", "1",
         "--lr", "1e-4", "--scene_lr_mul", "10", "--time_dependent",
         "--use_disp", "--vali_batches", "2", "--depth_net", "tiny",
         "--manual_seed", "0", "--device", "cpu", "--save_net", "0",
         "--vis_every_train", "0", "--vis_every_vali", "0"]


@pytest.mark.parametrize("batch_size,repeat", [(1, 1), (1, 2), (4, 1)])
def test_cached_and_streaming_trainers_match(root, tmp_path, batch_size,
                                             repeat):
    """The same losses bit for bit and the same parameters, at the JAX
    trainer's pairs: the cache changes where a batch comes from, not what
    it holds."""
    runs = {}
    for cached in (True, False):
        argv = FLAGS + ["--data_root", root, "--epoch", "2",
                        "--batch_size", str(batch_size), "--repeat",
                        str(repeat), "--logdir", str(tmp_path / str(cached))]
        if batch_size == 1:
            argv += ["--epoch_batches", "6"]
        if not cached:
            argv.append("--no_device_cache")
        trainer = cli.build_trainer(argv)
        seen = []
        train_step = trainer.step.train_step

        def recording(batch, steps, warm, _seen=seen, _f=train_step):
            _seen.append(batch["frame_id_1"].tolist())
            return _f(batch, steps, warm)

        trainer.step.train_step = recording
        trainer.train()
        assert isinstance(trainer.train_source,
                          prefetch.DeviceCache) == cached
        runs[cached] = (trainer, seen)
    (cached, seen_c), (streamed, seen_s) = runs[True], runs[False]
    assert seen_c == seen_s and len(seen_c) > 0
    assert all(len(s) == batch_size for s in seen_c)
    keys = LOG_KEYS
    assert [[r[k] for k in keys] for r in cached.history] == \
        [[r[k] for k in keys] for r in streamed.history]
    for net in ("net_depth", "net_sf"):
        for p, q in zip(getattr(cached.step, net).parameters(),
                        getattr(streamed.step, net).parameters()):
            assert torch.equal(p, q)
    # every cached batch is a fresh to_device of its files, bit for bit:
    # no step wrote into one
    cache = cached.train_source
    assert len(list(cache.keys())) > 0
    for gi in cache.keys():
        fresh = to_device(cache.dataset[gi], "cpu")
        dev = cache.get(gi)[0]
        assert all(torch.equal(dev[k], fresh[k]) for k in fresh)
    assert cache.nbytes == sum(t.numel() * t.element_size()
                               for gi in cache.keys()
                               for t in cache.get(gi)[0].values())


@pytest.mark.parametrize("epochs,traced", [(1, 1), (3, 2)])
def test_profile_dir_traces_one_epoch(root, tmp_path, monkeypatch, epochs,
                                      traced):
    calls = []
    real = loop.trace_if

    def spy(logdir, enabled=True):
        calls.append(enabled)
        return real(logdir, enabled)

    monkeypatch.setattr(loop, "trace_if", spy)
    prof = str(tmp_path / "prof")
    trainer = cli.build_trainer(FLAGS + [
        "--data_root", root, "--epoch", str(epochs), "--batch_size", "1",
        "--epoch_batches", "3", "--profile_dir", prof,
        "--logdir", str(tmp_path / "run")])
    trainer.train()
    assert calls == [e == traced for e in range(1, epochs + 1)]
    with open(os.path.join(prof, profiling.TRACE_NAME)) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("dvd/data_wait") == 3
    assert names.count("dvd/log_flush") == 3
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events if e.get("ph") == "X"
                    and str(e.get("name")).startswith("dvd/")),
                   key=lambda s: (s[0], -s[1]))
    steps = [s for s in spans if s[2] == "dvd/step"]
    assert len(steps) == 3
    for a, b, _ in steps:
        inner = {n: (s, e) for s, e, n in spans if a <= s and e <= b
                 and n != "dvd/step"}
        assert [n for s, e, n in spans if a <= s and e <= b] == [
            "dvd/step", "dvd/loss", "dvd/depth_net", "dvd/field",
            "dvd/backward", "dvd/optim"]
        loss = inner["dvd/loss"]
        for n in ("dvd/depth_net", "dvd/field"):
            assert loss[0] <= inner[n][0] and inner[n][1] <= loss[1]
        assert inner["dvd/depth_net"][1] <= inner["dvd/field"][0]
        assert loss[1] <= inner["dvd/backward"][0]
        assert inner["dvd/backward"][1] <= inner["dvd/optim"][0]


@pytest.fixture(scope="module")
def gaps_root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("gaps"))
    make_track(r, track="dog", n_frames=12, h=16, w=24, gaps=(1, 2, 4, 6, 8))
    return r


@pytest.mark.parametrize("gap", [1, 2, 4, 6, 8])
def test_step_runs_the_work_the_benchmark_counts(gaps_root, tmp_path, gap):
    """A main step queries the field ``max(2, gap)`` times at every point,
    the evaluations that ``benchmark/workcount.py::field_work`` counts, and
    runs the depth net once on 2 x batch frames, the images that
    ``benchmark/harness.py::depth_work`` counts."""
    batch, h, w = 2, 16, 24
    trainer = cli.build_trainer(FLAGS + [
        "--data_root", gaps_root, "--gaps", str(gap), "--epoch", "2",
        "--batch_size", str(batch), "--epoch_batches", "2",
        "--logdir", str(tmp_path / "run")])
    st = trainer.step
    assert not st.chain_fused  # one ``_apply_sf`` call an evaluation
    steps_seen = []  # a training step's gap, warm, field and depth inputs
    inside = []      # non-empty while a training step runs
    train_step, apply_sf, apply_depth = (st.train_step, st._apply_sf,
                                         st._apply_depth)

    def counted_step(batch, steps, warm, **kw):
        steps_seen.append((steps, warm, [], []))
        inside.append(True)
        try:
            return train_step(batch, steps=steps, warm=warm, **kw)
        finally:
            inside.pop()

    def counted_sf(pts, ts):
        if inside:
            steps_seen[-1][2].append(tuple(pts.shape[:-1]))
        return apply_sf(pts, ts)

    def counted_depth(img):
        if inside:
            steps_seen[-1][3].append(tuple(img.shape))
        return apply_depth(img)

    st.train_step, st._apply_sf, st._apply_depth = (counted_step, counted_sf,
                                                    counted_depth)
    trainer.train()
    main = [r for r in steps_seen if not r[1]]
    assert len(main) == 2
    for steps, _, queries, depths in main:
        assert steps == gap
        assert queries == [(batch, h, w)] * max(2, gap)
        assert depths == [(2 * batch, h, w, 3)]
