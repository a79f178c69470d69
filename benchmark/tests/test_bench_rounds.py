"""The window's epoch holds whole rounds: with the track's equal number of
pairs a gap and ``epoch_batches = groups x rounds``, the port's trainer
visits every batch once a round and every gap equally often, for any
seed."""

import argparse
import collections

import pytest
import torch

from benchmark import track
from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
from dynamic_video_depth_tpu_torch.train.loop import Trainer

GAPS = (1, 2, 4, 6, 8)


class _Step:
    device = torch.device("cpu")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("track"))
    track.make_track(root, "bench", 16, 32, GAPS, 16, seed=5)
    return root


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345])
def test_rounds_hold_every_gap_equally(data_root, batch, seed):
    per_gap = 1 if batch == 1 else 2
    opt = argparse.Namespace(
        track_id="bench", gaps=",".join(map(str, GAPS)), subsample=False,
        data_root=data_root, batch_size=batch, no_batching=False,
        manual_seed=seed % 2 ** 32, no_device_cache=True, repeat=1)
    ds = Dataset(opt, "train")
    if batch == 1:  # one pair a gap, as the batch-1 mixes write it
        ds.file_list = [f for f in ds.file_list if f.endswith("_00000.pt")]
    trainer = Trainer(_Step(), ds, None, opt)
    n = len(trainer.groups)
    assert n == per_gap * len(GAPS)
    rounds = 7
    order = trainer.epoch_order(n, n * rounds)
    assert len(order) == n * rounds
    for r in range(rounds):
        chunk = order[r * n:(r + 1) * n]
        assert sorted(chunk) == list(range(n))
        gaps = collections.Counter(ds.gap_of(trainer.groups[g][0])
                                   for g in chunk)
        assert gaps == {g: per_gap for g in GAPS}


def test_track_has_equal_pairs_a_gap(data_root):
    opt = argparse.Namespace(track_id="bench", gaps="1,2,4,6,8",
                             subsample=False, data_root=data_root)
    ds = Dataset(opt, "train")
    counts = collections.Counter(ds.gap_of(i) for i in range(len(ds)))
    assert counts == {g: 16 for g in GAPS}
    sample = ds[len(ds) - 1]
    assert sample["steps"] == 8
    assert float(sample["frame_id_2"][0] - sample["frame_id_1"][0]) == 8


def test_every_seed_gets_the_traffics_order():
    from benchmark import harness, spec

    for w in spec.benchmark_json()["workloads"]:
        cell = spec.load_cell(w["name"])
        argv = harness.recipe_argv(cell, "root", "logdir", "cuda")
        assert argv[argv.index("--manual_seed") + 1] == str(
            cell.traffic["order_seed"])
