"""The train entry's background checkpoint writer
(``runtime/checkpoint.py::AsyncSaver``) on the CPU: its files hold what a
synchronous ``save_checkpoint`` of the same state holds, bit for bit (the
JAX package's ``AsyncSaver`` writes what its ``save_state`` writes); one
snapshot an epoch, taken before the next step; a full queue blocks and
drops nothing; a failed write is raised on the caller's thread; readers,
the chained test entry and a resume see only finished files; a resumed
run takes the next step bit for bit as the unbroken run does.
"""

import gc
import os
import threading
import time
import weakref

import pytest
import torch

from dynamic_video_depth_tpu_torch.runtime import checkpoint as ck
from dynamic_video_depth_tpu_torch.train import cli

from test_torch_runtime import _equal, _run_flags, _trained_step, track_root

__all__ = ["track_root"]  # the module fixture, shared with this file


def _same_file_content(a: str, b: str) -> bool:
    """Two checkpoint files load to the same keys, types, dtypes and
    values, bit for bit (a state dict's ``_metadata`` included)."""
    x, y = ck.read_checkpoint(a), ck.read_checkpoint(b)

    def meta(t):
        if isinstance(t, dict):
            return (type(t).__name__, getattr(t, "_metadata", None),
                    {k: meta(v) for k, v in t.items()})
        if isinstance(t, (list, tuple)):
            return [meta(v) for v in t]
        return t.dtype if isinstance(t, torch.Tensor) else type(t)

    return _equal(x, y) and meta(x) == meta(y)


@pytest.fixture
def gate(monkeypatch):
    """A gate on ``torch.save``: writes wait until it is set."""
    opened = threading.Event()
    real = torch.save

    def gated(obj, f, *a, **kw):
        assert opened.wait(30), "the gate was never opened"
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", gated)
    yield opened
    opened.set()


def _open_later(event, seconds=0.3):
    timer = threading.Timer(seconds, event.set)
    timer.start()
    return timer


def test_recipe_files_equal_a_synchronous_save(tmp_path, track_root):
    """A run of two epochs: at each epoch end (after the loggers queued
    the epoch's saves) the queued files equal ``save_checkpoint`` of the
    live state; ``Run.saves`` records the writer's and the loop's times."""
    run_dir = tmp_path / "run"
    sync_dir = tmp_path / "sync"
    compared = []

    def at_epoch_end(epoch, trainer):
        run.saver.flush()
        for rec in run.saves[len(compared):]:
            ref = str(sync_dir / f"{len(compared)}.pt")
            include_opt = "optimizers" in ck.read_checkpoint(rec.path)
            epoch_in, best = (ck.read_checkpoint(rec.path)[k]
                              for k in ("epoch", "best"))
            ck.save_checkpoint(ref, run.model.step, epoch=epoch_in,
                               best=best, include_opt=include_opt)
            assert _same_file_content(rec.path, ref), rec.path
            compared.append((rec.path, epoch))

    run = cli.build_run(_run_flags(track_root, run_dir, "--epoch", "2"),
                        on_epoch_end=at_epoch_end)
    run.train()
    names = sorted({os.path.relpath(p, run_dir) for p, _ in compared})
    assert names == ["best.pt", "checkpoint.pt", "nets/0001.pt",
                     "nets/0002.pt"]
    assert len(run.saves) == len(compared) >= 5
    assert not run.saver.writing(str(run_dir))
    for rec in run.saves:
        assert rec.seconds > 0 and rec.blocking > 0
        assert rec.bytes == os.path.getsize(rec.path) or \
            rec.path.endswith(("best.pt", "checkpoint.pt"))


def test_one_snapshot_an_epoch_taken_before_the_next_step(tmp_path, gate):
    """Saves with one key share one snapshot, cloned at the first of them:
    an in-place update after it (the optimizer's step) reaches neither
    file; a new key clones anew."""
    step = _trained_step()
    saver = ck.AsyncSaver("cpu")
    before = {k: v.clone() for k, v in step.net_sf.state_dict().items()}
    saver.save(str(tmp_path / "a.pt"), step, epoch=1)
    with torch.no_grad():
        for p in step.net_sf.parameters():
            p.add_(1.0)
    saver.save(str(tmp_path / "b.pt"), step, epoch=1, include_opt=False)
    saver.save(str(tmp_path / "c.pt"), step, epoch=2)
    gate.set()
    saver.close()
    for name in ("a.pt", "b.pt"):
        saved = ck.read_checkpoint(str(tmp_path / name))["nets"][1]
        assert _equal(dict(saved), before), name
    after = ck.read_checkpoint(str(tmp_path / "c.pt"))["nets"][1]
    assert _equal(dict(after), dict(step.net_sf.state_dict()))
    assert not _equal(dict(after), before)
    assert "optimizers" not in ck.read_checkpoint(str(tmp_path / "b.pt"))
    saver.save(str(tmp_path / "d.pt"), step, epoch=3)  # a new writer thread
    saver.close()
    assert ck.read_checkpoint(str(tmp_path / "d.pt"))["epoch"] == 3


def test_the_written_snapshot_is_let_go(tmp_path):
    """Once an epoch's writes have landed and the next epoch has begun
    (``invalidate``), nothing holds that epoch's snapshot: the device
    keeps the next epoch's clone alone, not both."""
    step = _trained_step()
    saver = ck.AsyncSaver("cpu")
    saver.save(str(tmp_path / "a.pt"), step, epoch=1)
    saver.save(str(tmp_path / "b.pt"), step, epoch=1, include_opt=False)
    snap = saver._snap
    refs = [weakref.ref(t) for sd in snap["nets"] for t in sd.values()]
    refs += [weakref.ref(t) for sd in snap["optimizers"]
             for state in sd["state"].values() for t in state.values()
             if isinstance(t, torch.Tensor)]
    assert len(refs) > len(snap["nets"][0])
    del snap
    saver.flush()
    saver.invalidate()
    gc.collect()
    assert saver._thread is not None and saver._thread.is_alive()
    assert [r for r in refs if r() is not None] == []
    saver.close()


def test_full_queue_blocks_and_drops_nothing(tmp_path, gate):
    """With the writer held on its first file and the queue's 4 slots
    full, the sixth save blocks until the writer moves; every file lands,
    in the order queued."""
    step = _trained_step()
    saver = ck.AsyncSaver("cpu")
    assert saver.QUEUE_SIZE == 4
    for i in range(5):
        saver.save(str(tmp_path / f"{i}.pt"), step, epoch=1)
    done = threading.Event()

    def sixth():
        saver.save(str(tmp_path / "5.pt"), step, epoch=1)
        done.set()

    t = threading.Thread(target=sixth)
    t.start()
    assert not done.wait(0.5), "a save into a full queue returned"
    gate.set()
    t.join(30)
    assert done.is_set()
    saver.flush()
    assert [os.path.basename(r.path) for r in saver.records] == \
        [f"{i}.pt" for i in range(6)]
    assert saver.records[-1].blocking >= 0.4
    saver.close()


def test_a_failed_write_is_raised_at_the_next_save_and_flush(tmp_path):
    step = _trained_step()
    saver = ck.AsyncSaver("cpu")
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the checkpoint's directory should be")
    saver.save(str(blocker / "checkpoint.pt"), step, epoch=1)
    with pytest.raises(RuntimeError, match="checkpoint.pt failed"):
        saver.flush()
    saver.flush()  # raised once
    saver.save(str(blocker / "best.pt"), step, epoch=1)
    saver._q.join()
    with pytest.raises(RuntimeError, match="best.pt failed"):
        saver.save(str(tmp_path / "ok.pt"), step, epoch=1)
    saver.save(str(tmp_path / "ok.pt"), step, epoch=1)
    saver.close()
    assert os.path.isfile(tmp_path / "ok.pt")


def test_a_failed_write_fails_the_run(tmp_path, track_root, monkeypatch):
    """A write error (a full disk, say) ends ``train`` with an error after
    the loop's epoch ends; the visualizer is closed all the same."""
    run = cli.build_run(_run_flags(track_root, tmp_path / "run", "--epoch",
                                   "1"))

    def full_disk(path, write):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ck, "_atomic", full_disk)
    with pytest.raises(RuntimeError, match="No space left"):
        run.train()
    assert run.saver._thread is None
    with pytest.raises(RuntimeError, match="shutdown"):
        run.visualizer.pool.submit(print)


def test_readers_and_the_chained_test_entry_wait_for_the_writes(
        tmp_path, track_root, gate, monkeypatch):
    """``read_checkpoint`` / ``read_best`` of a path with a write in flight,
    and the chained test command, run only after the write lands."""
    run_dir = tmp_path / "run"
    template = tmp_path / "test_cmd.txt"
    template.write_text("python test.py --checkpoint_path {net_file}")
    run = cli.build_run(_run_flags(track_root, run_dir, "--epoch", "1",
                                   "--test_template", str(template)))
    best = str(run_dir / "best.pt")
    run.save(best, epoch=1, best=0.5)
    timer = _open_later(gate)
    assert ck.read_best(best) == 0.5
    timer.join()
    gate.clear()
    seen = {}

    def call(cmd, shell, env):
        seen["cmd"] = cmd
        seen["epoch"] = ck.read_checkpoint(best, mmap=True)["epoch"]
        seen["writing"] = run.saver.writing(best)
        return 0

    monkeypatch.setattr(cli.subprocess, "call", call)
    run.save(best, epoch=2, best=0.25)
    timer = _open_later(gate)
    run.chain_test()
    timer.join()
    assert seen["epoch"] == 2 and not seen["writing"]
    assert best in seen["cmd"]
    run.saver.close()


def test_resume_takes_the_next_step_as_the_unbroken_run(tmp_path,
                                                        track_root):
    """``--resume -1`` from the background-written ``checkpoint.pt`` and the
    unbroken run take the same next step (the same pair) bit for bit: the
    losses, both nets and both optimizers."""
    from dynamic_video_depth_tpu_torch.data.batches import (collate_batches,
                                                            to_device)

    run_dir = tmp_path / "run"
    run = cli.build_run(_run_flags(track_root, run_dir, "--epoch", "1"))
    run.train()
    resumed = cli.build_run(["--full_logdir", str(run_dir), "--resume", "-1",
                             "--epoch", "2", "--device", "cpu",
                             "--batch_size", "1", "--epoch_batches", "2",
                             "--vali_batches", "2"])
    assert resumed.start_epoch == 2
    data = run.trainer.dataset_train
    sample = data[0]
    batch = to_device(collate_batches([sample]), "cpu")
    logs = [s.train_step(batch, steps=sample["steps"], warm=False)
            for s in (run.model.step, resumed.model.step)]
    assert {k: float(v) for k, v in logs[0].items()} == \
        {k: float(v) for k, v in logs[1].items()}
    a, b = run.model.step, resumed.model.step
    assert _equal([a.net_depth.state_dict(), a.net_sf.state_dict()],
                  [b.net_depth.state_dict(), b.net_sf.state_dict()])
    assert _equal([o.state_dict() for o in a.optimizers],
                  [o.state_dict() for o in b.optimizers])


def test_the_writer_thread_stops_after_train(tmp_path, track_root):
    run = cli.build_run(_run_flags(track_root, tmp_path / "run", "--epoch",
                                   "1"))
    run.train()
    assert run.saver._thread is None
    assert not any(t.name == "dvd-checkpoint-writer" and t.is_alive()
                   and getattr(t, "_target", None) == run.saver._run
                   for t in threading.enumerate())
    deadline = time.perf_counter() + 5
    while run.saver._q.unfinished_tasks and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert not run.saver._q.unfinished_tasks
