"""The reference agrees with the port's CPU path at a tiny size, and a run
with the timed path broken underneath comes out not correct: a step that
leaves the state unchanged, and half of the batch left out (the mean taken
over the rest). The card's look is skipped; the rest of a run is driven as
``run.py`` drives it, at 32x64 on the CPU."""

import json
import time

import pytest
import torch

from benchmark import check, harness, spec

HW = (32, 64)


@pytest.fixture
def cpu_run(monkeypatch, tmp_path, capsys):
    """``harness._run`` on the CPU: (result line, stderr)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")

    def go(workload, seed=2 ** 31 + 99):
        cell = spec.load_cell(workload)
        rc = harness._run(cell, seed, 1.0, False, time.perf_counter(),
                          str(tmp_path), device="cpu", hw=HW)
        out, err = capsys.readouterr()
        assert rc == 0
        return json.loads(out.strip().splitlines()[-1]), err

    return go


@pytest.mark.parametrize("workload", ["midas_v2.recipe_f32",
                                      "mc_hourglass.fast_b8_f32"])
def test_reference_agrees_with_the_port_on_the_cpu(cpu_run, workload):
    result, err = cpu_run(workload)
    assert result["correct"] is True
    assert list(result["check"]) == list(check.NUMBERS)
    assert err.strip().splitlines()[-1].startswith("check change_gap")
    assert len(result["metrics"]) == 3
    assert {"peak_gib", "setup_s"} < set(result["metrics"])


def test_a_step_that_leaves_the_state_unchanged_is_caught(cpu_run,
                                                         monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    result, _ = cpu_run("midas_v2.recipe_f32")
    assert result["correct"] is False
    assert result["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(cpu_run, monkeypatch):
    from dynamic_video_depth_tpu_torch.train.step import (
        SceneFlowMotionFieldStep)

    original = SceneFlowMotionFieldStep.loss_and_logs

    def half(self, batch, steps, warm, reduce=None):
        b = batch["img_1"].shape[0] // 2
        batch = {k: v[:b] if torch.is_tensor(v) and v.dim() and
                 v.shape[0] == 2 * b else v for k, v in batch.items()}
        return original(self, batch, steps, warm, reduce)

    monkeypatch.setattr(SceneFlowMotionFieldStep, "loss_and_logs", half)
    result, _ = cpu_run("mc_hourglass.fast_b8_f32")
    assert result["correct"] is False
    assert result["check"]["loss_gap"]["value"] > \
        result["check"]["loss_gap"]["limit"]
