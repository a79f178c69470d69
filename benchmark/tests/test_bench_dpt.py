"""The DPT cell runs as ``run.py`` drives it, on the CPU at 32x64 and at
full width: the reference agrees with the port, and with half of each
batch left out (the mean taken over the rest) the run comes out not
correct. The fault is planted in the program's step through the
harness's own ``Program``."""

import json
import time

import pytest
import torch

from benchmark import check, dptcount, harness, spec

HW = (32, 64)


@pytest.fixture
def cpu_run(monkeypatch, tmp_path, capsys):
    """``harness._run`` of the DPT cell on the CPU: (result line,
    stderr)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")

    def go(seed=2 ** 31 + 7):
        cell = spec.load_cell(dptcount.WORKLOAD)
        rc = harness._run(cell, seed, 1.0, False, time.perf_counter(),
                          str(tmp_path), device="cpu", hw=HW)
        out, err = capsys.readouterr()
        assert rc == 0
        return json.loads(out.strip().splitlines()[-1]), err

    return go


def test_dpt_cell_agrees_with_the_reference_on_the_cpu(cpu_run):
    result, err = cpu_run()
    assert result["correct"] is True, err
    assert list(result["check"]) == list(check.NUMBERS)
    assert set(result["metrics"]) == {"pairs_per_s", "peak_gib", "setup_s"}


def test_dpt_half_batch_is_caught(cpu_run, monkeypatch):
    built = harness.Program.__init__

    def planted(self, *args, **kwargs):
        built(self, *args, **kwargs)
        step = self.trainer.step
        original = step.loss_and_logs

        def half(batch, steps, warm, reduce=None):
            b = batch["img_1"].shape[0] // 2
            batch = {k: v[:b] if torch.is_tensor(v) and v.dim() and
                     v.shape[0] == 2 * b else v for k, v in batch.items()}
            return original(batch, steps, warm, reduce)

        step.loss_and_logs = half

    monkeypatch.setattr(harness.Program, "__init__", planted)
    result, _ = cpu_run()
    assert result["correct"] is False
    assert result["check"]["loss_gap"]["value"] > \
        result["check"]["loss_gap"]["limit"]
