"""The readings that the limits of ``check.py`` are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 \\
        [--faults half_batch] [--controls 3]

For each seed, in one process: the program's set-up round against the
reference (the lower reading: a sound run), the control against the
reference (the reference itself in the precision below the cell's: TF32
for float32, float8 e4m3 convolutions for bfloat16), and each fault named
planted in the reference put in the program's place (``half_batch``: each
step on the first half of its batch only). One JSON line a seed and
reading. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(cell, seed: int, device: str, faults=(), hw=None,
             control: bool = True):
    """``{'program': numbers, 'control': numbers, <fault>: numbers}`` for
    one seed (the control and faults only with ``control``)."""
    from benchmark import check, harness

    workdir = tempfile.mkdtemp(prefix="dvd-calibrate-")
    try:
        program = harness.Program(cell, seed, device, workdir, hw)
        try:
            prog = program.setup_round()
        finally:
            program.close()
        ref = harness.reference_readings(cell, program, prog["steps"],
                                         device)
        out = {"program": check.numbers(prog, ref)}
        if not control:
            return out
        control = harness.reference_readings(
            cell, program, prog["steps"], device,
            precision=CONTROL[cell.traffic["precision"]])
        out["control"] = check.numbers(control, ref)
        for fault in faults:
            planted = harness.reference_readings(cell, program,
                                                 prog["steps"], device,
                                                 fault=fault)
            out[fault] = check.numbers(planted, ref)
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--controls", type=int, default=None,
                    help="read the control and faults on the first N seeds "
                    "only (all by default)")
    a = ap.parse_args(argv)
    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("calibrate reads the card; no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    faults = [f for f in a.faults.split(",") if f]
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, "cuda", faults,
                       control=a.controls is None or i < a.controls)
        for kind, nums in out.items():
            print("\n" + json.dumps({"workload": a.workload, "seed": seed,
                              "reading": kind, **nums}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
