"""The port's release gate (counterpart of ``scripts/release_gate.py``).

    python -m dynamic_video_depth_tpu_torch.tools.release_gate \\
        [--full-tests] [--skip-tests] [--skip-dryrun] [--skip-bench] \\
        [--regress-tol 1.5] [--out DIR] \\
        [--tests-cmd CMD] [--dryrun-cmd CMD] [--bench-cmd CMD]

Runs three stages from the checkout's root, each a command in a fresh
process, and exits nonzero if any failed:

1. the port's CPU tests, ``tests/test_torch_*.py`` with ``-m "not
   slow"`` (``--full-tests``: all of them);
2. the dry run of the multi-chip layouts (``dryrun``, the counterpart of
   ``__graft_entry__.py::dryrun_multichip``): the full train step under
   both layouts of ``parallel/mesh.py`` on gloo ranks on the CPU, through
   the fleet entry (``train/fleet.py``);
3. the port's bench on the card (``tools/bench.py``): it must exit 0 and
   print a JSON line, and its ``value`` (the headline's median ms a step)
   may not exceed ``--regress-tol`` times the median value of the newest
   ``GREEN_WINDOW`` green records that this gate wrote for the same card.
   The TPU's records (``BENCH_r*.json``, ``RELEASE_GATE.json``) are never
   read.

Each stage's command can be given as a string (``--tests-cmd`` etc., split
as a shell would); a skipped stage is recorded as such. The gate writes its
record, every stage's exit status, seconds, output tail and the bench's
JSON, to ``DIR/gate-<ns>.json`` (``--out``, default ``build/release_gate``
in the checkout), and reads its earlier records from the same directory.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shlex
import statistics
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "release_gate")
RECORD_GLOB = "gate-*.json"
# the dry run's fleets: two synthetic tracks, the tiny depth net, a warm-up
# and a main epoch of two steps
DRYRUN_TRACKS = ("dog", "cat")
DRYRUN_FLAGS = ["--device", "cpu", "--depth_net", "tiny", "--gaps", "1,2",
                "--epoch", "2", "--warm_sf", "1", "--epoch_batches", "2",
                "--vali_batches", "1", "--manual_seed", "0",
                "--time_dependent", "--use_disp", "--lr", "1e-4",
                "--scene_lr_mul", "10", "--save_net", "0"]
DRYRUN_STEPS = 4  # steps a rank: 2 epochs of 2
# stage 3 compares the headline's median ms a step with the median of the
# newest GREEN_WINDOW green records on the same card, and fails past
# REGRESS_TOL times it. The headline is host-bound (the device idles 0.71-
# 0.79 of its traced steps) and moves with the host: six standalone runs of
# the bench on H100 80GB HBM3 cards at 700 W read 63.4 to 87.5 ms, 1.38x
# apart, three of them in a row on one machine 1.26x (PERF.md section 2
# gives the readings). REGRESS_TOL sits above that spread.
GREEN_WINDOW = 3
REGRESS_TOL = 1.5


def dryrun(workdir: Optional[str] = None) -> None:
    """Stage 2: the fleet entry, two gloo ranks on the CPU each time, on
    both tracks at ``--dp 1`` (a video a rank: the multi-video fleet) and
    on the first at ``--dp 2 --batch_size 2`` (its batch split over the
    two: same-video data parallelism, with the fused chain and loss in
    their plain versions). Raises unless every rank trained every step
    with finite losses."""
    from ..data.synthetic import make_track
    from ..train import fleet

    with tempfile.TemporaryDirectory(dir=workdir) as root:
        for i, track in enumerate(DRYRUN_TRACKS):
            make_track(root, track=track, n_frames=5, h=32, w=48,
                       gaps=(1, 2), seed=i)
        for dp, tracks, extra in (
                (1, DRYRUN_TRACKS, []),
                (2, DRYRUN_TRACKS[:1], ["--use_pallas_sf_chain", "on",
                                        "--use_pallas_loss", "on"])):
            logdir = os.path.join(root, f"dp{dp}")
            out = fleet.main(["--tracks", ",".join(tracks), "--dp", str(dp),
                              "--batch_size", str(dp), "--data_root", root,
                              "--logdir", logdir] + DRYRUN_FLAGS + extra)
            ranks = out["ranks"]
            want = len(tracks) * dp
            if len(ranks) != want:
                raise RuntimeError(f"--dp {dp}: {len(ranks)} ranks, want "
                                   f"{want}")
            losses = [[rec["loss"] for rec in r["records"]] for r in ranks]
            for r, ls in zip(ranks, losses):
                if len(ls) != DRYRUN_STEPS or not all(map(math.isfinite,
                                                          ls)):
                    raise RuntimeError(f"--dp {dp} rank {r['rank']}: losses "
                                       f"{ls}, want {DRYRUN_STEPS} finite")
            print(f"dryrun --dp {dp}: {want} gloo ranks, losses by rank "
                  f"{losses}", flush=True)


def default_commands(full_tests: bool) -> dict:
    py = sys.executable
    tests = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    return {
        "tests": [py, "-m", "pytest", *[os.path.relpath(t, REPO)
                                        for t in tests], "-q", "--tb=line"]
        + ([] if full_tests else ["-m", "not slow"]),
        "dryrun": [py, "-c", "from dynamic_video_depth_tpu_torch.tools."
                   "release_gate import dryrun; dryrun()"],
        "bench": [py, "-m", "dynamic_video_depth_tpu_torch.tools.bench"],
    }


def run_stage(name: str, cmd: List[str], timeout: float) -> dict:
    print(f"[gate] {name}: {' '.join(cmd)}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, env=env, cwd=REPO, timeout=timeout,
                              capture_output=True, text=True)
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = None, e.stdout or "", f"timed out after " \
            f"{timeout:.0f} s"
        stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
    dt = time.time() - t0
    ok = rc == 0
    tail = "\n".join((stdout + stderr).splitlines()[-15:])
    print(f"[gate] {name}: {'OK' if ok else 'FAIL'} ({dt:.0f}s)", flush=True)
    if not ok:
        print(tail, flush=True)
    return {"ok": ok, "rc": rc, "seconds": round(dt, 1),
            "cmd": cmd, "tail": tail, "stdout": stdout}


def bench_json(stdout: str) -> Optional[dict]:
    """The last line of ``stdout`` that parses as a JSON object."""
    for line in reversed(stdout.splitlines()):
        if line.lstrip().startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def recent_green(out_dir: str, device: str,
                 n: int = GREEN_WINDOW) -> List[tuple]:
    """(path, bench value) of the newest ``n`` records in ``out_dir`` that
    passed with a bench value measured on ``device``, newest first."""
    def ns(path):
        return int(os.path.basename(path)[5:-5])

    found = []
    for path in sorted(glob.glob(os.path.join(out_dir, RECORD_GLOB)),
                       key=ns, reverse=True):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        parsed = (rec.get("bench") or {}).get("parsed") or {}
        if rec.get("ok") and parsed.get("value") and \
                parsed.get("device") == device:
            found.append((path, parsed["value"]))
            if len(found) == n:
                break
    return found


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.tools.release_gate",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-tests", action="store_true",
                    help="all of the port's tests, not only -m 'not slow'")
    for stage in ("tests", "dryrun", "bench"):
        ap.add_argument(f"--skip-{stage}", action="store_true")
        ap.add_argument(f"--{stage}-cmd", default=None,
                        help=f"the {stage} stage's command (default: the "
                        f"port's own)")
    ap.add_argument("--regress-tol", type=float, default=REGRESS_TOL,
                    help="the largest bench value allowed, as a ratio to "
                    "the median of the newest green records' on the same "
                    "card")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the directory of the gate's records")
    args = ap.parse_args(argv)

    commands = default_commands(args.full_tests)
    timeouts = {"tests": 3600, "dryrun": 1800, "bench": 5400}
    results, failed = {}, []
    for stage in ("tests", "dryrun", "bench"):
        if getattr(args, f"skip_{stage}"):
            results[stage] = {"skipped": True}
            continue
        given = getattr(args, f"{stage}_cmd")
        r = run_stage(stage, shlex.split(given) if given else
                      commands[stage], timeouts[stage])
        stdout = r.pop("stdout")
        if stage == "tests":
            r["tier"] = "full" if args.full_tests else "fast"
        if stage == "bench":
            r["parsed"] = parsed = bench_json(stdout)
            if r["ok"] and parsed is None:
                r["ok"] = False
                print("[gate] bench: no JSON line", flush=True)
            if r["ok"]:
                prev = recent_green(args.out, parsed.get("device"))
                if prev:
                    value = statistics.median(v for _, v in prev)
                    ratio = parsed["value"] / value
                    r["prev_green"] = {
                        "paths": [os.path.basename(p) for p, _ in prev],
                        "values": [v for _, v in prev], "value": value,
                        "ratio": round(ratio, 3)}
                    if ratio > args.regress_tol:
                        print(f"[gate] bench REGRESSION: {parsed['value']} "
                              f"ms vs {value} ms, the median of "
                              f"{len(prev)} green records (ratio "
                              f"{ratio:.2f} > {args.regress_tol})",
                              flush=True)
                        failed.append("bench-regression")
        results[stage] = r
        if not r["ok"]:
            failed.append(stage)

    results["ok"] = not failed
    results["failed"] = failed
    results["ts"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"gate-{time.time_ns()}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[gate] {'GREEN' if not failed else 'RED: ' + ', '.join(failed)}"
          f" ({path})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
