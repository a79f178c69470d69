"""Find a cell and what belongs to it, by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix; the configuration is
``configs/<config>.json`` with its plain reference net ``configs/<config>.
py`` (a ``build(config)`` function), the mix ``traffic/<traffic>.json``, the
limits of the correctness check ``limits/<workload>.json``, and each
per-layer metric a reader ``metrics/<metric>.py`` (a ``read(run)`` function
that returns the number, or ``None`` where it finds nothing to read). A new
cell, mix or metric is new files and entries; no file here changes. An
end-to-end metric is computed by the part of its name before the first
dot (``pairs_per_s.b1`` is ``pairs_per_s`` in the cells it lists).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    build_reference: Callable
    end_to_end: List[dict]
    per_layer: List[dict]


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_module(os.path.join(HERE, "metrics", metric + ".py"),
                       "bench_metric_" + metric.replace(".", "_")).read


def benchmark_json(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench = benchmark_json(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    module = load_module(os.path.splitext(
        os.path.join(root, cfg_entry["file"]))[0] + ".py",
        "bench_config_" + w["config"])
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=load_json(os.path.join(HERE, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "limits", workload + ".json")),
        build_reference=module.build,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])
