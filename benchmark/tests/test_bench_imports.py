"""No module under ``benchmark/`` imports jax, jaxlib, flax or the JAX
package (compared by whole top-level name: the port's name begins with the
JAX package's), and only the harness imports the port."""

import ast
import os

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dynamic_video_depth_tpu"}
PORT = "dynamic_video_depth_tpu_torch"
# the files that drive the program; everything else is the yardstick
DRIVERS = {"harness.py", "calibrate.py", "tests/test_bench_reference.py",
           "tests/test_bench_rounds.py"}


def sources():
    for d, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                yield os.path.relpath(path, spec.HERE), path


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel,path", sorted(sources()))
def test_no_jax_and_the_port_only_in_drivers(rel, path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, f"{rel} imports {names & FORBIDDEN}"
    if rel not in DRIVERS:
        assert PORT not in names, f"{rel} imports the port"


def test_the_check_is_whole_names():
    from benchmark.harness import forbidden_modules
    import sys

    sys.modules.setdefault("dynamic_video_depth_tpu_torch_x", object())
    try:
        assert "dynamic_video_depth_tpu" not in forbidden_modules()
    finally:
        del sys.modules["dynamic_video_depth_tpu_torch_x"]
