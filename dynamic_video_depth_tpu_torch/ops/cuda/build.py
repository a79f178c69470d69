"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources under
``dynamic_video_depth_tpu_torch/csrc/`` into ``build/kernels/`` at the repo
root (git-ignored). The file name carries a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads the existing library.
Headers (``.cuh``) are listed with the sources so that they enter the hash;
only the ``.cu`` files are compiled.
Nothing here runs at import time: the CPU tests import every module, and
a build only starts when a wrapper is handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The path of nvcc: on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build (PATH or /usr/local/cuda/bin)")


def library_path(name: str, sources, flags: tuple = ()) -> Path:
    """Where the library built from ``sources`` (paths under csrc) with the
    extra nvcc ``flags`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple, flags: tuple = ()) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``lib<name>.so``. The
    compiler's register/spill report is written beside the library."""
    out = library_path(name, sources, flags)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               *(str(CSRC_DIR / s) for s in sources if s.endswith(".cu"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent process never sees half
    return ctypes.CDLL(str(out))


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
