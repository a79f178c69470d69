"""Guards of the port: it never imports JAX or the JAX package, and a kernel
wrapper handed a CUDA tensor launches its kernel (or raises) and never takes
the plain version; every port test module runs torch on the shared thread
fixture."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from dynamic_video_depth_tpu_torch.ops import cuda as cuda_ops
from dynamic_video_depth_tpu_torch.ops.cuda import (chain_kernel, corr_kernel,
                                                  loss_kernel, mlp_kernel,
                                                  warp_kernel)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
# the only modules of tests/ besides the helper that set a thread count:
# they mirror the program's own rank threads (train/fleet.py::_rank_main)
THREAD_MIRRORS = {"test_torch_fleet.py", "torch_parallel_worker.py"}

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dynamic_video_depth_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "dynamic_video_depth_tpu.")
                                           ) or k == "dynamic_video_depth_tpu")
print("IMPORTED", len([k for k in sys.modules if k.startswith(pkg.__name__)]))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    n = int(proc.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 20  # every module of the package was imported


class _FakeLib:
    """Stands in for a built kernel library: records launches."""

    def __init__(self, rc=0):
        self.calls = []
        self.args = []
        self.rc = rc

    def __getattr__(self, name):
        if not name.startswith("dvd_"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.rc

        return launch


def _pretend_cuda(monkeypatch, module, lib):
    """Mock the device check to say 'cuda' for every tensor, and the
    library and stream, so the CUDA branch of the dispatch runs here."""
    monkeypatch.setattr(module, "device_type", lambda t: "cuda")
    monkeypatch.setattr(module, "_lib", lambda: lib)
    monkeypatch.setattr(module, "stream_handle", lambda device: 0)

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor was routed to the plain version")

    return plain


def test_warp_wrapper_never_routes_cuda_to_plain(monkeypatch):
    lib = _FakeLib()
    plain = _pretend_cuda(monkeypatch, warp_kernel, lib)
    monkeypatch.setattr(warp_kernel, "backward_warp_plain", plain)
    warp_kernel.reset_launches()
    src = torch.randn(1, 4, 5, 4, requires_grad=True)
    out = warp_kernel.backward_warp(src, torch.zeros(1, 4, 5, 2))
    out.sum().backward()
    assert lib.calls == ["dvd_warp_fwd", "dvd_warp_bwd"]
    assert warp_kernel.launches == {"warp_fwd": 1, "warp_bwd": 1}
    assert warp_kernel.launch_variants() == {("warp_fwd", 4): 1,
                                             ("warp_bwd", 4): 1}


def test_mlp_wrapper_never_routes_cuda_to_plain(monkeypatch):
    lib = _FakeLib()
    plain = _pretend_cuda(monkeypatch, mlp_kernel, lib)
    monkeypatch.setattr(mlp_kernel, "mlp_embed_plain", plain)
    monkeypatch.setattr(mlp_kernel, "sceneflow_features", plain)
    mlp_kernel.reset_launches()
    dims = [132, 8, 3]
    ws = [torch.randn(b, a, requires_grad=True)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(b, requires_grad=True) for b in dims[1:]]
    out = mlp_kernel.mlp_embed(torch.randn(6, 3), torch.rand(6, 1), ws, bs,
                               16, 16, True)
    out.sum().backward()
    assert lib.calls == ["dvd_mlp_fwd", "dvd_mlp_bwd"]
    assert mlp_kernel.launches == {"mlp_fwd": 1, "mlp_bwd": 1,
                                   "dense_fwd": 0, "dense_bwd": 0}


def test_dense_wrapper_never_routes_cuda_to_plain(monkeypatch):
    """``fused_mlp`` launches the dense forward, and its backward the dense
    backward; a failed launch raises."""
    lib = _FakeLib()
    plain = _pretend_cuda(monkeypatch, mlp_kernel, lib)
    monkeypatch.setattr(mlp_kernel, "fused_mlp_plain", plain)
    mlp_kernel.reset_launches()
    dims = [20, 8, 3]
    ws = [torch.randn(b, a, requires_grad=True)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(b, requires_grad=True) for b in dims[1:]]
    feat = torch.randn(6, 20, requires_grad=True)
    mlp_kernel.fused_mlp(feat, ws, bs).sum().backward()
    assert lib.calls == ["dvd_dense_fwd", "dvd_dense_bwd"]
    assert mlp_kernel.launches == {"mlp_fwd": 0, "mlp_bwd": 0,
                                   "dense_fwd": 1, "dense_bwd": 1}
    monkeypatch.setattr(mlp_kernel, "_lib", lambda: _FakeLib(rc=1))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        mlp_kernel.fused_mlp(feat, ws, bs)
    with pytest.raises(TypeError, match="float32"):
        mlp_kernel.dense_forward_cuda(feat.double(), ws, bs)


def _pyramid(b=2, h=4, w=6, levels=2):
    return [torch.randn(b, h * w, h >> l, w >> l) for l in range(levels)]


def test_corr_wrapper_never_routes_cuda_to_plain(monkeypatch):
    """The lookup launches its kernel, counted by (radius, levels); bad
    shapes and types raise before any launch."""
    lib = _FakeLib()
    plain = _pretend_cuda(monkeypatch, corr_kernel, lib)
    monkeypatch.setattr(corr_kernel, "lookup_correlation_plain", plain)
    cuda_ops.reset_launches()
    out = corr_kernel.lookup_correlation(_pyramid(), torch.zeros(2, 4, 6, 2),
                                         radius=3)
    assert out.shape == (2, 4, 6, 2 * 49)
    assert lib.calls == ["dvd_corr_lookup"]
    assert corr_kernel.launches == {"corr_lookup": 1}
    assert cuda_ops.launch_variants() == {("corr_lookup", 3, 2): 1}
    with pytest.raises(ValueError, match="level"):
        corr_kernel.lookup_correlation(_pyramid(h=2), torch.zeros(2, 4, 6, 2))
    with pytest.raises(TypeError, match="float32"):
        corr_kernel.lookup_correlation(_pyramid(),
                                       torch.zeros(2, 4, 6, 2).double())
    assert lib.calls == ["dvd_corr_lookup"]


def _chain_args(requires_grad=False):
    dims = [132, 8, 3]
    ws = [torch.randn(b, a, requires_grad=requires_grad)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(b, requires_grad=requires_grad) for b in dims[1:]]
    pts = torch.randn(6, 3, requires_grad=requires_grad)
    return (pts, torch.rand(6, 1), torch.full((6, 1), 0.1), ws, bs, 16, 16,
            True)


def test_chain_wrapper_never_routes_cuda_to_plain(monkeypatch):
    """The chain's forward launches kernel B per evaluation, its backward
    kernel C once."""
    lib = _FakeLib()
    plain = _pretend_cuda(monkeypatch, mlp_kernel, lib)
    _pretend_cuda(monkeypatch, chain_kernel, lib)
    for name in ("chain_plain", "mlp_embed_plain"):
        monkeypatch.setattr(chain_kernel, name, plain)
    monkeypatch.setattr(mlp_kernel, "mlp_embed_plain", plain)
    chain_kernel.reset_launches()
    mlp_kernel.reset_launches()
    acc, f0, f1 = chain_kernel.mlp_embed_chain(*_chain_args(True), 2, 3,
                                               100.0)
    (acc.sum() + f0.sum() + f1.sum()).backward()
    assert lib.calls == ["dvd_mlp_fwd"] * 3 + ["dvd_chain_bwd"]
    assert chain_kernel.launches == {"chain_bwd": 1}
    assert chain_kernel.variants == {("chain_bwd", 2, 3): 1}
    assert mlp_kernel.launches == {"mlp_fwd": 3, "mlp_bwd": 0,
                                   "dense_fwd": 0, "dense_bwd": 0}


def test_launch_variants_name_the_branch(monkeypatch):
    """``launch_variants`` tells the warp's channel counts and the chain's
    (n_steps, n_evals) apart, and a reset clears them with the counts."""
    lib = _FakeLib()
    for module in (warp_kernel, mlp_kernel, chain_kernel):
        _pretend_cuda(monkeypatch, module, lib)
    cuda_ops.reset_launches()
    src = torch.randn(1, 4, 5, 3, requires_grad=True)
    warp_kernel.backward_warp(src, torch.zeros(1, 4, 5, 2)).sum().backward()
    warp_kernel.backward_warp(torch.randn(1, 4, 5, 4), torch.zeros(1, 4, 5, 2))
    for n_steps, n_evals in ((1, 2), (4, 4)):
        acc, f0, f1 = chain_kernel.mlp_embed_chain(*_chain_args(True),
                                                   n_steps, n_evals, 100.0)
        (acc.sum() + f0.sum() + f1.sum()).backward()
    assert cuda_ops.launch_variants() == {
        ("warp_fwd", 3): 1, ("warp_bwd", 3): 1, ("warp_fwd", 4): 1,
        ("chain_bwd", 1, 2): 1, ("chain_bwd", 4, 4): 1}
    assert cuda_ops.launch_counts()["warp_fwd"] == 2
    cuda_ops.reset_launches()
    assert cuda_ops.launch_variants() == {}
    assert not any(cuda_ops.launch_counts().values())


def _loss_args(dtype=torch.float32, requires_grad=False, h=4, w=5,
               offset=0):
    """Loss inputs [1, h, w, ...]; ``offset`` > 0 puts each field that many
    floats into a larger buffer, so that it starts off 16 bytes."""
    b = 1

    def field(*shape, fill=None):
        n = b * h * w * (shape[0] if shape else 1)
        buf = torch.randn(n + offset, dtype=dtype) if fill is None else \
            torch.full((n + offset,), fill, dtype=dtype)
        t = buf[offset:].view(b, h, w, *shape)
        return t.detach().requires_grad_(requires_grad) if shape == (3,) \
            else t

    gp1, w3, sf = (field(3) for _ in range(3))
    return (gp1, w3, sf, field(2, fill=0.0), field(fill=1.0),
            field(fill=1.0), torch.zeros(b, 24))


# rows of a multiple of 4 pixels on 16 bytes, a ragged row, fields 4 bytes
# past 16: every shape and alignment launches the same kernels
@pytest.mark.parametrize("h,w,offset", [(4, 5, 0), (3, 5, 0), (4, 5, 1)])
def test_loss_wrapper_never_routes_cuda_to_plain(monkeypatch, h, w, offset):
    """One launch each way, never the plain version; the forward's
    workspace holds a partial for each block."""
    lib = _FakeLib()
    plain = _pretend_cuda(monkeypatch, loss_kernel, lib)
    monkeypatch.setattr(loss_kernel, "projection_loss_plain", plain)
    loss_kernel.reset_launches()
    args = _loss_args(requires_grad=True, h=h, w=w, offset=offset)
    assert args[0].data_ptr() % 16 == 4 * offset
    sums = loss_kernel.projection_loss(*args, use_disp=True, midas=True)
    sums.sum().backward()
    assert lib.calls == ["dvd_loss_fwd", "dvd_loss_bwd"]
    assert loss_kernel.launches == {"loss_fwd": 1, "loss_bwd": 1}
    # (pointers, B, H, W, flags, work, slots, ...)
    fwd = lib.args[0]
    assert fwd[8:10] == (h, w)
    assert fwd[12] >= (h * w + loss_kernel.BLOCK_PIXELS - 1) \
        // loss_kernel.BLOCK_PIXELS


MODULES = [warp_kernel, mlp_kernel, chain_kernel, loss_kernel, corr_kernel]


def _launch(module):
    """One call of ``module``'s public wrapper, its backward included."""
    if module is warp_kernel:
        src = torch.zeros(1, 2, 2, 4, requires_grad=True)
        return module.backward_warp(src, torch.zeros(1, 2, 2, 2)).sum()
    if module is mlp_kernel:
        return module.mlp_embed(
            torch.zeros(2, 3), torch.zeros(2, 1), [torch.zeros(3, 132)],
            [torch.zeros(3)], 16, 16, True).sum()
    if module is chain_kernel:
        return sum(o.sum() for o in module.mlp_embed_chain(*_chain_args(True),
                                                           2, 2, 100.0))
    if module is corr_kernel:
        return module.lookup_correlation(_pyramid(),
                                         torch.zeros(2, 4, 6, 2)).sum()
    return module.projection_loss(*_loss_args(requires_grad=True)).sum()


@pytest.mark.parametrize("module", MODULES)
def test_failed_launch_raises(monkeypatch, module):
    """A launch whose CUDA status is nonzero raises; nothing falls back."""
    _pretend_cuda(monkeypatch, module, _FakeLib(rc=1))
    plain = _pretend_cuda(monkeypatch, mlp_kernel, _FakeLib(rc=1))
    for mod in (module, mlp_kernel):
        for name in ("backward_warp_plain", "mlp_embed_plain", "chain_plain",
                     "projection_loss_plain", "lookup_correlation_plain"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, plain)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _launch(module).backward()


def test_kernel_rejects_non_float32(monkeypatch):
    _pretend_cuda(monkeypatch, warp_kernel, _FakeLib())
    with pytest.raises(TypeError, match="float32"):
        warp_kernel.warp_forward_cuda(torch.zeros(1, 2, 2, 4, dtype=torch.float64),
                                      torch.zeros(1, 2, 2, 2))


@pytest.mark.parametrize("module", [mlp_kernel, chain_kernel, loss_kernel])
def test_other_kernels_reject_non_float32(monkeypatch, module):
    for mod in (module, mlp_kernel):
        _pretend_cuda(monkeypatch, mod, _FakeLib())
    f64 = torch.float64
    with pytest.raises(TypeError, match="float32"):
        if module is mlp_kernel:
            module.mlp_forward_cuda(torch.zeros(2, 3, dtype=f64),
                                    torch.zeros(2, 1), torch.zeros(7, 132),
                                    [torch.zeros(3, 132)], [torch.zeros(3)])
        elif module is chain_kernel:
            pts, ts, dt, ws, bs = _chain_args()[:5]
            module.chain_backward_cuda(
                pts.double(), ts, dt, torch.zeros(7, 132), ws, bs,
                torch.zeros(1, 6, 3), *(torch.zeros(6, 3),) * 3, 2, 2, 100.0)
        else:
            module.loss_forward_cuda(_loss_args(dtype=f64), 0)


# every programmatic entry point of the port that takes a device
DEVICE_ENTRY_POINTS = [
    ("train.step", "SceneFlowMotionFieldStep"),
    ("preprocess.flows", "make_raft_flow_batch_fn"),
    ("preprocess.flows", "make_raft_flow_fn"),
    ("preprocess.flows", "_prep_raft_input"),
    ("preprocess.flows", "generate_pair"),
    ("preprocess.flows", "process_track"),
    ("preprocess.frames", "make_midas_depth_fn"),
]


def _call_with_default_device(fn, tmp_path):
    from dynamic_video_depth_tpu_torch.train import TrainStepConfig

    frame = {"img": torch.zeros(4, 6, 3).numpy(),
             "img_orig": torch.zeros(4, 6, 3).numpy()}
    args = {"SceneFlowMotionFieldStep": (TrainStepConfig(depth_net="tiny"),),
            "_prep_raft_input": (frame,),
            "generate_pair": (None, frame, frame),
            "process_track": (str(tmp_path / "frames"),
                              str(tmp_path / "flows"))}
    return fn(*args.get(fn.__name__, ()))


@pytest.mark.parametrize("module,name", DEVICE_ENTRY_POINTS)
def test_entry_points_default_to_the_card(module, name, tmp_path):
    """Each entry point runs on the card unless the caller asks for the
    CPU, and a CUDA request without a GPU raises (no silent CPU)."""
    import importlib
    import inspect

    fn = getattr(importlib.import_module(
        f"dynamic_video_depth_tpu_torch.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: a CUDA request does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _call_with_default_device(fn, tmp_path)
    assert not (tmp_path / "flows").exists()


def _tree(name):
    with open(os.path.join(TESTS, name)) as f:
        return ast.parse(f.read(), name)


def _sets_threads(node):
    """A call of torch's thread setters, or ``OMP_NUM_THREADS`` named."""
    return (isinstance(node, ast.Attribute)
            and node.attr in ("set_num_threads", "set_num_interop_threads")
            or isinstance(node, ast.Constant)
            and node.value == "OMP_NUM_THREADS"
            or isinstance(node, ast.keyword) and node.arg == "OMP_NUM_THREADS")


def test_port_test_modules_apply_the_thread_fixture():
    """Every ``tests/test_torch_*.py`` imports ``torch_threads``'s autouse
    fixture at its top level, and no module of ``tests/`` but the helper,
    ``THREAD_MIRRORS`` and this guard sets torch's thread count or names
    ``OMP_NUM_THREADS``."""
    names = sorted(n for n in os.listdir(TESTS) if n.endswith(".py"))
    port = [n for n in names if n.startswith("test_torch_")]
    assert port
    missing = [n for n in port if not any(
        isinstance(node, ast.ImportFrom) and node.module == "torch_threads"
        and any(a.name == "one_torch_thread" for a in node.names)
        for node in _tree(n).body)]
    assert missing == []
    skip = {"torch_threads.py", os.path.basename(__file__)}
    setters = {n for n in names if n not in skip
               and any(map(_sets_threads, ast.walk(_tree(n))))}
    assert setters == THREAD_MIRRORS
