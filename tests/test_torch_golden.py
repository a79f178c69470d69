"""The port's golden checks (``tools/golden_depth.py``,
``tools/golden_raft.py``) on fake checkpoints made from seeds, on the CPU:
freeze, recheck, the refusal of another artifact (exit 2), a perturbed
golden (exit 1), the safe loader's refusal (exit 3), and goldens frozen by
the JAX scripts (``scripts/depth_golden_check.py``,
``scripts/raft_golden_check.py``, loaded by path as
``tests/test_pretrained_load.py`` does). The protocol inputs equal the JAX
scripts' within 1e-6. Small sizes (64x96, 3 RAFT iterations); the command
lines default to the official 224x384 and 288x512 x 20.

The tolerances are the JAX scripts' own: relative error 1e-3 for depth,
0.05 px EPE for RAFT. Card tests (marked ``cuda``) run the harnesses on
the card, where they also compare the card with the CPU.
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest
import torch

from dynamic_video_depth_tpu_torch.models import HourglassModelEmbed, MidasNet
from dynamic_video_depth_tpu_torch.models.raft import RAFT
from dynamic_video_depth_tpu_torch.tools import golden, golden_depth, \
    golden_raft
from torch_replicas import randomize_bn_stats
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (64, 96)
RAFT_KW = dict(res=RES, iters=3)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hourglass_ckpt(path, seed=0):
    """A random hourglass in the official layout: the inner net's keys plus
    the reference's unused ``uncertainty_layer``."""
    net = HourglassModelEmbed(generator=torch.Generator().manual_seed(seed))
    randomize_bn_stats(net, np.random.RandomState(seed))
    sd = {k.removeprefix("net_depth."): v
          for k, v in net.state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    sd["uncertainty_layer.0.weight"] = torch.randn(1, 64, 3, 3, generator=gen)
    sd["uncertainty_layer.0.bias"] = torch.zeros(1)
    torch.save(sd, path)
    return path


def raft_ckpt(path, seed=3):
    """A random RAFT in the official ``nn.DataParallel`` layout."""
    net = RAFT(generator=torch.Generator().manual_seed(seed))
    torch.save({"module." + k: v for k, v in net.state_dict().items()}, path)
    return path


def _perturb(path, key, scale):
    with np.load(path) as f:
        d = dict(f)
    d[key] = d[key] * scale
    np.savez(path, **d)


def test_golden_depth_hourglass_freeze_recheck_refuse_drift(tmp_path):
    ckpt = hourglass_ckpt(str(tmp_path / "net_G.pth"))
    path = str(tmp_path / "golden.npz")
    kw = dict(tol=1e-3, res=RES, device="cpu")
    assert golden_depth.run("hourglass", ckpt, path, True, **kw) == 0
    with np.load(path) as g:
        assert set(g.files) == {"prediction", "checksum", "res", "net",
                                "device"}
        assert g["prediction"].shape == RES
        assert str(g["checksum"]) == golden.sha256(ckpt)
        assert list(g["res"]) == list(RES) and str(g["net"]) == "hourglass"
    assert golden_depth.run("hourglass", ckpt, path, False, **kw) == 0
    other = hourglass_ckpt(str(tmp_path / "other.pth"), seed=1)
    assert golden_depth.run("hourglass", other, path, False, **kw) == 2
    _perturb(path, "prediction", 1.01)
    assert golden_depth.run("hourglass", ckpt, path, False, **kw) == 1


def test_golden_depth_accepts_a_golden_frozen_by_the_jax_script(tmp_path):
    """The JAX script's own ``flax_prediction`` through the JAX production
    loader, saved with its ``np.savez`` keys, checks the port (at 32x48:
    the JAX side runs op by op, compiling each, ~25 s)."""
    _jax_golden_checks_the_port(tmp_path, "hourglass", hourglass_ckpt(
        str(tmp_path / "net_G.pth")), (32, 48))


def _jax_golden_checks_the_port(tmp_path, net, ckpt, res):
    mod = _script("depth_golden_check")
    jax_pred = mod.flax_prediction(net, ckpt, mod.protocol_image(None, res))
    path = str(tmp_path / "jax_golden.npz")
    np.savez(path, prediction=jax_pred, checksum=mod.sha256(ckpt),
             res=np.asarray(res), net=net)
    assert golden_depth.run(net, ckpt, path, False, tol=1e-3, res=res,
                            device="cpu") == 0
    ours = golden_depth.prediction(net, ckpt,
                                   golden_depth.protocol_image(None, res),
                                   "cpu")
    assert golden_depth.rel_err(ours, jax_pred) < 1e-3


def test_golden_raft_freeze_recheck_refuse_drift(tmp_path):
    ckpt = raft_ckpt(str(tmp_path / "raft-sintel.pth"))
    path = str(tmp_path / "golden.npz")
    kw = dict(tol=0.05, device="cpu", **RAFT_KW)
    assert golden_raft.run(ckpt, path, True, **kw) == 0
    with np.load(path) as g:
        assert set(g.files) == {"flow", "checksum", "res", "iters", "device"}
        assert g["flow"].shape == RES + (2,) and int(g["iters"]) == 3
    assert golden_raft.run(ckpt, path, False, **kw) == 0
    other = raft_ckpt(str(tmp_path / "other.pth"), seed=4)
    assert golden_raft.run(other, path, False, **kw) == 2
    with np.load(path) as f:
        d = dict(f)
    d["flow"] = d["flow"] + 0.1  # EPE 0.1 * sqrt(2) px
    np.savez(path, **d)
    assert golden_raft.run(ckpt, path, False, **kw) == 1


def test_golden_raft_accepts_a_golden_frozen_by_the_jax_script(tmp_path):
    """JAX ``raft_golden_check.run`` freezes (it also holds the Flax RAFT
    to the torch replica); the port's harness passes against it, and the
    port's flow lies within 0.05 px EPE of the replica's."""
    from torch_raft_replica import RAFT as TorchRAFT

    mod = _script("raft_golden_check")
    ckpt = raft_ckpt(str(tmp_path / "raft-sintel.pth"))
    path = str(tmp_path / "jax_golden.npz")
    assert mod.run(ckpt, path, freeze=True, tol=0.05, **RAFT_KW) == 0
    assert golden_raft.run(ckpt, path, False, 0.05, device="cpu",
                           **RAFT_KW) == 0

    im1, im2 = golden_raft.protocol_inputs(None, RES)
    ours = golden_raft.flow(ckpt, im1, im2, device="cpu", **RAFT_KW)
    tnet = TorchRAFT()
    tnet.load_state_dict({k.removeprefix("module."): v for k, v in
                          torch.load(ckpt, weights_only=True).items()})
    tnet.eval()
    with torch.no_grad():
        _, up = tnet(torch.from_numpy(np.ascontiguousarray(im1[None]))
                     .permute(0, 3, 1, 2),
                     torch.from_numpy(np.ascontiguousarray(im2[None]))
                     .permute(0, 3, 1, 2), iters=3)
    assert golden_raft.epe(ours, up.permute(0, 2, 3, 1)[0].numpy()) < 0.05


@pytest.mark.parametrize("res", [(64, 96), (224, 384), (288, 512)])
def test_protocol_inputs_match_the_jax_scripts(res):
    depth_mod = _script("depth_golden_check")
    raft_mod = _script("raft_golden_check")
    np.testing.assert_allclose(golden_depth.protocol_image(None, res),
                               depth_mod.protocol_image(None, res),
                               rtol=0, atol=1e-6)
    for ours, ref in zip(golden_raft.protocol_inputs(None, res),
                         raft_mod.protocol_inputs(None, res)):
        np.testing.assert_array_equal(ours, ref)


def test_protocol_inputs_from_image_files_match_the_jax_scripts(tmp_path):
    """``--image`` against the JAX depth script's; ``--frames`` against the
    JAX package's bilinear resize (align_corners=False), which the JAX RAFT
    script means to call: its own ``--frames`` path omits the required
    ``align_corners`` argument and raises ``TypeError``."""
    import jax.numpy as jnp
    from PIL import Image

    from dynamic_video_depth_tpu.ops.resize import resize_bilinear

    rng = np.random.RandomState(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray((rng.rand(50, 70, 3) * 255).astype(np.uint8)).save(
            paths[-1])
    np.testing.assert_allclose(
        golden_depth.protocol_image(paths[0], RES),
        _script("depth_golden_check").protocol_image(paths[0], RES),
        rtol=0, atol=1e-6)
    for ours, p in zip(golden_raft.protocol_inputs(paths, RES), paths):
        im = np.asarray(Image.open(p).convert("RGB"), np.float32)
        ref = np.asarray(resize_bilinear(jnp.asarray(im[None]), RES,
                                         False))[0]
        np.testing.assert_allclose(ours, ref, rtol=0, atol=255e-6)


@pytest.fixture
def midas_ckpt(tmp_path):
    """A random full-width MiDaS (~420 MB) in the ``{"model",
    "optimizer"}`` wrapper, its output biased as the fixtures do; deleted
    at teardown (pytest keeps ``tmp_path`` for three sessions)."""
    from dynamic_video_depth_tpu_torch.runtime.weights import \
        bias_midas_output

    net = bias_midas_output(MidasNet(
        generator=torch.Generator().manual_seed(2)))
    path = tmp_path / "midas_cpkt.pt"
    torch.save({"model": net.state_dict(), "optimizer": {}}, str(path))
    del net
    yield str(path)
    path.unlink()


def test_golden_depth_midas_full_width_in_the_wrapper(midas_ckpt, tmp_path):
    path = str(tmp_path / "golden.npz")
    kw = dict(tol=1e-3, res=RES, device="cpu")
    assert golden_depth.run("midas", midas_ckpt, path, True, **kw) == 0
    with np.load(path) as g:
        pred = g["prediction"]
    assert pred.shape == RES and np.isfinite(pred).all()
    assert 1.0 < float(pred.mean()) < 1e3  # the biased output conv
    assert golden_depth.run("midas", midas_ckpt, path, False, **kw) == 0


@pytest.mark.slow
def test_golden_depth_midas_accepts_a_golden_frozen_by_the_jax_script(
        midas_ckpt, tmp_path):
    """As the hourglass case, for the full-width MiDaS in the wrapper: slow
    (the JAX MiDaS compiles op by op, minutes on the CPU)."""
    _jax_golden_checks_the_port(tmp_path, "midas", midas_ckpt, RES)


@pytest.mark.parametrize("tool", ["depth", "raft"])
def test_golden_refuses_what_the_safe_loader_refuses(tmp_path, tool,
                                                     capsys):
    """A checkpoint that pickles a non-tensor object exits 3 with the
    loader's reason; nothing retries with ``weights_only=False``."""
    path = str(tmp_path / "ckpt.pth")
    torch.save({"w": torch.zeros(1), "opt": argparse.Namespace(lr=1)}, path)
    gpath = str(tmp_path / "golden.npz")
    if tool == "depth":
        rc = golden_depth.run("hourglass", path, gpath, True, 1e-3, res=RES,
                              device="cpu")
    else:
        rc = golden_raft.run(path, gpath, True, 0.05, device="cpu",
                             **RAFT_KW)
    assert rc == 3
    out = capsys.readouterr().out
    assert "weights_only=True" in out and "argparse.Namespace" in out
    assert not os.path.exists(gpath)


@pytest.mark.parametrize("tool", ["depth", "raft"])
def test_golden_entry_points_run_on_the_card_unless_asked(tmp_path, tool,
                                                          monkeypatch):
    """Without ``--device`` the harnesses ask for the card, which raises
    where there is none; ``--device cpu`` runs (the command line at its
    defaults, RAFT shrunk by its flags)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gpath = str(tmp_path / "golden.npz")
    if tool == "depth":
        ckpt = hourglass_ckpt(str(tmp_path / "net_G.pth"))
        argv = ["--net", "hourglass", "--ckpt", ckpt, "--golden", gpath,
                "--freeze"]
        main = golden_depth.main
    else:
        ckpt = raft_ckpt(str(tmp_path / "raft.pth"))
        argv = ["--ckpt", ckpt, "--golden", gpath, "--freeze", "--res",
                "64", "96", "--iters", "2"]
        main = golden_raft.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert main(argv + ["--device", "cpu"]) == 0
    assert main([a for a in argv if a != "--freeze"]
                + ["--device", "cpu"]) == 0


def test_golden_default_paths_leave_the_jax_goldens_alone():
    assert golden_depth.default_golden("midas").endswith(
        os.path.join("tests", "goldens", "torch_depth_midas_golden.npz"))
    assert golden.GOLDEN_DIR == os.path.join(ROOT, "tests", "goldens")


# ------------------------------------------------------------------ card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_golden_raft_on_the_card_launches_the_lookup(dev, tmp_path, capsys):
    """The official protocol (288x512, 20 iterations) on the card: the
    lookup kernel once an iteration, the card within 0.05 px of the CPU."""
    ckpt = raft_ckpt(str(tmp_path / "raft-sintel.pth"))
    before = golden_raft.lookup_launches()
    assert golden_raft.run(ckpt, str(tmp_path / "g.npz"), True, 0.05) == 0
    assert golden_raft.lookup_launches() - before == golden_raft.RAFT_ITERS
    assert "EPE px card-vs-CPU" in capsys.readouterr().out
