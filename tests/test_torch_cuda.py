"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances are relative to the largest reference value: the warp forward
differs from its plain version only by FMA contraction; the warp backward
adds in atomic order; the MLP and the chain run 3xTF32 tensor-core
products (float32 accuracy, another summation order than cuBLAS); the loss
kernel is built without FMA contraction, so per pixel it matches its plain
version and only the order of the global sums differs; the correlation
lookup differs from its plain gather by FMA contraction only. The head
convolution sums its 2,304 products a value in one float32 accumulator, in
order: it is held to ``HEAD_FACTOR`` times cuDNN float32's own distance
from a float64 result (cuDNN's FFT route sums in another way).

The MLP and chain gradient checks zero the cotangents of the points whose
hidden pre-activations lie within roundoff of 0 (``chip_smoke.flip_points``,
the same mask as the smoke's): there the leaky-relu slope may differ
between two right float32 computations.
"""

import functools

import pytest
import torch

from chip_smoke import (chain_features, flip_points, misaligned, random_flow,
                        track_flows, zero_rows)
from dynamic_video_depth_tpu_torch.ops.cuda import (chain_kernel, corr_kernel,
                                                  head_conv_kernel,
                                                  loss_kernel, mlp_kernel,
                                                  warp_kernel)
from dynamic_video_depth_tpu_torch.ops.embedding import sceneflow_features
from torch_threads import one_torch_thread  # noqa: F401

# the canonical field, 132 -> 256 -> 256 x4 -> 3
CANON = [132, 256, 256, 256, 256, 256, 3]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@functools.lru_cache(maxsize=None)
def _warp_flow(kind, b, h, w):
    """[b, h, w, 2] on the CPU: the synthetic track's gap-2 flow (the train
    step's traffic), the random +-60 px flow, or 0 / +150 px alternating
    between neighbouring columns (half of every tile's taps outside any
    window)."""
    if kind == "gap2":
        return track_flows(h, w, 2, n=b)
    if kind == "random60":
        return random_flow(b, h, w, seed=h)
    flow = torch.zeros(b, h, w, 2)
    flow[..., 0] = 150.0 * (torch.arange(w) % 2)
    return flow


# shapes no multiple of the 32x8 tile; C = 3 and 4 take the vector paths,
# other C the per-channel loop
@pytest.mark.parametrize("kind", ["gap2", "random60", "alternating"])
@pytest.mark.parametrize("h,w", [(37, 53), (224, 384), (320, 576)])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
def test_warp_kernel_matches_plain(dev, c, b, h, w, kind):
    gen = torch.Generator().manual_seed(c)
    src = torch.randn(b, h, w, c, generator=gen).to(dev)
    flow = _warp_flow(kind, b, h, w).to(dev)
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    s = src.clone().requires_grad_(True)
    ref = warp_kernel.backward_warp_plain(s, flow)
    (ref * g).sum().backward()
    warp_kernel.reset_launches()
    out = warp_kernel.backward_warp(src.clone().requires_grad_(True), flow)
    assert _rel(out, ref) <= 1e-6
    assert _rel(warp_kernel.warp_backward_cuda(g, flow), s.grad) <= 1e-5
    assert warp_kernel.launch_variants() == {("warp_fwd", c): 1,
                                             ("warp_bwd", c): 1}


def _stack(gen, dims, dev):
    ws = [(torch.randn(b, a, generator=gen) * (2.0 / a) ** 0.5).to(dev)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.01 * torch.randn(b, generator=gen)).to(dev) for b in dims[1:]]
    return ws, bs


# the canonical field at 224x384 and at point counts around the 128-point
# tile's edges; a one-layer and a two-layer net pad K = 132 and N = 3 with
# no hidden layer between them
@pytest.mark.parametrize("n,dims,nfx,nft", [
    (86016, CANON, 16, 16), (1000, CANON, 16, 16),
    (777, [32, 32, 32, 32, 3], 4, 2), (1, CANON, 16, 16),
    (63, CANON, 16, 16), (65, CANON, 16, 16), (129, CANON, 16, 16),
    (300, [132, 3], 16, 16), (300, [132, 64, 3], 16, 16)])
def test_mlp_kernel_matches_plain(dev, n, dims, nfx, nft):
    gen = torch.Generator().manual_seed(n + len(dims))
    ws, bs = _stack(gen, dims, dev)
    pts = torch.randn(n, 3, generator=gen).to(dev)
    ts = torch.rand(n, 1, generator=gen).to(dev)
    near = flip_points([sceneflow_features(pts, ts, nfx, nft, True)], ws, bs)
    g, = zero_rows(near, torch.randn(n, 3, generator=gen).to(dev))
    nl = len(ws)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (pts, ts, *ws, *bs)]
        out = fn(leaves[0], leaves[1], leaves[2:2 + nl], leaves[2 + nl:],
                 nfx, nft, True)
        (out * g).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    mlp_kernel.reset_launches()
    got = run(mlp_kernel.mlp_embed)
    want = run(mlp_kernel.mlp_embed_plain)
    assert mlp_kernel.launches == {"mlp_fwd": 1, "mlp_bwd": 1,
                                   "dense_fwd": 0, "dense_bwd": 0}
    assert _rel(got[0], want[0]) <= 1e-4
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) <= 1e-3


@pytest.mark.parametrize("n,dims", [
    (86016, [132, 256, 256, 256, 256, 256, 3]), (777, [20, 32, 32, 3]),
    (777, [21, 37, 19, 3])])
def test_fused_mlp_kernel_matches_plain(dev, n, dims):
    """Widths that are no multiple of 8 (the last case) pad the tiles and
    the backward's scratch."""
    gen = torch.Generator().manual_seed(n)
    ws = [(torch.randn(b, a, generator=gen) * (2.0 / a) ** 0.5).to(dev)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.01 * torch.randn(b, generator=gen)).to(dev) for b in dims[1:]]
    feat = torch.randn(n, dims[0], generator=gen).to(dev)
    g, = zero_rows(flip_points([feat], ws, bs),
                   torch.randn(n, dims[-1], generator=gen).to(dev))

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (feat, *ws, *bs)]
        nl = len(ws)
        out = fn(leaves[0], leaves[1:1 + nl], leaves[1 + nl:])
        (out * g).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    mlp_kernel.reset_launches()
    got = run(mlp_kernel.fused_mlp)
    assert mlp_kernel.launches == {"mlp_fwd": 0, "mlp_bwd": 0,
                                   "dense_fwd": 1, "dense_bwd": 1}
    want = run(mlp_kernel.fused_mlp_plain)
    assert _rel(got[0], want[0]) <= 1e-4
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) <= 1e-5


# L (2r+1)^2 a multiple of 4 (float4 rows: 4 x 81, 4 x 49) or not (2 x 49,
# 3 x 81); top levels smaller than the window (4x8 at 36x64, 1x1 at 8x12)
@pytest.mark.parametrize("b,h,w,radius,levels", [
    (2, 36, 64, 4, 4), (1, 16, 24, 3, 2), (1, 36, 64, 4, 4),
    (1, 36, 64, 3, 4), (2, 8, 12, 4, 4), (1, 20, 28, 4, 3)])
def test_corr_lookup_kernel_matches_plain(dev, b, h, w, radius, levels):
    """At RAFT's 288x512 grid (36x64, four levels, r = 4) and smaller ones,
    with coordinates past every border."""
    gen = torch.Generator().manual_seed(h)
    pyr, hl, wl = [], h, w
    for _ in range(levels):
        pyr.append(torch.randn(b, h * w, hl, wl, generator=gen).to(dev))
        hl, wl = hl // 2, wl // 2
    coords = (torch.rand(b, h, w, 2, generator=gen)
              * torch.tensor([1.4 * w, 1.4 * h]) - torch.tensor(
                  [0.2 * w, 0.2 * h])).to(dev)
    corr_kernel.reset_launches()
    out = corr_kernel.lookup_correlation(pyr, coords, radius)
    assert corr_kernel.launches == {"corr_lookup": 1}
    ref = corr_kernel.lookup_correlation_plain(pyr, coords, radius)
    assert out.shape == (b, h, w, levels * (2 * radius + 1) ** 2)
    assert _rel(out, ref) <= 1e-6


def _chain_inputs(dev, n, n_evals):
    from dynamic_video_depth_tpu_torch.models import SceneFlowFieldNet

    gen = torch.Generator().manual_seed(n + n_evals)
    net = SceneFlowFieldNet(time_dependent=True, n_freq_xyz=16, n_freq_t=16,
                            net_width=256, n_layers=4, generator=gen)
    ws = [l.conv.weight.detach().to(dev) for l in net.convs]
    bs = [l.conv.bias.detach().to(dev) for l in net.convs]
    pts = torch.cat([2.0 * torch.rand(n, 2, generator=gen) - 1.0,
                     2.0 + 2.0 * torch.rand(n, 1, generator=gen)], 1).to(dev)
    ts = torch.rand(n, 1, generator=gen).to(dev)
    dt = torch.full((n, 1), 0.05).to(dev)
    gs = [torch.randn(n, 3, generator=gen).to(dev) for _ in range(3)]
    return ws, bs, pts, ts, dt, gs


@pytest.mark.parametrize("n,n_steps,n_evals", [
    (86016, 2, 2), (86016, 8, 8), (777, 1, 2), (777, 3, 4), (86016, 1, 2),
    (86016, 4, 4), (1, 1, 2), (63, 1, 2), (65, 1, 2), (129, 1, 2),
    (86016, 6, 6)])
def test_chain_kernel_matches_plain(dev, n, n_steps, n_evals):
    ws, bs, pts, ts, dt, gs = _chain_inputs(dev, n, n_evals)
    gs = zero_rows(flip_points(chain_features(
        pts, ts, dt, ws, bs, 16, 16, True, n_evals, 100.0), ws, bs), *gs)

    def run(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (pts, ts, dt, *ws, *bs)]
        outs = fn(leaves[0], leaves[1], leaves[2], leaves[3:9], leaves[9:],
                  16, 16, True, n_steps, n_evals, 100.0)
        sum((o * g).sum() for o, g in zip(outs, gs)).backward()
        return [o.detach() for o in outs] + [t.grad for t in leaves]

    chain_kernel.reset_launches()
    mlp_kernel.reset_launches()
    got = run(chain_kernel.mlp_embed_chain)
    assert chain_kernel.launches == {"chain_bwd": 1}
    assert mlp_kernel.launches == {"mlp_fwd": n_evals, "mlp_bwd": 0,
                                   "dense_fwd": 0, "dense_bwd": 0}
    want = run(chain_kernel.chain_plain)
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= 1e-4
    for a, b in zip(got[3:], want[3:]):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("kernel", ["mlp_bwd", "chain_bwd"])
def test_mlp_backward_is_bit_deterministic(dev, kernel):
    """Kernel B's and C's backward twice on the same inputs: dW, db, dpts,
    dts (and the chain's ddt) are bit-equal (no float atomics)."""
    n = 86016
    ws, bs, pts, ts, dt, gs = _chain_inputs(dev, n, 2)
    consts = mlp_kernel.embed_consts(16, 16, True, dev)
    if kernel == "mlp_bwd":
        def run():
            dpts, dts, dws, dbs = mlp_kernel.mlp_backward_cuda(
                pts, ts, consts, ws, bs, gs[0])
            return [dpts, dts, *dws, *dbs]
    else:
        stash = chain_kernel.chain_forward_cuda(pts, ts, dt, consts, ws, bs,
                                                2, 2, 100.0)[3]

        def run():
            dpts, dts, ddt, dws, dbs = chain_kernel.chain_backward_cuda(
                pts, ts, dt, consts, ws, bs, stash, *gs, 2, 2, 100.0)
            return [dpts, dts, ddt, *dws, *dbs]
    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _loss_inputs(dev, b, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    gp1 = torch.randn(b, h, w, 3, generator=gen) * 0.5
    gp1[..., 2] += 3.0
    w3 = torch.randn(b, h, w, 3, generator=gen) * 0.5
    w3[..., 2] += 3.0
    sf = torch.randn(b, h, w, 3, generator=gen) * 0.05
    gp1[:, :8, :8, 2] = -5.0           # behind camera 2: dead pixels
    sf[:, :8, :8, 2] = 0.0
    w3[:, 8:12, :16, 2] = torch.rand(b, 4, 16, generator=gen) * 1e-3
    w3[:, 20:24, 20:40, 2] = 150.0     # far field
    flow = torch.randn(b, h, w, 2, generator=gen) * 2.0
    mask = torch.rand(b, h, w, generator=gen)
    depth = torch.rand(b, h, w, generator=gen) * 5.0 + 0.5
    depth[:, 30:34, :50] = 120.0
    cam = torch.zeros(b, 24)
    cam[:, 0:9] = torch.eye(3).reshape(9)
    cam[:, 9:12] = torch.randn(b, 3, generator=gen) * 0.1
    cam[:, 12:21] = torch.tensor([0.8 * w, 0, w / 2, 0, 0.8 * w, h / 2,
                                  0, 0, 1.0])
    return [t.to(dev) for t in (gp1, w3, sf, flow, mask, depth, cam)]


@pytest.mark.parametrize("b,h,w", [(1, 224, 384), (2, 320, 576)])
def test_loss_forward_is_bit_deterministic(dev, b, h, w):
    """Kernel D's four sums are bit-equal over repeated calls: the
    cross-block sum adds the blocks' partials in index order, whichever
    block finishes last."""
    args = _loss_inputs(dev, b, h, w, seed=h)
    flags = loss_kernel.flag_bits(True, False, True, False)
    first = loss_kernel.loss_forward_cuda(args, flags)
    for _ in range(20):
        assert torch.equal(loss_kernel.loss_forward_cuda(args, flags), first)


# batch 2; a row of no multiple of 4 pixels (37x53); fields 4 bytes past 16
@pytest.mark.parametrize("b,h,w,shifted", [
    (1, 224, 384, False), (1, 320, 576, False), (2, 224, 384, False),
    (1, 37, 53, False), (1, 224, 384, True)])
@pytest.mark.parametrize("use_disp,use_disp_ratio,midas,warm", [
    (True, False, True, False), (True, False, True, True),
    (False, True, False, False), (False, False, False, False)])
def test_loss_kernel_matches_plain(dev, b, h, w, shifted, use_disp,
                                   use_disp_ratio, midas, warm):
    args = _loss_inputs(dev, b, h, w, seed=h)
    if shifted:
        args = [misaligned(t) for t in args[:6]] + args[6:]
        assert all(t.data_ptr() % 16 == 4 for t in args[:6])
    flags = (use_disp, use_disp_ratio, midas, warm)
    cot = (torch.randn(4, generator=torch.Generator().manual_seed(1))
           / (b * h * w)).to(dev)

    def run(fn):
        leaves = [(misaligned(t) if shifted else t.clone()).requires_grad_(
            True) for t in args[:3]]
        sums = fn(*leaves, *args[3:], *flags)
        (sums * cot).sum().backward()
        return [sums.detach()] + [t.grad for t in leaves]

    loss_kernel.reset_launches()
    got = run(loss_kernel.projection_loss)
    assert loss_kernel.launches == {"loss_fwd": 1, "loss_bwd": 1}
    want = run(loss_kernel.projection_loss_plain)
    # each of the four sums on its own: they span five orders of magnitude
    assert ((got[0] - want[0]).abs()
            / want[0].abs().clamp_min(1e-30)).max() <= 1e-5
    for k, p in zip(got[1:], want[1:]):
        assert torch.isfinite(k).all()
        assert _rel(k, p) <= 1e-5


# ------------------------------------------------------------- the recipe

@pytest.fixture(scope="module")
def midas_run(tmp_path_factory):
    """A one-epoch MiDaS run at 224x384 through the train entry on the card
    (the fixture's biased output conv), then its test entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dynamic_video_depth_tpu_torch import test as test_entry
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train.cli import build_run

    root = tmp_path_factory.mktemp("cuda_recipe")
    make_track(str(root), track="dog", n_frames=4, h=224, w=384, gaps=(1,))
    flags = ["--track_id", "dog", "--gaps", "1", "--data_root", str(root),
             "--midas", "--epoch_batches", "2", "--vali_batches", "2",
             "--batch_size", "1", "--lr", "1e-6", "--scene_lr_mul", "1000",
             "--time_dependent", "--use_disp", "--manual_seed", "0",
             "--vis_batches_train", "1", "--vis_batches_vali", "1",
             "--full_logdir", str(root / "run")]
    run = build_run(flags + ["--epoch", "1"])
    bias_midas_output(run.model.step.net_depth)
    run.train()
    mlp_kernel.reset_launches()
    summary = test_entry.main(["--checkpoint_path", str(root / "run"),
                               "--output_dir", str(root / "run" / "test")])
    return root, flags, summary


def test_test_entry_matches_predict_on_the_card(midas_run):
    """best.pt in a fresh step gives each frame's npz depth bit for bit;
    its scene flow is kernel B's, within TOL of the plain MLP; kernel B's
    forward ran once a frame."""
    import numpy as np
    from argparse import Namespace

    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
    from dynamic_video_depth_tpu_torch.ops import Camera, unproject
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        load_checkpoint, load_opt)
    from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import (
        Model)

    root, _, summary = midas_run
    run_dir = root / "run"
    opt = Namespace(**load_opt(str(run_dir)))
    model = Model(opt, device="cuda", pretrained=False)
    load_checkpoint(str(run_dir / "best.pt"), model.step)
    ds = Dataset(opt, "vali")
    assert summary["frames"] == len(ds) == summary["launches"]["mlp_fwd"]
    layers = [layer.conv for layer in model.step.net_sf.convs]
    cfg = model.step.cfg
    for i in range(len(ds)):
        batch = to_device(ds[i], "cuda")
        pred = model.step.predict(batch)
        dump = np.load(run_dir / "test" / "epochbest_test" /
                       f"batch{i:04d}.npz")
        assert np.array_equal(pred["depth"].cpu().numpy(), dump["depth"])
        cam = Camera(batch["R_1"], batch["t_1"], batch["K"], batch["K_inv"])
        with torch.no_grad():
            plain = mlp_kernel.mlp_embed_plain(
                unproject(pred["depth"], cam).reshape(-1, 3),
                batch["time_stamp_1"].reshape(-1, 1),
                [l.weight for l in layers], [l.bias for l in layers],
                cfg.n_freq_xyz, cfg.n_freq_t, cfg.time_dependent)
        plain = (plain / cfg.loss.sf_mag_div).reshape(pred["sf_1_2"].shape)
        assert _rel(torch.from_numpy(dump["sf_1_2"]).cuda(), plain) <= 1e-4


def test_resume_round_trip_on_the_card(midas_run):
    """--resume -1 on the card: both nets and both Adams equal
    checkpoint.pt bit for bit, and the next epoch trains."""
    import math

    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        read_checkpoint)
    from dynamic_video_depth_tpu_torch.train.cli import build_run

    root, flags, _ = midas_run
    saved = read_checkpoint(str(root / "run" / "checkpoint.pt"))
    run = build_run(["--full_logdir", str(root / "run"), "--resume", "-1",
                     "--epoch", "2", "--epoch_batches", "2",
                     "--vali_batches", "2", "--batch_size", "1"])
    step = run.model.step
    assert run.start_epoch == 2

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b

    assert same([step.net_depth.state_dict(), step.net_sf.state_dict()],
                saved["nets"])
    assert same([o.state_dict() for o in step.optimizers],
                saved["optimizers"])
    hist = run.train().history
    assert [r["epoch"] for r in hist] == [2, 2]
    assert all(math.isfinite(r["loss"]) for r in hist)


# ------------------------------------------------------------ the variants

@pytest.fixture(scope="module")
def small_track(tmp_path_factory):
    """A 64x64 synthetic track (gaps 1 and 2) and a gap-2 pair of it on the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from argparse import Namespace

    from dynamic_video_depth_tpu_torch.data.batches import collate_batches
    from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("variants_track"))
    make_track(root, track="dog", n_frames=4, h=64, w=64, gaps=(1, 2))
    ds = Dataset(Namespace(track_id="dog", data_root=root, gaps="2",
                           subsample=False), "train")
    host = collate_batches([ds[0]])
    return {k: torch.as_tensor(v) for k, v in host.items()
            if k not in ("steps", "pair_path")}


def _steps_on(cfg, batch, device, bias_midas=False):
    """A warm-up and a main step at gap 2 from seed 0 on ``device``: the
    losses of both, the depth of the pair after them, and the launches."""
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train import SceneFlowMotionFieldStep

    step = SceneFlowMotionFieldStep(cfg, device=device, seed=0)
    if bias_midas:
        bias_midas_output(step.net_depth)
    on = {k: v.to(device) for k, v in batch.items()}
    kernels.reset_launches()
    logs = [{k: float(v) for k, v in step.train_step(on, 2, warm).items()}
            for warm in (True, False)]
    launches = kernels.launch_counts()
    with torch.no_grad():
        depth = step._apply_depth(torch.cat([on["img_1"], on["img_2"]]))
    return logs, depth.cpu(), launches


def test_bf16_midas_step_on_the_card(dev, small_track):
    """A bfloat16 MiDaS warm-up and main step (the fixture's biased output
    conv) on the card launch kernels A-D and match the same steps on the
    CPU in bfloat16 under the CPU tests' relative yardstick
    (``test_torch_variants.py``): the card's result lies no further from the
    CPU float32 result than the CPU bfloat16 result does, plus one bfloat16
    unit of the depth for the depth; so no further from the CPU bfloat16
    result than twice that."""
    from dynamic_video_depth_tpu_torch.train import LossConfig, TrainStepConfig

    def cfg(dtype):
        return TrainStepConfig(
            lr=1e-6, scene_lr_mul=1000.0, depth_net="midas", midas=True,
            compute_dtype=dtype, loss=LossConfig(
                flow_mul=1.0, disp_mul=1.0, acc_mul=1.0, use_disp=True,
                midas=True))

    card, depth, launches = _steps_on(cfg("bfloat16"), small_track, dev,
                                      bias_midas=True)
    assert all(launches[k] > 0 for k in ("warp_fwd", "warp_bwd", "mlp_fwd",
                                         "chain_bwd", "loss_fwd",
                                         "loss_bwd")), launches
    assert launches["head_conv_fwd"] == 0  # bfloat16 takes F.conv2d
    cpu, cpu_depth, _ = _steps_on(cfg("bfloat16"), small_track, "cpu",
                                  bias_midas=True)
    f32, f32_depth, _ = _steps_on(cfg("float32"), small_track, "cpu",
                                  bias_midas=True)
    ulp = 2.0 ** (torch.floor(torch.log2(f32_depth.abs().max())) - 7).item()
    gap = (cpu_depth - f32_depth).abs().max().item()
    assert gap > 0.0
    assert (depth - f32_depth).abs().max().item() <= gap + ulp
    assert (depth - cpu_depth).abs().max().item() <= 2 * gap + ulp
    for c, b, f in zip(card, cpu, f32):
        for k in ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss"):
            loss_gap = abs(b[k] - f[k])
            assert abs(c[k] - f[k]) <= 2 * loss_gap + 1e-4 * abs(f[k]), k
    assert card[0]["loss"] > 0.0 and card[1]["loss"] > 0.0


def test_f32_midas_step_launches_the_head_conv_once_a_step(dev,
                                                           small_track):
    """A float32 MiDaS warm-up and main step on the card run the depth
    head's first convolution through its kernel, once a step, and the
    losses match the same steps on the CPU (``F.conv2d`` there) at rtol
    1e-4."""
    from dynamic_video_depth_tpu_torch.train import LossConfig, TrainStepConfig

    cfg = TrainStepConfig(
        lr=1e-6, scene_lr_mul=1000.0, depth_net="midas", midas=True,
        loss=LossConfig(flow_mul=1.0, disp_mul=1.0, acc_mul=1.0,
                        use_disp=True, midas=True))
    card, _, launches = _steps_on(cfg, small_track, dev, bias_midas=True)
    assert launches["head_conv_fwd"] == 2, launches
    cpu, _, _ = _steps_on(cfg, small_track, "cpu", bias_midas=True)
    for c, p in zip(card, cpu):
        for k in ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss"):
            assert abs(c[k] - p[k]) <= 1e-4 * abs(p[k]) + 1e-7, k
    assert card[1]["loss"] > 0.0


def test_cnn_sgd_step_on_the_card(dev, small_track):
    """``--use_cnn`` with SGD on the card: kernels A and D only (no B, no
    chain), and the losses of a warm-up and a main step agree with the
    plain CPU steps at rtol 1e-4."""
    from dynamic_video_depth_tpu_torch.train import LossConfig, TrainStepConfig

    cfg = TrainStepConfig(
        lr=1e-4, scene_lr_mul=10.0, depth_net="tiny", use_cnn=True,
        optim="sgd", sgd_dampening=0.1, wdecay=1e-4, log_grad_stats=True,
        loss=LossConfig(flow_mul=1.0, disp_mul=1.0, acc_mul=1.0,
                        use_disp=True))
    card, _, launches = _steps_on(cfg, small_track, dev)
    assert all(launches[k] > 0 for k in ("warp_fwd", "warp_bwd", "loss_fwd",
                                         "loss_bwd")), launches
    assert not any(launches[k] for k in ("mlp_fwd", "mlp_bwd",
                                         "chain_bwd")), launches
    cpu, _, _ = _steps_on(cfg, small_track, "cpu")
    for c, p in zip(card, cpu):
        for k in p:
            assert c[k] == pytest.approx(p[k], rel=1e-4, abs=1e-7), k
    assert card[0]["grad_norm_depth"] == 0.0 < card[1]["grad_norm_depth"]


# ------------------------------------------------------ data parallelism

@pytest.fixture(scope="module")
def pair_batch(tmp_path_factory):
    """Two gap-2 pairs of a 64x64 synthetic track, as one host batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from argparse import Namespace

    from dynamic_video_depth_tpu_torch.data.batches import collate_batches
    from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("dp_track"))
    make_track(root, track="dog", n_frames=6, h=64, w=64, gaps=(1, 2))
    ds = Dataset(Namespace(track_id="dog", data_root=root, gaps="2",
                           subsample=False), "train")
    host = collate_batches([ds[0], ds[1]])
    return {k: v for k, v in host.items() if k not in ("steps", "pair_path")}


def _dp_ranks(tmp_path, devices, backend, batch):
    """One warm-up and one main step at gap 2 of ``DataParallelStep`` over
    two ranks on ``devices`` (the fused paths; their plain versions on the
    CPU): each rank's logs and nets."""
    import pickle

    import torch_parallel_worker as worker
    from dynamic_video_depth_tpu_torch.train import LossConfig, TrainStepConfig

    cfg = TrainStepConfig(
        lr=1e-4, scene_lr_mul=10.0, depth_net="tiny",
        use_pallas_sf_chain="on", use_pallas_loss="on",
        loss=LossConfig(flow_mul=1.0, disp_mul=1.0, acc_mul=1.0,
                        use_disp=True))
    cases = {"dp": dict(kind="dp", cfg=cfg, init=None, batch=batch,
                        schedule=((2, True), (2, False)))}
    d = tmp_path / backend / devices[0].replace(":", "")
    d.mkdir(parents=True)
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    torch.multiprocessing.spawn(
        worker.run, args=(2, str(d / "rendezvous"), str(d / "cases.pkl"),
                          str(d), devices, backend), nprocs=2, join=True)
    out = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f)["dp"])
    return out


def _check_dp_on_card(card, cpu):
    import numpy as np

    for a, b in zip(card[0]["state"], card[1]["state"]):  # replicas
        assert all(np.array_equal(a[k], b[k]) for k in a)
    for c, p in zip(card[0]["logs"], cpu[0]["logs"]):
        for k in p:
            assert c[k] == pytest.approx(p[k], rel=1e-4, abs=1e-7), k
    assert card[0]["logs"][0]["acc_reg"] == 0.0 < card[0]["logs"][1]["acc_reg"]


def test_data_parallel_step_on_the_card_matches_the_cpu(tmp_path,
                                                        pair_batch):
    """Two gloo ranks sharing cuda:0 (kernels A-D) take the steps of two
    gloo ranks on the CPU (the plain versions): the losses at rtol 1e-4,
    and the ranks' nets bit for bit."""
    card = _dp_ranks(tmp_path, ["cuda:0", "cuda:0"], "gloo", pair_batch)
    cpu = _dp_ranks(tmp_path, ["cpu", "cpu"], "gloo", pair_batch)
    _check_dp_on_card(card, cpu)


def test_data_parallel_step_over_nccl(tmp_path, pair_batch):
    """The same steps on NCCL, a rank a card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL across cards needs two CUDA devices; this "
                    f"machine has {torch.cuda.device_count()}")
    card = _dp_ranks(tmp_path, ["cuda:0", "cuda:1"], "nccl", pair_batch)
    cpu = _dp_ranks(tmp_path, ["cpu", "cpu"], "gloo", pair_batch)
    _check_dp_on_card(card, cpu)


# ------------------------------------------------------- the input pipeline

def test_prefetcher_side_stream_copy_equals_a_synchronous_copy(dev):
    """Pinned batches copied one ahead on a side stream reach steps that
    lag behind (a large product queued before each read) and free their
    batch at once, bit for bit as synchronous copies: the consuming stream
    waits for each copy, and ``record_stream`` keeps a batch's memory from
    the next copy until the step has read it."""
    from dynamic_video_depth_tpu_torch.data.batches import host_tensors
    from dynamic_video_depth_tpu_torch.data.prefetch import DevicePrefetcher

    gen = torch.Generator().manual_seed(0)
    hosts = [{"img_1": torch.rand(1, 224, 384, 3, generator=gen).numpy(),
              "flow_1_2": torch.randn(1, 224, 384, 2, generator=gen).numpy(),
              "steps": 2, "pair_path": f"pair{i}"} for i in range(12)]
    items = [(i, host_tensors(h, pin=True)) for i, h in enumerate(hosts)]
    big = torch.randn(4096, 4096, device=dev)
    seen = []
    for i, batch, host in DevicePrefetcher(items, dev):
        assert host == {"steps": 2, "pair_path": f"pair{i}"}
        big = big @ big / 64.0  # the consuming stream falls behind
        seen.append((i, {k: v * 1.0 for k, v in batch.items()}))
        del batch
    torch.cuda.synchronize()
    assert [i for i, _ in seen] == list(range(12))
    for i, got in seen:
        for k in ("img_1", "flow_1_2"):
            want = torch.as_tensor(hosts[i][k]).to(dev)
            assert torch.equal(got[k], want), (i, k)


def test_cached_midas_step_launches_a_to_d_and_matches_streaming(
        dev, tmp_path):
    """A 64x64 MiDaS run (the fixture's biased output conv), a warm-up and
    a main epoch of three steps, from the device cache and with
    ``--no_device_cache``: the cached run launches kernels A-D, and both
    give the same losses within rtol 1e-5. Two free runs part once the
    depth net trains (the warp's backward adds in atomic order, cuDNN's
    weight gradients may; ~2e-5 after two main steps), so the streaming
    run starts each main step from the cached run's depth parameters, as
    ``chip_smoke.py`` phase 11 (a) does."""
    from dynamic_video_depth_tpu_torch.data.prefetch import DeviceCache
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train.cli import build_trainer

    root = str(tmp_path)
    make_track(root, track="dog", n_frames=4, h=64, w=64, gaps=(1, 2))
    hist, launches, states = {}, {}, []
    for cached in (True, False):
        argv = ["--track_id", "dog", "--gaps", "1,2", "--data_root", root,
                "--midas", "--epoch", "2", "--warm_sf", "1",
                "--epoch_batches", "3", "--vali_batches", "1",
                "--batch_size", "1", "--lr", "1e-6", "--scene_lr_mul",
                "1000", "--time_dependent", "--use_disp", "--manual_seed",
                "0", "--save_net", "0", "--vis_every_train", "0",
                "--vis_every_vali", "0", "--logdir",
                str(tmp_path / f"run{int(cached)}")]
        if not cached:
            argv.append("--no_device_cache")
        trainer = build_trainer(argv)
        assert isinstance(trainer.train_source, DeviceCache) == cached
        step = trainer.step
        bias_midas_output(step.net_depth)
        feed = None if cached else iter(states)

        def train_step(batch, steps, warm, _step=step, _feed=feed,
                       _real=step.train_step):
            if not warm:
                params = list(_step.net_depth.parameters())
                if _feed is None:
                    states.append([p.detach().clone() for p in params])
                else:
                    with torch.no_grad():
                        for p, q in zip(params, next(_feed)):
                            p.copy_(q)
            return _real(batch, steps, warm)

        step.train_step = train_step
        kernels.reset_launches()
        trainer.train()
        launches[cached] = kernels.launch_counts()
        hist[cached] = trainer.history
    assert all(launches[True][k] > 0 for k in (
        "warp_fwd", "warp_bwd", "mlp_fwd", "chain_bwd", "loss_fwd",
        "loss_bwd")), launches[True]
    assert len(hist[True]) == len(hist[False]) == 6
    for a, b in zip(hist[True], hist[False]):
        for k in ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss",
                  "acc_reg"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)
    assert all(r["loss"] > 0.0 for r in hist[True])


# ------------------------------------- the saver, the mask head, the geometry

def test_async_saver_on_the_card_matches_a_synchronous_save(dev, tmp_path):
    """``AsyncSaver`` on the card: the clone is ordered before an in-place
    update queued right after ``save`` (the next optimizer step), and the
    file holds ``save_checkpoint``'s keys, dtypes and values bit for bit,
    its storages on the CPU."""
    from dynamic_video_depth_tpu_torch.runtime import checkpoint as ck
    from dynamic_video_depth_tpu_torch.train import (LossConfig,
                                                     SceneFlowMotionFieldStep,
                                                     TrainStepConfig)

    cfg = TrainStepConfig(lr=1e-4, depth_net="tiny", net_width=32,
                          n_layers=2, n_freq_xyz=4, n_freq_t=2,
                          loss=LossConfig(use_disp=True))
    step = SceneFlowMotionFieldStep(cfg, device="cuda", seed=0)
    for opt in step.optimizers:  # Adam state on the card
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = torch.ones_like(p)
        opt.step()
    sync = str(tmp_path / "sync.pt")
    ck.save_checkpoint(sync, step, epoch=3, best=0.5)
    saver = ck.AsyncSaver("cuda")
    path = str(tmp_path / "async.pt")
    saver.save(path, step, epoch=3, best=0.5)
    with torch.no_grad():
        for p in step.net_depth.parameters():
            p.mul_(2.0).add_(1.0)
    saver.close()

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return (a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.cpu(), b.cpu()))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b

    assert same(ck.read_checkpoint(path), ck.read_checkpoint(sync))
    raw = torch.load(path, weights_only=True)
    assert all(t.device.type == "cpu" for t in raw["nets"][0].values())
    assert saver.records[0].blocking < saver.records[0].seconds + 1.0


def test_midas_mask_head_on_the_card_matches_the_cpu(dev):
    """MidasNet_mod with ``freeze_backbone`` at 64x64 on the card and on
    the CPU in float32, against the CPU in float64: the card's error in the
    depth, the mask and the heads' gradients (worst over parameters) within
    ``chip_smoke.MASK_FACTOR`` times the float32 CPU run's; the backbone
    takes no gradient."""
    import copy

    from chip_smoke import MASK_FACTOR
    from dynamic_video_depth_tpu_torch.models import MidasNet
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)

    gen = torch.Generator().manual_seed(0)
    cpu = bias_midas_output(MidasNet(mask_branch=True, freeze_backbone=True,
                                     generator=gen))
    card = MidasNet(mask_branch=True, freeze_backbone=True).to(dev)
    card.load_state_dict(cpu.state_dict())
    img = torch.rand(2, 64, 64, 3, generator=gen)
    outs = []
    for net, x in ((copy.deepcopy(cpu).double(), img.double()), (cpu, img),
                   (card, img.to(dev))):
        depth, mask = net(x)
        (depth.sum() * 1e-3 + mask.sum()).backward()
        outs.append(([depth.detach().cpu().double(),
                      mask.detach().cpu().double()],
                     {n: p.grad for n, p in net.named_parameters()}))
    (ref, ref_g), (f32, f32_g), (on_card, card_g) = outs
    for a, b, r in zip(on_card, f32, ref):
        assert _rel(a, r) <= MASK_FACTOR * _rel(b, r)
    worst = {"f32": 0.0, "card": 0.0}
    for name, g in ref_g.items():
        if name.startswith("pretrained."):
            assert g is None and f32_g[name] is None \
                and card_g[name] is None, name
            continue
        worst["f32"] = max(worst["f32"], _rel(f32_g[name].double(), g))
        worst["card"] = max(worst["card"],
                            _rel(card_g[name].cpu().double(), g))
    assert worst["card"] <= MASK_FACTOR * worst["f32"], worst


def test_reference_geometry_on_the_card_matches_the_cpu(dev):
    """``flow_by_depth`` and ``scene_flow_projection`` at 224x384 on the
    card (kernel A at C=3 and C=4, forward and backward) against the CPU
    (the warp's plain version): values within relative 1e-5, the depths'
    gradients within 1e-5; ``rigidity_loss`` within 1e-5."""
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels
    from dynamic_video_depth_tpu_torch.ops import geometry
    from dynamic_video_depth_tpu_torch.ops.camera import Camera

    gen = torch.Generator().manual_seed(0)
    b, h, w = 1, 224, 384
    f = 0.8 * w
    K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])[None]
    cams = [Camera(torch.eye(3)[None], 0.05 * torch.randn(1, 3, generator=gen),
                   K, torch.linalg.inv(K)) for _ in range(2)]
    d1 = 2.0 + 3.0 * torch.rand(b, h, w, generator=gen)
    d2 = 2.0 + 3.0 * torch.rand(b, h, w, generator=gen)
    flow = track_flows(h, w, 2, n=b)
    sf = 0.05 * torch.randn(b, h, w, 3, generator=gen)
    results = []
    kernels.reset_launches()
    for device in ("cpu", dev):
        c1, c2 = (Camera(*(t.to(device) for t in c)) for c in cams)
        x1, x2 = (d.to(device, copy=True).requires_grad_() for d in (d1, d2))
        fbd = geometry.flow_by_depth(x1, x2, flow.to(device), c1, c2)
        pr = geometry.scene_flow_projection(x1, x2, flow.to(device), c1, c2,
                                            sf.to(device))
        (fbd["sf_by_depth"].abs().sum() + pr["depth_warp_1_2"].sum()
         + pr["warped_p2_camera_2"].abs().sum()).backward()
        rig, _ = geometry.rigidity_loss(fbd["global_p1"].detach(),
                                        sf.to(device), d1.to(device))
        results.append((fbd, pr, x1.grad, x2.grad, rig))
    variants = kernels.launch_variants()
    for c in (3, 4):
        assert variants.get(("warp_fwd", c)) == 1 and \
            variants.get(("warp_bwd", c)) == 1, variants
    (f0, p0, g10, g20, r0), (f1, p1, g11, g21, r1) = results
    for k in f0:
        assert _rel(f1[k].detach().cpu(), f0[k].detach()) <= 1e-5, k
    for k in p0:
        assert _rel(p1[k].detach().cpu(), p0[k].detach()) <= 1e-5, k
    assert _rel(g11.cpu(), g10) <= 1e-5 and _rel(g21.cpu(), g20) <= 1e-5
    assert _rel(r1.cpu(), r0) <= 1e-5


# the head convolution's error against float64 within this many times
# cuDNN float32's (the method of the mask head's test)
HEAD_FACTOR = 10


def _head_inputs(n, cin, h, w, cout, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, h, w, generator=g)
    wt = torch.randn(cout, cin, 3, 3, generator=g) * (cin * 9) ** -0.5
    return x, wt, torch.randn(cout, generator=g)


@pytest.mark.parametrize("n,h,w,order", [
    (2, 112, 192, "nhwc"), (16, 112, 192, "nhwc"), (3, 37, 53, "nhwc"),
    (2, 112, 192, "nchw4"), (3, 37, 53, "nchw1")])
def test_head_conv_kernel_matches_float64(dev, n, h, w, order):
    """The kernel at the heads' shape (256 -> 128) at batch 2 and 16 and at
    odd H and W, channels-last (the nets' order) and contiguous (16- and
    4-byte copies), against a float64 CPU convolution: within
    ``HEAD_FACTOR`` times cuDNN float32's error."""
    import torch.nn.functional as F

    x, wt, b = _head_inputs(n, 256, h, w, 128)
    ref = F.conv2d(x.double(), wt.double(), b.double(), padding=1)
    xd, wd, bd = x.to(dev), wt.to(dev), b.to(dev)
    if order == "nhwc":
        xd = xd.to(memory_format=torch.channels_last)
    head_conv_kernel.reset_launches()
    got = head_conv_kernel.head_conv_forward_cuda(xd, wd, bd)
    assert got.is_contiguous(memory_format=torch.channels_last
                             if order == "nhwc" else torch.contiguous_format)
    got = got.cpu().double()
    lib = F.conv2d(xd, wd, bd, padding=1).cpu().double()
    assert head_conv_kernel.variants == {("head_conv_fwd", order): 1}
    err, lib_err = (got - ref).abs().max(), (lib - ref).abs().max()
    assert err <= HEAD_FACTOR * lib_err, (err, lib_err)


@pytest.mark.parametrize("order", [torch.channels_last,
                                   torch.contiguous_format])
def test_head_conv_module_gradients_equal_conv2d(dev, order):
    """Through ``HeadConv2d`` on the card the gradients of x, w and b are
    ``nn.Conv2d``'s (the same ``convolution_backward``), the output has
    ``nn.Conv2d``'s memory order, and the forward launched the kernel
    once."""
    from torch import nn

    from dynamic_video_depth_tpu_torch.models.midas import HeadConv2d

    x, wt, b = _head_inputs(2, 256, 112, 192, 128, seed=1)
    cot = torch.randn(2, 128, 112, 192,
                      generator=torch.Generator().manual_seed(2)).to(dev)
    head, plain = HeadConv2d(256, 128).to(dev), nn.Conv2d(
        256, 128, 3, padding=1).to(dev)
    for m in (head, plain):
        m.load_state_dict({"weight": wt, "bias": b})
    head_conv_kernel.reset_launches()
    grads, orders = [], []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for m in (head, plain):
            xi = x.to(dev).to(memory_format=order).requires_grad_(True)
            y = m(xi)
            orders.append(y.is_contiguous(memory_format=torch.channels_last))
            (y * cot).sum().backward()
            grads.append((xi.grad, m.weight.grad, m.bias.grad))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert head_conv_kernel.launches == {"head_conv_fwd": 1}
    assert orders[0] == orders[1]
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_head_conv_counts_float32_launches_only(dev):
    """One launch a float32 forward, none for a bfloat16 input (the
    bfloat16 depth compute takes ``F.conv2d``)."""
    from dynamic_video_depth_tpu_torch.models.midas import HeadConv2d

    head = HeadConv2d(256, 128).to(dev)
    x = torch.randn(1, 256, 16, 24, device=dev)
    head_conv_kernel.reset_launches()
    with torch.no_grad():
        head(x)
        head(x)
        assert head_conv_kernel.launches == {"head_conv_fwd": 2}
        head.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert head_conv_kernel.launches == {"head_conv_fwd": 2}


@pytest.mark.parametrize("what", ["strided", "cin", "cout"])
def test_head_conv_wrapper_raises_on_the_card(dev, what):
    x, wt, b = (t.to(dev) for t in _head_inputs(1, 256, 8, 12, 128))
    if what == "strided":  # neither contiguous nor channels-last
        x = x.transpose(2, 3)
    elif what == "cin":
        x, wt = x[:, :12].contiguous(), wt[:, :12].contiguous()
    else:
        wt, b = wt[:64].contiguous(), b[:64].contiguous()
    head_conv_kernel.reset_launches()
    with pytest.raises(ValueError):
        head_conv_kernel.head_conv_forward_cuda(x, wt, b)
    assert head_conv_kernel.launches == {"head_conv_fwd": 0}
