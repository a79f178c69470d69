"""The port's DPT-Large (``models/dpt.py``) against the benchmark's plain
reference (``benchmark/configs/dpt_large.py``): at a tiny size on the CPU
the forward and every parameter's gradient agree; at full width (on the
``meta`` device) the state dicts hold the same keys and shapes. Then the
train entry's wiring (the net, the loss's MiDaS masks, the checkpoint it
looks for) and the spans of its forward."""

import json
import os
import types

import pytest
import torch

from benchmark import spec
from dynamic_video_depth_tpu_torch.models import DPTDepthNet
from dynamic_video_depth_tpu_torch.runtime import weights
from dynamic_video_depth_tpu_torch.train import cli
from dynamic_video_depth_tpu_torch.train import scene_flow_motion_field as sfm
from dynamic_video_depth_tpu_torch.train.step import SceneFlowMotionFieldStep

CONFIG = os.path.join(spec.HERE, "configs", "dpt_large.json")
# width 64 in 4 heads, 4 blocks all hooked, a 3x3 pretraining grid: a
# 64x96 image has a 4x6 patch grid, so the positional resize is non-square
TINY = dict(hidden_size=64, num_layers=4, num_heads=4, mlp_size=256,
            hooks=[0, 1, 2, 3], pretrain_grid=3, reassemble=[16, 32, 64, 64],
            features=32)
# Two float32 computations of the same equations that differ only in the
# order of their sums (fused attention against an explicit softmax,
# another reshape order) part by a few float32 ulps an op; over the net's
# ~40 layers that reads ~1e-6 here. A wrong equation (the v2 skip, the
# other corner alignment, a square resize) reads 1e-3 or more.
TOL = 1e-5
# published count: ours plus the ViT's final norm (2,048), its classifier
# head (1,025,000) and refinenet4.resConfUnit1 (1,180,160), built by the
# original and never read
PARAMS = 341_848_257
UNUSED = 2_048 + 1_025_000 + 1_180_160


def reference_module():
    return spec.load_module(os.path.join(spec.HERE, "configs",
                                         "dpt_large.py"), "bench_ref_dpt")


def config(**over):
    with open(CONFIG) as f:
        return dict(json.load(f), **over)


def port_net(cfg, generator=None):
    return DPTDepthNet(
        patch=cfg["patch_size"], dim=cfg["hidden_size"],
        depth=cfg["num_layers"], heads=cfg["num_heads"], mlp=cfg["mlp_size"],
        hooks=cfg["hooks"], grid=cfg["pretrain_grid"],
        reassemble=cfg["reassemble"], features=cfg["features"],
        generator=generator)


def random_state(net, seed):
    """Every leaf random, ``pos_embed`` and ``cls_token`` included; the
    output bias keeps the last ReLU open."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in net.state_dict().items():
        scale = v[0].numel() ** -0.5 if v.dim() >= 2 else 0.5
        state[k] = torch.randn(v.shape, generator=g) * scale
        if k.endswith("norm1.weight") or k.endswith("norm2.weight"):
            state[k] += 1.0
    state["scratch.output_conv.4.bias"].fill_(3.0)
    return state


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_tiny_dpt_matches_reference_forward_and_gradients():
    cfg = config(**TINY)
    ref, port = reference_module().build(cfg), port_net(cfg)
    state = random_state(ref, 0)
    ref.load_state_dict(state)
    port.load_state_dict(state)
    g = torch.Generator().manual_seed(1)
    img = torch.rand(2, 64, 96, 3, generator=g)
    # positive, so that no gradient is a sum that cancels
    weight = 0.5 + torch.rand(2, 64, 96, generator=g)
    outs = []
    for net in (port, ref):
        depth = net(img)
        (depth * weight).sum().backward()
        outs.append(depth.detach())
    d_port, d_ref = outs
    assert d_ref.shape == (2, 64, 96)
    assert float(d_ref.std()) > 1e-2 * float(d_ref.mean())  # not flat
    assert float(((d_port - d_ref).abs() / d_ref.abs()).max()) <= TOL
    ref_params = dict(ref.named_parameters())
    grads = 0
    for k, p in port.named_parameters():
        want = ref_params[k].grad
        assert float(torch.linalg.vector_norm(want)) > 0, k
        assert rel(p.grad, want) <= TOL, k
        grads += 1
    assert grads == len(ref_params)


def test_full_width_state_dict_matches_reference():
    cfg = config()
    with torch.device("meta"):
        ref, port = reference_module().build(cfg), DPTDepthNet()
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    n = sum(p.numel() for p in port.parameters())
    assert n == PARAMS == sum(p.numel() for p in ref.parameters())
    assert 343e6 <= n + UNUSED <= 345e6
    blocks = port.pretrained.model.blocks
    assert len(blocks) == 24 and blocks[0].attn.heads == 16
    assert want["pretrained.model.blocks.23.mlp.fc1.weight"] == (4096, 1024)
    assert want["pretrained.model.pos_embed"] == (1, 577, 1024)
    assert [want[f"scratch.layer{i}_rn.weight"][1] for i in (1, 2, 3, 4)] \
        == [256, 512, 1024, 1024]


ARGV = ["--net", "scene_flow_motion_field", "--dataset", "davis_sequence",
        "--track_id", "dog", "--time_dependent", "--use_disp",
        "--depth_net", "dpt_large"]


def test_step_config_and_pretrained_path(tmp_path, monkeypatch, capsys):
    """``--depth_net dpt_large`` gives the DPT with the MiDaS loss masks,
    and the model loads its own checkpoint, leftovers and all."""
    cfg = sfm.step_config(cli.build_parser().parse_args(ARGV))
    assert (cfg.depth_net, cfg.loss.midas) == ("dpt_large", True)
    tiny = port_net(config(**TINY))
    model = types.SimpleNamespace(
        cfg=cfg, step=types.SimpleNamespace(net_depth=tiny))
    path = str(tmp_path / "dpt_large.pt")
    monkeypatch.setattr(weights, "DPT_PRETRAIN_PATH", path)
    assert sfm.Model.load_pretrained(model) is False
    assert path in capsys.readouterr().out
    state = random_state(tiny, 2)
    extra = {"pretrained.model.norm.weight": torch.ones(64),
             "pretrained.model.head.weight": torch.zeros(10, 64),
             "scratch.refinenet4.resConfUnit1.conv1.weight":
                 torch.zeros(32, 32, 3, 3)}
    torch.save(dict(state, **extra), path)
    assert sfm.Model.load_pretrained(model) is True
    for k, v in tiny.state_dict().items():
        assert torch.equal(v, state[k]), k
    torch.save(dict(state, **{"pretrained.model.blocks.9.x": torch.ones(1)}),
               path)
    with pytest.raises(KeyError, match="not consumed"):
        sfm.Model.load_pretrained(model)


def test_vit_and_head_spans_nest_in_depth_net():
    step = SceneFlowMotionFieldStep(sfm.step_config(cli.build_parser()
                                    .parse_args(ARGV[:-1] + ["tiny"])),
                                    device="cpu")
    step.net_depth = port_net(config(**TINY))
    img = torch.rand(1, 64, 96, 3)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        step._depths({"img_1": img, "img_2": img}, depth_grad=True)
    spans = {}
    for e in prof.events():
        if e.name.startswith("dvd/"):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    assert sorted(spans) == ["dvd/depth_net", "dvd/dpt_head", "dvd/vit"]
    assert all(len(v) == 1 for v in spans.values())
    (a, b), = spans["dvd/depth_net"]
    (vs, ve), = spans["dvd/vit"]
    (hs, he), = spans["dvd/dpt_head"]
    assert a <= vs <= ve <= hs <= he <= b
