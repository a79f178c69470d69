"""``dptcount`` equals hand counts: one transformer block's dense layers
and attention, and one transposed convolution, at the cell's 224x384."""

import pytest
import torch

from benchmark import dptcount, spec, workcount

IMAGES, H, W = 16, 224, 384
N = 1 + (H // 16) * (W // 16)  # 337 tokens: the class token and 14x24
C = 1024


@pytest.fixture(scope="module")
def calls():
    cell = spec.load_cell(dptcount.WORKLOAD)
    with torch.device("meta"):
        net = cell.build_reference(cell.config)
    return dptcount.shapes(net, IMAGES, H, W)


def test_one_block_by_hand(calls):
    # the first block: qkv, proj, then attention (a hook fires when its
    # module returns), fc1, fc2
    qkv, proj, att, fc1, fc2 = calls[:5]
    assert [c["kind"] for c in calls[:5]] == [
        "linear", "linear", "attention", "linear", "linear"]
    assert qkv["weight"] == (3 * C, C) and fc1["weight"] == (4 * C, C)
    assert att == {"kind": "attention", "batch": IMAGES, "tokens": N,
                   "heads": 16, "head_dim": 64}
    dense = 2 * IMAGES * N * C * C * (3 + 1 + 4 + 4)
    products = 2 * 2 * IMAGES * 16 * N * N * 64
    assert sum(map(dptcount.flops, (qkv, proj, fc1, fc2))) == dense
    assert dptcount.flops(att) == products
    # forward, data and weight gradients; the attention's three passes
    assert dptcount.work([qkv, att, proj, fc1, fc2], "float32")["flops"] \
        == 3 * dense + 3 * products
    rows = IMAGES * N
    assert dptcount.work([qkv], "float32")["bytes"] == 4 * 3 * (
        rows * C + 3 * C * C + rows * 3 * C)
    assert dptcount.work([att], "float32")["bytes"] == 4 * 12 * (
        IMAGES * 16 * N * 64)


def test_one_conv_transpose_by_hand(calls):
    ct = [c for c in calls if c["kind"] == "conv_transpose"]
    assert len(ct) == 2
    first = ct[0]  # reassembly 1: 256 -> 256, 4x4 stride 4, 14x24 -> 56x96
    assert first["input"] == (IMAGES, 256, 14, 24)
    assert first["output"] == (IMAGES, 256, 56, 96)
    flops = 2 * IMAGES * 14 * 24 * 256 * 256 * 4 * 4
    assert dptcount.flops(first) == flops
    x, wt, y = IMAGES * 256 * 14 * 24, 256 * 256 * 16, IMAGES * 256 * 56 * 96
    assert dptcount.work([first], "float32") == {
        "flops": 3.0 * flops, "bytes": 4.0 * 3 * (x + wt + y)}


def test_the_whole_count(calls):
    kinds = [c["kind"] for c in calls]
    assert kinds.count("attention") == 24
    assert kinds.count("linear") == 24 * 4 + 4  # blocks and readouts
    convs, rest = dptcount.cell_work()
    # ~221 GFLOP an image forward in the ViT and readouts, beside the
    # patch embedding (a convolution)
    vit = sum(dptcount.flops(c) for c in calls
              if c["kind"] != "conv_transpose") / IMAGES
    assert 219e9 < vit < 222e9
    # a main step, forward and backward: ~14 TFLOP
    assert 13e12 < convs["flops"] + rest["flops"] < 15e12
    assert rest["flops"] > 3 * convs["flops"]
    assert workcount.least_seconds(
        {k: convs[k] + rest[k] for k in convs}, "float32") \
        == pytest.approx((convs["flops"] + rest["flops"]) / 495e12)
