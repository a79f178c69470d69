"""The work counts equal hand counts: one MiDaS convolution, one hourglass
convolution, one field evaluation."""

import pytest
import torch

from benchmark import spec, workcount


def convs(config_name, images=2, h=224, w=384):
    cell = next(spec.load_cell(w_["name"]) for w_ in
                spec.benchmark_json()["workloads"]
                if w_["config"] == config_name)
    with torch.device("meta"):
        net = cell.build_reference(cell.config)
    return workcount.conv_shapes(net, images, h, w)


def test_midas_stem_conv_by_hand():
    calls = convs("midas_v2")
    stem = calls[0]
    assert stem["weight"] == (64, 3, 7, 7) and not stem["dgrad"]
    flops = 2 * 2 * 112 * 192 * 64 * 3 * 7 * 7
    assert workcount.conv_flops(stem) == flops
    x, wt, y = 2 * 3 * 224 * 384, 64 * 3 * 49, 2 * 64 * 112 * 192
    # forward and weight gradient only: the image takes no gradient
    assert workcount.conv_work([stem], "float32") == {
        "flops": 2.0 * flops, "bytes": 4.0 * 2 * (x + wt + y)}
    # the first grouped 3x3 of stage 1: 256 -> 256 in 32 groups of 8
    # channels (32x8d) at 56x96
    grouped = next(c for c in calls if c["groups"] == 32)
    assert grouped["weight"] == (256, 8, 3, 3) and grouped["dgrad"]
    assert workcount.conv_flops(grouped) == 2 * 2 * 56 * 96 * 256 * 8 * 9
    assert len(calls) == 125
    assert sum(map(workcount.conv_flops, calls)) == 241367777280


def test_hourglass_prediction_conv_by_hand():
    calls = convs("mc_hourglass", images=16)
    pred = calls[-1]
    assert pred["weight"] == (1, 64, 3, 3) and pred["dgrad"]
    flops = 2 * 16 * 224 * 384 * 1 * 64 * 9
    assert workcount.conv_flops(pred) == flops
    x, wt, y = 16 * 64 * 224 * 384, 64 * 9, 16 * 224 * 384
    assert workcount.conv_work([pred], "bfloat16") == {
        "flops": 3.0 * flops, "bytes": 2.0 * 3 * (x + wt + y)}
    assert calls[0]["weight"] == (128, 3, 7, 7) and not calls[0]["dgrad"]


@pytest.mark.parametrize("gap,evals", [(1, 2), (2, 2), (6, 6), (8, 8)])
def test_field_evaluations_by_hand(gap, evals):
    field = spec.load_cell("midas_v2.recipe_f32").config["field"]
    points = 8 * 224 * 384
    assert points == 688128
    macs = 132 * 256 + 4 * 256 * 256 + 256 * 3
    work = workcount.field_work(field, points, gap)
    assert work["flops"] == 3 * 2 * points * macs * evals
    assert workcount.least_seconds(work, "float32") == pytest.approx(
        work["flops"] / 495e12)
