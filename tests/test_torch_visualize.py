"""The port's host-side helpers against the JAX package's: depth and flow
colouring, the visualizer's key routing and pages, the standard-library
PNG writer (decoded with PIL to the pixels that the JAX visualizer writes),
``.flo`` files, the depth metrics, the HTML builders and the printing
helpers. The port carries the turbo table itself; it lies within 1/255 of
matplotlib's."""

import os

import numpy as np
import pytest
from PIL import Image

from dynamic_video_depth_tpu_torch.utils import (colormap, flow_io, flow_viz,
                                                 html, metrics, printing,
                                                 visualizer)

import dynamic_video_depth_tpu.utils.colormap as jax_colormap
import dynamic_video_depth_tpu.utils.flow_io as jax_flow_io
import dynamic_video_depth_tpu.utils.flow_viz as jax_flow_viz
import dynamic_video_depth_tpu.utils.html as jax_html
import dynamic_video_depth_tpu.utils.metrics as jax_metrics
import dynamic_video_depth_tpu.utils.printing as jax_printing
import dynamic_video_depth_tpu.utils.visualizer as jax_visualizer
from torch_threads import one_torch_thread  # noqa: F401


def test_turbo_table_is_matplotlibs():
    import matplotlib

    x = np.linspace(0.0, 1.0, 4097)
    ref = matplotlib.colormaps["turbo"](x)[:, :3]
    assert colormap.TURBO.shape == (256, 3)
    assert np.abs(colormap.turbo(x) - ref).max() <= 1 / 255
    assert np.abs(colormap.TURBO - matplotlib.colormaps["turbo"](
        np.arange(256) / 255.0)[:, :3]).max() <= 1 / 255


@pytest.mark.parametrize("invert,limits", [(True, None), (False, None),
                                           (True, (0.1, 0.9))])
def test_depth_to_image_matches_jax(rng, invert, limits):
    depth = 0.5 + 10 * rng.rand(17, 23)
    depth[0, 0] = 0.0  # a hole, clipped as the JAX package clips it
    kw = {} if limits is None else dict(vmin=limits[0], vmax=limits[1])
    got = colormap.depth_to_image(depth, invert=invert, **kw)
    want = jax_colormap.depth_to_image(depth, invert=invert, **kw)
    assert got.dtype == np.uint8 and got.shape == (17, 23, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_flow", [None, 3.0])
def test_flow_to_image_matches_jax(rng, max_flow):
    flow = 4 * rng.randn(19, 21, 2).astype(np.float32)
    np.testing.assert_array_equal(
        flow_viz.flow_to_image(flow, max_flow=max_flow),
        jax_flow_viz.flow_to_image(flow, max_flow=max_flow))


@pytest.mark.parametrize("key,shape", [
    ("depth", (1, 8, 12)), ("depth_1", (1, 8, 12, 1)), ("depth_nn", (8, 12)),
    ("flow_1_2", (1, 8, 12, 2)), ("img_1", (1, 8, 12, 3)),
    ("img_chw", (3, 8, 12)), ("sf_1_2", (1, 8, 12, 3)),
    ("sf_loss_pp", (1, 8, 12))])
def test_convert_for_display_matches_jax(rng, key, shape):
    value = (0.1 + rng.rand(*shape)).astype(np.float32)
    got = visualizer.convert_for_display(key, value)
    want = jax_visualizer.convert_for_display(key, value)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def _pack(rng, h=8, w=12):
    return {"depth": 0.5 + rng.rand(1, h, w).astype(np.float32),
            "img_1": rng.rand(1, h, w, 3).astype(np.float32),
            "flow_1_2": rng.randn(1, h, w, 2).astype(np.float32),
            "sf_1_2": rng.randn(1, h, w, 3).astype(np.float32),
            "pair_path": np.asarray("a/b.pt")}


def test_visualizer_pngs_decode_to_the_jax_pixels(rng, tmp_path):
    """Both visualizers over the same batches: the same PNG names, the same
    pixels once decoded, the same index.html (a later batch with a key
    fewer keeps the table's columns)."""
    packs = [_pack(rng), _pack(rng)]
    del packs[1]["flow_1_2"]
    for name, mod in (("port", visualizer), ("jax", jax_visualizer)):
        vis = mod.HTMLVisualizer(n_workers=2)
        for i, pack in enumerate(packs):
            vis.visualize(pack, 1000 + i, str(tmp_path / name / "epoch0001"))
        vis.close()
    port, ref = tmp_path / "port" / "epoch0001", tmp_path / "jax" / "epoch0001"
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names
    assert len([n for n in names if n.endswith(".png")]) == 5
    for n in names:
        if n.endswith(".png"):
            a = np.asarray(Image.open(port / n))
            b = np.asarray(Image.open(ref / n))
            assert a.shape == b.shape and a.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=n)
    assert (port / "index.html").read_text() == \
        (ref / "index.html").read_text()


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (64, 96)])
def test_png_writer_round_trips(rng, tmp_path, h, w):
    rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    visualizer.write_png(path, rgb)
    img = Image.open(path)
    assert img.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(img), rgb)
    with pytest.raises(ValueError):
        visualizer.encode_png(rgb[..., :2])


def test_flo_files_round_trip_with_jax(rng, tmp_path):
    flow = rng.randn(6, 9, 2).astype(np.float32)
    ours, theirs = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    flow_io.write_flo(ours, flow)
    jax_flow_io.write_flo(theirs, flow)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(flow_io.read_flo(theirs), flow)
    with open(ours, "r+b") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(ValueError, match="magic"):
        flow_io.read_flo(ours)


@pytest.mark.parametrize("holes", [False, True])
def test_depth_metrics_match_jax(rng, holes):
    gt = 1 + 5 * rng.rand(3, 10, 14)
    if holes:
        gt[:, :4] = 0.0
    pred = gt * (1 + 0.2 * rng.randn(*gt.shape))
    got = metrics.depth_metrics(pred, gt)
    want = jax_metrics.depth_metrics(pred, gt)
    assert sorted(got) == sorted(want) == sorted(metrics.METRIC_KEYS)
    for k in want:
        assert got[k] == want[k], k
    assert metrics.scale_invariant_alignment(pred, gt) == \
        jax_metrics.scale_invariant_alignment(pred, gt)
    empty = metrics.depth_metrics(pred, np.zeros_like(gt))
    assert all(np.isnan(v) for v in empty.values())


def test_html_pages_match_jax(tmp_path):
    for name, mod in (("port", html), ("jax", jax_html)):
        page = mod.Webpage(title="t")
        page.add_video("v.mp4", title="loss 1")
        page.add_image("i.png", title="img")
        page.add_text("note")
        page.save(str(tmp_path / name / "page.html"))
        table = mod.ImageTable(title="tab")
        table.set_header(["batch", "depth"])
        table.add_row(["0001", "batch0001_depth.png"])
        table.add_row(["0002", ""])
        table.save(str(tmp_path / name / "table.html"))
    for f in ("page.html", "table.html"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()


def test_printing_matches_jax():
    assert printing.str_stage("x") == jax_printing.str_stage("x")
    import random

    import torch

    printing.set_manual_seed(3)
    a = (random.random(), np.random.rand(), torch.rand(1).item())
    printing.set_manual_seed(3)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item())
