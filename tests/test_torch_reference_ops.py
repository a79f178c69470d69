"""The reference's unfused geometry, the packed camera format, the
residual block and the ``--net`` registry of the port against the JAX
package's, on the same numpy inputs from a seed.

Geometry tolerances are those of ``tests/test_torch_geometry.py``:
values 1e-5 (relative and absolute), gradients 1e-4 relative with an
absolute floor of 1e-4 of the gradient's largest entry. The fused stages
against the unfused functions use the JAX package's own identity test's
(``tests/test_geometry.py::test_merged_stages_match_composition``):
1e-4 relative, 1e-5 absolute.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.models import blocks as jblocks
from dynamic_video_depth_tpu.ops import camera as jcam
from dynamic_video_depth_tpu.ops import geometry as jgeo
from dynamic_video_depth_tpu_torch import models
from dynamic_video_depth_tpu_torch.models import ResConv2DBlock
from dynamic_video_depth_tpu_torch.ops import camera, geometry
from dynamic_video_depth_tpu_torch.ops.cuda import warp_kernel
from dynamic_video_depth_tpu_torch.runtime import weights

from test_torch_geometry import _cameras, _jax_cam, _torch_cam

B, H, W = 2, 12, 16


def _close(a, b, tol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _grad_close(a, b, rtol=1e-4):
    a, b = a.detach().numpy(), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()))


def _inputs(rng):
    d1 = (2.0 + 3.0 * rng.rand(B, H, W)).astype(np.float32)
    d2 = (2.0 + 3.0 * rng.rand(B, H, W)).astype(np.float32)
    flow = (3.0 * rng.randn(B, H, W, 2)).astype(np.float32)
    sf = (0.05 * rng.randn(B, H, W, 3)).astype(np.float32)
    c1, c2 = _cameras(rng, B, H, W)
    return d1, d2, flow, sf, c1, c2


def _weights(rng, shape):
    return rng.randn(*shape).astype(np.float32)


def _torch_loss(out: dict, wts: dict) -> torch.Tensor:
    return sum((out[k] * torch.from_numpy(w)).sum() for k, w in wts.items())


def _jax_loss(out: dict, wts: dict):
    return sum(jnp.sum(out[k] * jnp.asarray(w)) for k, w in wts.items())


def test_project_displacement_matches_jax(rng):
    pts = rng.randn(B, H, W, 3).astype(np.float32)
    pts[..., 2] = 2.0 + np.abs(pts[..., 2])
    pts[0, 0, 0, 2] = -1.0  # behind the camera: its own pixel, displacement 0
    c1, _ = _cameras(rng, B, H, W)
    g = _weights(rng, (B, H, W, 2))
    p = torch.from_numpy(pts).requires_grad_()
    ours = geometry.project_displacement(p, _torch_cam(c1))
    (ours * torch.from_numpy(g)).sum().backward()

    def f(x):
        return jgeo.project_displacement(x, _jax_cam(c1))

    ref, vjp = jax.vjp(f, jnp.asarray(pts))
    _close(ours, ref)
    assert float(ours[0, 0, 0].detach().abs().max()) == 0.0
    _grad_close(p.grad, vjp(jnp.asarray(g))[0])


def test_flow_by_depth_matches_jax(rng):
    """Values and the depths' gradients; the warp of the frame-2 world
    points is kernel A's wrapper at 3 channels (its plain version here)."""
    d1, d2, flow, _, c1, c2 = _inputs(rng)
    keys = ("dflow_1_2", "sf_by_depth", "warped_global_p2", "global_p1")
    wts = {k: _weights(rng, (B, H, W, 2 if k == "dflow_1_2" else 3))
           for k in keys}
    t1, t2 = (torch.from_numpy(d).requires_grad_() for d in (d1, d2))
    ours = geometry.flow_by_depth(t1, t2, torch.from_numpy(flow),
                                  _torch_cam(c1), _torch_cam(c2))
    _torch_loss(ours, wts).backward()

    def f(a, b):
        return jgeo.flow_by_depth(a, b, jnp.asarray(flow), _jax_cam(c1),
                                  _jax_cam(c2))

    ref = f(jnp.asarray(d1), jnp.asarray(d2))
    assert set(ours) == set(ref) == set(keys)
    for k in keys:
        _close(ours[k], ref[k])
    g1, g2 = jax.grad(lambda a, b: _jax_loss(f(a, b), wts), argnums=(0, 1))(
        jnp.asarray(d1), jnp.asarray(d2))
    _grad_close(t1.grad, g1)
    _grad_close(t2.grad, g2)


def test_scene_flow_projection_matches_jax(rng):
    """Values and the gradients of both depths and the scene flow; the warp
    of ``[p2_camera_2, depth_2]`` is kernel A's wrapper at 4 channels."""
    d1, d2, flow, sf, c1, c2 = _inputs(rng)
    torch_in = [torch.from_numpy(x).requires_grad_() for x in (d1, d2, sf)]
    ours = geometry.scene_flow_projection(
        torch_in[0], torch_in[1], torch.from_numpy(flow), _torch_cam(c1),
        _torch_cam(c2), torch_in[2])

    def f(a, b, s):
        return jgeo.scene_flow_projection(a, b, jnp.asarray(flow),
                                          _jax_cam(c1), _jax_cam(c2), s)

    jax_in = [jnp.asarray(x) for x in (d1, d2, sf)]
    ref = f(*jax_in)
    assert set(ours) == set(ref)
    wts = {k: _weights(rng, tuple(ref[k].shape)) for k in sorted(ref)}
    _torch_loss(ours, wts).backward()
    for k in ref:
        _close(ours[k], ref[k])
    grads = jax.grad(lambda *a: _jax_loss(f(*a), wts), argnums=(0, 1, 2))(
        *jax_in)
    for t, g in zip(torch_in, grads):
        _grad_close(t.grad, g)


def test_rigidity_loss_matches_jax(rng):
    pts = rng.randn(B, H, W, 3).astype(np.float32)
    sf = (0.1 * rng.randn(B, H, W, 3)).astype(np.float32)
    depth = (2.0 + rng.rand(B, H, W)).astype(np.float32)
    torch_in = [torch.from_numpy(x).requires_grad_() for x in (pts, sf,
                                                                depth)]
    total, terms = geometry.rigidity_loss(*torch_in, s=2.0)
    ref_total, ref_terms = jgeo.rigidity_loss(
        *(jnp.asarray(x) for x in (pts, sf, depth)), s=2.0)
    assert total.shape == (B, H - 2, W - 2)
    assert set(terms) == set(ref_terms)
    _close(total, ref_total)
    for k in ref_terms:
        _close(terms[k], ref_terms[k])
    g = _weights(rng, (B, H - 2, W - 2))
    (total * torch.from_numpy(g)).sum().backward()
    grads = jax.grad(
        lambda *a: jnp.sum(jgeo.rigidity_loss(*a, s=2.0)[0] * jnp.asarray(g)),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (pts, sf, depth)))
    for t, ref_g in zip(torch_in, grads):
        _grad_close(t.grad, ref_g)


def test_packed_from_camera_round_trip_and_jax(rng):
    """``packed_from_camera`` inverts ``camera_from_packed`` bit for bit and
    gives the JAX function's arrays, ``R_T`` included."""
    packed = [rng.randn(B, 1, 1, 3, 3).astype(np.float32),
              rng.randn(B, 1, 1, 1, 3).astype(np.float32),
              rng.randn(B, 1, 1, 3, 3).astype(np.float32),
              rng.randn(B, 1, 1, 3, 3).astype(np.float32)]
    cam = camera.camera_from_packed(*(torch.from_numpy(x) for x in packed))
    R, R_T, t, K, K_inv = camera.packed_from_camera(cam)
    for a, b in zip((R, t, K, K_inv), packed):
        np.testing.assert_array_equal(a.numpy(), b)
    back = camera.camera_from_packed(R, t, K, K_inv)
    for a, b in zip(back, cam):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = jcam.packed_from_camera(jcam.camera_from_packed(*packed))
    for a, b in zip((R, R_T, t, K, K_inv), ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fused_stages_equal_the_unfused_functions(rng):
    """The port's ``depth_warp_stage`` + ``projection_stage`` (one 4-channel
    warp) against its ``flow_by_depth`` + ``scene_flow_projection``
    (warp(R p + t) = R warp(p) + t): values, and the depths' gradients."""
    d1, d2, flow, sf, c1, c2 = _inputs(rng)
    cam_1, cam_2, fl, s = (_torch_cam(c1), _torch_cam(c2),
                           torch.from_numpy(flow), torch.from_numpy(sf))

    def unfused(a, b):
        fbd = geometry.flow_by_depth(a, b, fl, cam_1, cam_2)
        pr = geometry.scene_flow_projection(a, b, fl, cam_1, cam_2, s)
        return fbd, pr

    def fused(a, b):
        st = geometry.depth_warp_stage(a, b, fl, cam_1, cam_2)
        return st, geometry.projection_stage(a, b, cam_2, s, st)

    def loss(first, pr):
        return (first["sf_by_depth"].abs().sum() + pr["dflow_1_2"].abs().sum()
                + pr["depth_warp_1_2"].abs().sum())

    grads = []
    outs = []
    for fn in (unfused, fused):
        a, b = (torch.from_numpy(d).requires_grad_() for d in (d1, d2))
        first, pr = fn(a, b)
        loss(first, pr).backward()
        outs.append((first, pr))
        grads.append((a.grad, b.grad))
    (fbd, old), (stage, new) = outs
    for k in ("global_p1", "sf_by_depth"):
        np.testing.assert_allclose(stage[k].detach().numpy(),
                                   fbd[k].detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert set(new) == set(old)
    for k in old:
        np.testing.assert_allclose(new[k].detach().numpy(),
                                   old[k].detach().numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for g_new, g_old in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g_new.numpy(), g_old.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_unfused_warps_go_through_kernel_a_wrapper(rng, monkeypatch):
    """``flow_by_depth`` warps 3 channels and ``scene_flow_projection`` 4,
    both through ``warp_kernel.backward_warp`` (on the card: kernel A at
    C=3 and C=4)."""
    channels = []
    real = warp_kernel.backward_warp

    def spy(src, flow):
        channels.append(src.shape[-1])
        return real(src, flow)

    monkeypatch.setattr(geometry, "backward_warp", spy)
    d1, d2, flow, sf, c1, c2 = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                                else x for x in _inputs(rng))
    geometry.flow_by_depth(d1, d2, flow, _torch_cam(c1), _torch_cam(c2))
    geometry.scene_flow_projection(d1, d2, flow, _torch_cam(c1),
                                   _torch_cam(c2), sf)
    assert channels == [3, 4]


@pytest.mark.parametrize("cin,features", [(8, 8), (5, 8)])
def test_res_conv_block_matches_jax(rng, cin, features):
    """With the identity skip (equal widths) and with the learned 1x1 skip
    (padding 0 while the convs pad 1), weights carried by state dict;
    relative 1e-5."""
    net = jblocks.ResConv2DBlock(features=features, kernel_size=3, padding=1,
                                 activation="lrelu")
    x = rng.randn(2, 9, 11, cin).astype(np.float32)
    variables = jax.tree.map(
        lambda v: np.asarray(v, np.float32),
        dict(net.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    variables = jax.tree.map(
        lambda v: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32),
        variables)
    port = ResConv2DBlock(cin, features, 3, padding=1, activation="lrelu")
    weights.load_flax(port, variables)
    assert (port.skip is not None) == (cin != features)
    ref = np.asarray(net.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (2, 9, 11, features)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_get_model_resolves_the_net_alias():
    from dynamic_video_depth_tpu_torch.train import scene_flow_motion_field

    assert models.get_model("scene_flow_motion_field") is \
        scene_flow_motion_field.Model
    with pytest.raises(ModuleNotFoundError):
        models.get_model("no_such_net")
