"""The port's geometry against the JAX package's, on the same numpy
inputs: cameras, pixel grids, grid sampling and the two train-step stages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.ops import camera as jcam
from dynamic_video_depth_tpu.ops import coords as jcoords
from dynamic_video_depth_tpu.ops import geometry as jgeo
from dynamic_video_depth_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from dynamic_video_depth_tpu_torch.ops import camera, coords, geometry
from dynamic_video_depth_tpu_torch.ops.grid_sample import grid_sample
from torch_threads import one_torch_thread  # noqa: F401


def _rot(rng, b, angle=0.1):
    """Rotations by ``angle`` rad about random axes (Rodrigues), [b,3,3]."""
    out = []
    for _ in range(b):
        k = rng.randn(3)
        k /= np.linalg.norm(k)
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        out.append(np.eye(3) + np.sin(angle) * kx
                   + (1 - np.cos(angle)) * kx @ kx)
    return np.asarray(out, np.float32)


def _cameras(rng, b, h, w):
    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    cams = []
    for _ in range(2):
        cams.append(dict(R=_rot(rng, b),
                         t=(0.05 * rng.randn(b, 3)).astype(np.float32),
                         K=np.tile(K, (b, 1, 1)),
                         K_inv=np.tile(np.linalg.inv(K), (b, 1, 1)).astype(np.float32)))
    return cams


def _jax_cam(c):
    return jcam.Camera(jnp.asarray(c["R"]), jnp.asarray(c["t"]),
                       jnp.asarray(c["K"]), jnp.asarray(c["K_inv"]))


def _torch_cam(c):
    return camera.Camera(*(torch.from_numpy(c[k]) for k in ("R", "t", "K", "K_inv")))


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach") else a),
                               np.asarray(b), rtol=tol, atol=tol)


def test_camera_from_packed_and_coords(rng):
    packed = [rng.randn(2, 1, 1, 3, 3).astype(np.float32),
              rng.randn(2, 1, 1, 1, 3).astype(np.float32),
              rng.randn(2, 1, 1, 3, 3).astype(np.float32),
              rng.randn(2, 1, 1, 3, 3).astype(np.float32)]
    ours = camera.camera_from_packed(*(torch.from_numpy(x) for x in packed))
    ref = jcam.camera_from_packed(*packed)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(coords.pixel_coords_homogeneous(5, 7).numpy(),
                                  np.asarray(jcoords.pixel_coords_homogeneous(5, 7)))


def test_grid_sample_matches(rng):
    img = rng.randn(2, 9, 11, 3).astype(np.float32)
    pos = (rng.rand(2, 6, 5, 2) * [16, 14] - [3, 2]).astype(np.float32)
    ours = grid_sample(torch.from_numpy(img), torch.from_numpy(pos))
    _close(ours, jax_grid_sample(jnp.asarray(img), jnp.asarray(pos)))


@pytest.mark.parametrize("with_sf", [False, True])
def test_depth_warp_and_projection_stages(rng, with_sf):
    b, h, w = 2, 12, 16
    d1 = (2.0 + rng.rand(b, h, w)).astype(np.float32)
    d2 = (2.0 + rng.rand(b, h, w)).astype(np.float32)
    flow = (3.0 * rng.randn(b, h, w, 2)).astype(np.float32)
    sf = (0.05 * rng.randn(b, h, w, 3) * with_sf).astype(np.float32)
    c1, c2 = _cameras(rng, b, h, w)

    ref = jgeo.depth_warp_stage(jnp.asarray(d1), jnp.asarray(d2),
                                jnp.asarray(flow), _jax_cam(c1), _jax_cam(c2))
    ours = geometry.depth_warp_stage(torch.from_numpy(d1), torch.from_numpy(d2),
                                     torch.from_numpy(flow), _torch_cam(c1),
                                     _torch_cam(c2))
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k])

    ref_p = jgeo.projection_stage(jnp.asarray(d1), jnp.asarray(d2),
                                  _jax_cam(c2), jnp.asarray(sf), ref)
    ours_p = geometry.projection_stage(torch.from_numpy(d1),
                                       torch.from_numpy(d2), _torch_cam(c2),
                                       torch.from_numpy(sf), ours)
    assert set(ours_p) == set(ref_p)
    for k in ref_p:
        _close(ours_p[k], ref_p[k])


def test_unproject_project_round_trip(rng):
    b, h, w = 1, 8, 10
    d = (1.5 + rng.rand(b, h, w)).astype(np.float32)
    (c1, _) = _cameras(rng, b, h, w)
    world = geometry.unproject(torch.from_numpy(d), _torch_cam(c1))
    _close(world, jgeo.unproject(jnp.asarray(d), _jax_cam(c1)))
    pix, cam_pts = geometry.project(world, _torch_cam(c1))
    _close(pix, coords.pixel_coords(h, w)[None].expand(b, h, w, 2), 1e-3)
    _close(cam_pts[..., 2], d, 1e-5)
