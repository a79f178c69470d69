"""One step of the per-video optimization in plain PyTorch (the method of
Zhang et al., "Consistent Depth of Moving Objects in Video", SIGGRAPH 2021;
google/dynamic-video-depth ``models/scene_flow_motion_field.py``).

A step runs the depth net over both frames of each pair, unprojects them,
warps frame 2's camera points by the observed flow (``F.grid_sample`` with
aligned corners and border padding, the original's call), integrates the
scene-flow field over the gap by Euler steps (its first two evaluations feed
the acceleration regularizer), projects into camera 2, and takes the masked
flow and disparity losses (the MiDaS far-field masks where the
configuration says so) plus the regularizer; one backward pass; then Adam on
the two parameter groups, the depth net at ``lr`` and the field at
``lr * scene_lr_mul``. The field's Euler chain runs in chunks of points under
``torch.utils.checkpoint``, so that gap 8 at batch 8 fits on the card.

``precision`` says how the depth net computes: ``float32`` (TF32 off
everywhere), ``tf32`` (TF32 on in convolutions and matrix products, the
control of a float32 cell), ``bfloat16`` (the net's parameters, buffers and
input cast to bfloat16, the output back to float32) and ``fp8`` (bfloat16
with every convolution's input and weight rounded to float8 e4m3 under a
per-tensor scale, the control of a bfloat16 cell). ``fault='half_batch'``
computes each step on the first half of the batch only, the mean taken over
it: a planted fault that the comparison has to catch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..track import pair_path

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")
CHAIN_CHUNK = 65536
MIDAS_FAR = 100.0
FP8_MAX = 448.0


def load_batch(root: str, track: str, gap: int, firsts: Sequence[int],
               n_frames: int, device) -> Dict[str, torch.Tensor]:
    """The pairs ``(i, i + gap)`` for ``i`` in ``firsts`` from the track's
    packed files, stacked along the batch, as plain column-vector cameras
    (the files hold transposed matrices)."""
    raws = [torch.load(pair_path(root, track, gap, i), map_location="cpu",
                       weights_only=True) for i in firsts]

    def cat(key):
        return torch.cat([r[key] for r in raws]).float()

    def mat(key):  # [B,1,1,3,3] transposed -> [B,3,3]
        return cat(key).reshape(-1, 3, 3).transpose(-1, -2)

    img_1 = cat("img_1")
    b, h, w, _ = img_1.shape
    fid_1 = cat("fid_1").reshape(b)
    fid_2 = cat("fid_2").reshape(b)
    if not torch.equal(fid_2 - fid_1, torch.full_like(fid_1, float(gap))):
        raise ValueError(f"pair files of gap {gap} hold frames "
                         f"{fid_1.tolist()} -> {fid_2.tolist()}")
    batch = {
        "img_1": img_1, "img_2": cat("img_2"), "flow": cat("flow_1_2"),
        "mask_2": cat("mask_2").reshape(b, h, w),
        "R_1": mat("R_1"), "R_2": mat("R_2"), "K": mat("K"),
        "K_inv": mat("K_inv"),
        "t_1": cat("t_1").reshape(b, 3), "t_2": cat("t_2").reshape(b, 3),
        "ts_1": (fid_1 / n_frames)[:, None, None, None].expand(
            b, h, w, 1).contiguous(),
        "dt": torch.tensor(1.0 / n_frames),
    }
    return {k: v.to(device) for k, v in batch.items()}


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, gradients
    passed straight through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def frequencies(n: int, device) -> torch.Tensor:
    """``linspace(1, n + 1, n)``, each value rounded once to float32."""
    return torch.tensor(np.linspace(1.0, n + 1.0, n), dtype=torch.float32,
                        device=device)


def embed(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """``[x, cos(f_1 x) .. cos(f_n x), sin(f_1 x) .. sin(f_n x)]``, each
    block frequency-major."""
    ang = (x[..., None, :] * freqs[:, None]).flatten(-2)
    return torch.cat([x, torch.cos(ang), torch.sin(ang)], dim=-1)


def field(pts, ts, weights, biases, fx, ft, slope):
    x = torch.cat([embed(ts, ft), embed(pts, fx)], dim=-1)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = F.linear(x, w, b)
        if i + 1 < len(weights):
            x = F.leaky_relu(x, slope)
    return x


def unproject(depth, K_inv, pix):
    return depth[..., None] * torch.einsum("bij,hwj->bhwi", K_inv, pix)


def rotate(R, pts):
    return torch.einsum("bij,bhwj->bhwi", R, pts)


def project(points, R, t, K, base):
    """World points -> (pixel, camera-2 points); points at z < 1e-3 keep
    their own pixel."""
    cam = torch.einsum("bji,bhwj->bhwi", R, points - t[:, None, None, :])
    img = torch.einsum("bij,bhwj->bhwi", K, cam)
    z = img[..., 2:3]
    pix = img[..., :2] / (z + 1e-8)
    return torch.where(z < 1e-3, base[None], pix), cam


def warp(src, flow):
    """``src [B,H,W,C]`` sampled at pixel + flow, bilinear, border."""
    _, h, w, _ = src.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=src.device,
                                         dtype=src.dtype),
                            torch.arange(w, device=src.device,
                                         dtype=src.dtype), indexing="ij")
    gx = (xs + flow[..., 0]) * (2.0 / (w - 1)) - 1.0
    gy = (ys + flow[..., 1]) * (2.0 / (h - 1)) - 1.0
    out = F.grid_sample(src.permute(0, 3, 1, 2), torch.stack([gx, gy], -1),
                        mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


class ReferenceStep:
    """Both nets' float32 parameters (``depth.<key>``, ``field.<key>``),
    their Adam state, and ``step(batch, gap)``."""

    def __init__(self, depth_net: torch.nn.Module, weights: Dict[str,
                 torch.Tensor], config: dict, traffic: dict, device,
                 precision: str = "float32", fault: Optional[str] = None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.net = depth_net.to(device).eval()
        self.cfg, self.traffic = config, traffic
        self.precision, self.fault = precision, fault
        self.device = torch.device(device)
        self.params = {k: v.detach().to(device, torch.float32).clone()
                       .requires_grad_(True) for k, v in weights.items()
                       if not k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked"))}
        self.buffers = {k[len("depth."):]: v.to(device)
                        for k, v in weights.items() if k not in self.params}
        for k, v in self.net.named_buffers():
            self.buffers.setdefault(k, v)
        fcfg = config["field"]
        n_lin = fcfg["n_layers"] + 2
        self.field_w = [self.params[f"field.convs.{i}.conv.weight"]
                        for i in range(n_lin)]
        self.field_b = [self.params[f"field.convs.{i}.conv.bias"]
                        for i in range(n_lin)]
        self.fx = frequencies(fcfg["n_freq_xyz"], self.device)
        self.ft = frequencies(fcfg["n_freq_t"], self.device)
        rec = self.recipe = traffic["recipe"]
        if not rec["time_dependent"] or rec["optim"] != "adam":
            raise ValueError("the reference follows a time-dependent field "
                             "under Adam")
        self.betas = (rec["adam_beta1"], rec["adam_beta2"])
        self.eps = rec["adam_eps"]
        self.lr = {k: rec["lr"] * (rec["scene_lr_mul"]
                                   if k.startswith("field.") else 1.0)
                   for k in self.params}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self._hooks = []
        if precision == "fp8":
            for mod in self.net.modules():
                if isinstance(mod, torch.nn.Conv2d):
                    self._hooks.append(mod.register_forward_pre_hook(
                        lambda m, args: (fp8_round(args[0]),)))

    # ---------------------------------------------------------------- parts

    def depth(self, img):
        tensors = {k[len("depth."):]: v for k, v in self.params.items()
                   if k.startswith("depth.")}
        tensors.update(self.buffers)
        if self.precision in ("float32", "tf32"):
            return functional_call(self.net, tensors, (img,))
        cast = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in tensors.items()}
        if self.precision == "fp8":
            cast = {k: fp8_round(v) if v.dim() == 4 else v
                    for k, v in cast.items()}
        return functional_call(self.net, cast,
                               (img.to(torch.bfloat16),)).float()

    def _chain_chunk(self, p, t, dt, gap: int, n_evals: int):
        div = self.recipe["sf_mag_div"]
        slope = self.cfg["field"]["leaky_slope"]
        acc, evals = torch.zeros_like(p), []
        for k in range(n_evals):
            sf = field(p, t, self.field_w, self.field_b, self.fx, self.ft,
                       slope) / div
            if k < 2:
                evals.append(sf)
            if k < gap:
                acc = acc + sf
            if k + 1 < n_evals:
                p, t = p + sf, t + dt
        return acc, evals[0], evals[1]

    def chain(self, pts, ts, dt, gap: int):
        """(sum of the first ``gap`` evaluations, first, second) over
        ``max(2, gap)`` Euler evaluations."""
        shape = pts.shape
        p, t = pts.reshape(-1, 3), ts.reshape(-1, 1)
        outs = [checkpoint(self._chain_chunk, p[i:i + CHAIN_CHUNK],
                           t[i:i + CHAIN_CHUNK], dt, gap, max(2, gap),
                           use_reentrant=False)
                for i in range(0, p.shape[0], CHAIN_CHUNK)]
        return tuple(torch.cat(o).reshape(shape) for o in zip(*outs))

    def loss(self, batch, gap: int) -> torch.Tensor:
        rec = self.recipe
        if self.fault == "half_batch":
            half = max(batch["img_1"].shape[0] // 2, 1)
            batch = {k: v[:half] if v.dim() else v for k, v in batch.items()}
        b, h, w, _ = batch["img_1"].shape
        depths = self.depth(torch.cat([batch["img_1"], batch["img_2"]]))
        d1, d2 = depths[:b], depths[b:]
        ys, xs = torch.meshgrid(torch.arange(h, device=d1.device,
                                             dtype=d1.dtype),
                                torch.arange(w, device=d1.device,
                                             dtype=d1.dtype), indexing="ij")
        base = torch.stack([xs, ys], -1)
        pix = torch.cat([base, torch.ones_like(xs)[..., None]], -1)
        g1 = (rotate(batch["R_1"], unproject(d1, batch["K_inv"], pix))
              + batch["t_1"][:, None, None, :])
        warped = warp(unproject(d2, batch["K_inv"], pix), batch["flow"])
        sf, first, second = self.chain(g1, batch["ts_1"], batch["dt"], gap)
        pix12, p1c2 = project(g1 + sf, batch["R_2"], batch["t_2"],
                              batch["K"], base)
        occ = batch["mask_2"][..., None]
        if self.cfg["midas_masks"]:
            occ = occ * (d1.detach()[..., None] < MIDAS_FAR).float()
            occ = occ * (warped[..., 2:3] < MIDAS_FAR).float()
        mass = occ.sum() + 1e-8
        flow_loss = (occ * (pix12 - base - batch["flow"]).abs()).sum() / mass
        if rec["use_disp"]:
            resid = 100.0 * (1.0 / p1c2[..., 2:3].clamp(min=1e-3)
                             - 1.0 / warped[..., 2:3].clamp(min=1e-3)).abs()
        else:  # the scene flow against the flow-implied one
            resid = (rotate(batch["R_2"], warped) - g1 - sf
                     + batch["t_2"][:, None, None, :]).abs()
        second_loss = (occ * resid).sum() / mass
        reg = rec["acc_mul"] * (second - first).abs().mean()
        return (flow_loss * rec["flow_mul"] + second_loss * rec["disp_mul"]
                + reg)

    # ----------------------------------------------------------------- step

    def step(self, batch, gap: int):
        """One step: (loss, the gradients by leaf)."""
        with tf32(self.precision == "tf32"):
            for p in self.params.values():
                p.grad = None
            total = self.loss(batch, gap)
            total.backward()
        grads = {k: p.grad.detach() for k, p in self.params.items()}
        self.t += 1
        b1, b2 = self.betas
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)
                         ).add_(self.eps)
                p.addcdiv_(self.m[k], denom,
                           value=-self.lr[k] / (1 - b1 ** self.t))
        return float(total.detach()), grads

    def close(self):
        for h in self._hooks:
            h.remove()


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def follow(ref: ReferenceStep, batches: List[tuple], initial: Dict[str,
           torch.Tensor], change_after: int):
    """Run the steps ``[(gap, batch), ...]`` from the initial weights:
    (losses, first gradient's leaf norms, leaf norms of the parameters'
    change after ``change_after`` steps)."""
    losses, first, change = [], None, None
    for gap, batch in batches:
        loss, grads = ref.step(batch, gap)
        losses.append(loss)
        if first is None:
            first = leaf_norms(grads)
        del grads
        if len(losses) == change_after:
            change = {k: float(torch.linalg.vector_norm(
                p.detach().double() - initial[k].to(p.device).double()))
                for k, p in ref.params.items()}
    return losses, first, change
