// Fused scene-flow projection and consistency-loss sums, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dynamic_video_depth_tpu/ops/pallas/
// loss_kernel.py::fused_projection_loss (forward, _fwd_kernel) and
// _loss_bwd (_bwd_kernel). Per pixel (_pixel_chain): advect the frame-1
// world point by the scene flow, rotate it into camera 2 and project it
// with the z >= 1e-3 guard; form the flow residual (squared during
// warm-up, absolute after), the disparity residual and the scene-flow
// residual; weight all three by the occlusion mask (times the two MiDaS
// far-field masks d1 < 100 and warped z < 100 when `midas`). The forward
// returns the four sums [flow, disp, sf, occ_mass] over the batch; the
// backward takes their cotangent (occ_mass has none) and writes the
// gradients at global_p1, the warped camera-2 points and the scene flow.
//
// Design. One thread per pixel; a block covers 256 pixels of one batch row
// (blockIdx.y = batch), so the packed camera row (R_c2w 9, t 3, K 9) is
// loaded once per block into shared memory. The whole chain stays in
// registers; the TPU version's 8-row x 128-lane padding is gone. The
// forward reduces each block's four sums in a fixed tree order to one
// partial per block, and a second kernel adds the partials in a fixed
// order: no atomics, so the sums are deterministic. The backward recomputes
// the chain (cheaper than storing it) and writes three [B,H,W,3] fields.
//
// This file is built with --fmad=false, so every product and sum rounds on
// its own, in the order of the plain version (ops/cuda/loss_kernel.py::
// projection_loss_plain); per pixel the two agree bit for bit and only the
// order of the global sums differs.
//
// Traps the semantics pin: sign(0) = 0 (not copysign); dead pixels
// (z < 1e-3) take inv_z = 0, never 1/(z + 1e-8); the clamp's gradient
// passes only where c > 1e-3 (strict).
//
// What bounds it on the H100: memory. The forward reads 15 floats per
// pixel (60 B; 5.2 MB at 224x384), the backward 15 and writes 9 (8.3 MB):
// a few microseconds at 3.35 TB/s, so launch overhead dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEpsProj = 1e-8f;
constexpr float kZDegenerate = 1e-3f;
constexpr float kClipMin = 1e-3f;
constexpr float kMidasFar = 100.0f;

enum Flag { kMidas = 1, kUseDisp = 2, kUseDispRatio = 4, kWarm = 8 };

struct Inputs {
  const float* gp1;   // [B,H,W,3]
  const float* w3;    // [B,H,W,3]
  const float* sf;    // [B,H,W,3]
  const float* flow;  // [B,H,W,2]
  const float* mask;  // [B,H,W]
  const float* d1;    // [B,H,W]
  const float* cam;   // [B,24]
};

__device__ __forceinline__ float sgn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// Per-pixel values of _pixel_chain, in its order of operations.
struct Pixel {
  float occ, q[3], img[3], inv_z, live, rx, ry, c1, c2;
};

__device__ __forceinline__ void load_camera(const float* cam, int b,
                                            float* C) {
  if (threadIdx.x < 24) C[threadIdx.x] = cam[24 * b + threadIdx.x];
  __syncthreads();
}

__device__ __forceinline__ Pixel pixel_chain(const float* C, const Inputs& in,
                                             int64_t pix, float bx, float by,
                                             int flags, float g[3],
                                             float w[3], float s[3]) {
  const float* R = C;       // R[3 i + j]
  const float* t = C + 9;
  const float* K = C + 12;  // K[3 i + j]
  for (int i = 0; i < 3; ++i) {
    g[i] = in.gp1[3 * pix + i];
    w[i] = in.w3[3 * pix + i];
    s[i] = in.sf[3 * pix + i];
  }
  Pixel v;
  v.occ = in.mask[pix];
  if (flags & kMidas) {
    v.occ = v.occ * (in.d1[pix] < kMidasFar ? 1.0f : 0.0f);
    v.occ = v.occ * (w[2] < kMidasFar ? 1.0f : 0.0f);
  }
  float rel[3], p1c2[3];
  for (int i = 0; i < 3; ++i) {
    const float wg = R[3 * i] * w[0] + R[3 * i + 1] * w[1] +
                     R[3 * i + 2] * w[2] + t[i];
    v.q[i] = wg - g[i] - s[i];
    rel[i] = g[i] + s[i] - t[i];
  }
  for (int i = 0; i < 3; ++i)
    p1c2[i] = R[i] * rel[0] + R[3 + i] * rel[1] + R[6 + i] * rel[2];
  for (int i = 0; i < 3; ++i)
    v.img[i] = K[3 * i] * p1c2[0] + K[3 * i + 1] * p1c2[1] +
               K[3 * i + 2] * p1c2[2];
  const float z = v.img[2];
  v.live = z >= kZDegenerate ? 1.0f : 0.0f;
  v.inv_z = v.live > 0.0f ? 1.0f / (z + kEpsProj) : 0.0f;
  const float pix_x = v.img[0] * v.inv_z;
  const float pix_y = v.img[1] * v.inv_z;
  v.rx = (pix_x - bx) * v.live - in.flow[2 * pix];
  v.ry = (pix_y - by) * v.live - in.flow[2 * pix + 1];
  v.c1 = p1c2[2];
  v.c2 = w[2];
  return v;
}

// Which pixel this thread owns: (batch, flat index, x, y); false past H*W.
__device__ __forceinline__ bool locate(int HW, int W, int* b, int64_t* pix,
                                       float* bx, float* by) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  *b = blockIdx.y;
  if (r >= HW) return false;
  *pix = (int64_t)(*b) * HW + r;
  const int y = r / W;
  *bx = (float)(r - y * W);
  *by = (float)y;
  return true;
}

// Fixed-order block sum of v[0..3] (warp shuffle tree, then warp 0 over the
// warp sums); thread 0 gets the result.
__device__ __forceinline__ void block_sum4(float v[4], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
  if (lane == 0)
    for (int c = 0; c < 4; ++c) red[4 * warp + c] = v[c];
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kThreads / 32;
    for (int c = 0; c < 4; ++c) v[c] = lane < kWarps ? red[4 * lane + c] : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
  }
}

__global__ void __launch_bounds__(kThreads)
    loss_fwd(Inputs in, int HW, int W, int flags, float* __restrict__ part) {
  __shared__ float C[24];
  __shared__ float red[4 * kThreads / 32];
  int b;
  int64_t pix;
  float bx, by;
  load_camera(in.cam, blockIdx.y, C);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (locate(HW, W, &b, &pix, &bx, &by)) {
    float g[3], w[3], s[3];
    const Pixel p = pixel_chain(C, in, pix, bx, by, flags, g, w, s);
    float flow_r, disp_r;
    if (flags & kWarm)
      flow_r = p.rx * p.rx + p.ry * p.ry;
    else
      flow_r = fabsf(p.rx) + fabsf(p.ry);
    if (flags & (kUseDisp | kUseDispRatio)) {
      const float t1 = fmaxf(p.c1, kClipMin), t2 = fmaxf(p.c2, kClipMin);
      disp_r = (flags & kUseDisp)
                   ? 100.0f * fabsf(1.0f / t1 - 1.0f / t2)
                   : fmaxf(t1, t2) / fminf(t1, t2) - 1.0f;
    } else {
      disp_r = fabsf(p.c1 - p.c2);
    }
    const float sf_r = fabsf(p.q[0]) + fabsf(p.q[1]) + fabsf(p.q[2]);
    v[0] = p.occ * flow_r;
    v[1] = p.occ * disp_r;
    v[2] = p.occ * sf_r;
    v[3] = p.occ;
  }
  block_sum4(v, red);
  if (threadIdx.x == 0) {
    float* o = part + 4 * ((int64_t)blockIdx.y * gridDim.x + blockIdx.x);
    for (int c = 0; c < 4; ++c) o[c] = v[c];
  }
}

// out[c] = sum over the n partials, in a fixed order (one block).
__global__ void __launch_bounds__(kThreads)
    loss_reduce(const float* __restrict__ part, int n,
                float* __restrict__ out) {
  __shared__ float red[4 * kThreads / 32];
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads)
    for (int c = 0; c < 4; ++c) v[c] += part[4 * (int64_t)i + c];
  block_sum4(v, red);
  if (threadIdx.x == 0)
    for (int c = 0; c < 4; ++c) out[c] = v[c];
}

__global__ void __launch_bounds__(kThreads)
    loss_bwd(Inputs in, int HW, int W, int flags,
             const float* __restrict__ cot, float* __restrict__ dgp1,
             float* __restrict__ dw3, float* __restrict__ dsf) {
  __shared__ float C[24];
  int b;
  int64_t pix;
  float bx, by;
  load_camera(in.cam, blockIdx.y, C);
  if (!locate(HW, W, &b, &pix, &bx, &by)) return;
  const float* R = C;
  const float* K = C + 12;
  const float a = cot[0], bb = cot[1], c = cot[2];  // occ_mass: no gradient
  float g[3], w[3], s[3];
  const Pixel v = pixel_chain(C, in, pix, bx, by, flags, g, w, s);
  const float occ = v.occ;

  // scene-flow residual: resid = sum_i |q_i|, q = R w3 + t - gp1 - sf
  float gq[3], dw[3], dg[3], ds[3];
  for (int i = 0; i < 3; ++i) gq[i] = c * occ * sgn(v.q[i]);
  for (int j = 0; j < 3; ++j)
    dw[j] = R[j] * gq[0] + R[3 + j] * gq[1] + R[6 + j] * gq[2];
  for (int i = 0; i < 3; ++i) {
    dg[i] = -gq[i];
    ds[i] = -gq[i];
  }

  // flow residual
  float grx, gry;
  if (flags & kWarm) {
    grx = a * occ * 2.0f * v.rx;
    gry = a * occ * 2.0f * v.ry;
  } else {
    grx = a * occ * sgn(v.rx);
    gry = a * occ * sgn(v.ry);
  }
  const float gpx = grx * v.live, gpy = gry * v.live;
  float dimg[3];
  dimg[0] = gpx * v.inv_z;
  dimg[1] = gpy * v.inv_z;
  dimg[2] = -(gpx * v.img[0] + gpy * v.img[1]) * v.inv_z * v.inv_z;

  // disparity residual -> d c1 (p1c2 z), d c2 (warped z)
  float dc1, dc2;
  if (flags & (kUseDisp | kUseDispRatio)) {
    const float t1 = fmaxf(v.c1, kClipMin), t2 = fmaxf(v.c2, kClipMin);
    const float pass1 = v.c1 > kClipMin ? 1.0f : 0.0f;
    const float pass2 = v.c2 > kClipMin ? 1.0f : 0.0f;
    if (flags & kUseDisp) {
      const float sd = sgn(1.0f / t1 - 1.0f / t2);
      dc1 = bb * occ * 100.0f * sd * (-1.0f / (t1 * t1)) * pass1;
      dc2 = bb * occ * 100.0f * sd * (1.0f / (t2 * t2)) * pass2;
    } else {
      const float hi = fmaxf(t1, t2), lo = fminf(t1, t2);
      const float dhi = bb * occ / lo;
      const float dlo = -bb * occ * hi / (lo * lo);
      const float one_is_hi = t1 >= t2 ? 1.0f : 0.0f;
      dc1 = (one_is_hi * dhi + (1.0f - one_is_hi) * dlo) * pass1;
      dc2 = ((1.0f - one_is_hi) * dhi + one_is_hi * dlo) * pass2;
    }
  } else {
    const float sd = sgn(v.c1 - v.c2);
    dc1 = bb * occ * sd;
    dc2 = -bb * occ * sd;
  }
  dw[2] = dw[2] + dc2;

  // img = K p1c2 -> d p1c2_j = sum_i K[i][j] dimg_i, plus dc1 on z
  float dp[3];
  for (int j = 0; j < 3; ++j)
    dp[j] = K[j] * dimg[0] + K[3 + j] * dimg[1] + K[6 + j] * dimg[2];
  dp[2] = dp[2] + dc1;
  // p1c2 = R^T (gp1 + sf - t) -> d rel = R dp
  for (int i = 0; i < 3; ++i) {
    const float dadv = R[3 * i] * dp[0] + R[3 * i + 1] * dp[1] +
                       R[3 * i + 2] * dp[2];
    dg[i] = dg[i] + dadv;
    ds[i] = ds[i] + dadv;
  }
  for (int i = 0; i < 3; ++i) {
    dgp1[3 * pix + i] = dg[i];
    dw3[3 * pix + i] = dw[i];
    dsf[3 * pix + i] = ds[i];
  }
}

Inputs make_inputs(const float* gp1, const float* w3, const float* sf,
                   const float* flow, const float* mask, const float* d1,
                   const float* cam) {
  Inputs in;
  in.gp1 = gp1;
  in.w3 = w3;
  in.sf = sf;
  in.flow = flow;
  in.mask = mask;
  in.d1 = d1;
  in.cam = cam;
  return in;
}

inline unsigned row_blocks(int HW) {
  return (unsigned)((HW + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Number of per-block partials the forward writes for B x HW pixels (the
// size of its scratch, in units of 4 floats).
int dvd_loss_partials(int B, int HW) { return B * (int)row_blocks(HW); }

// out[4] = [flow_sum, disp_sum, sf_sum, occ_mass]; part is scratch of
// 4 * dvd_loss_partials(B, H*W) floats.
int dvd_loss_fwd(const float* gp1, const float* w3, const float* sf,
                 const float* flow, const float* mask, const float* d1,
                 const float* cam, int B, int H, int W, int flags,
                 float* part, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HW = H * W;
  if (B < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(row_blocks(HW), B);
  loss_fwd<<<grid, kThreads, 0, st>>>(
      make_inputs(gp1, w3, sf, flow, mask, d1, cam), HW, W, flags, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  loss_reduce<<<1, kThreads, 0, st>>>(part, (int)(grid.x * grid.y), out);
  return (int)cudaGetLastError();
}

// Gradients at gp1, w3 and sf [B,H,W,3] of cot[0..2] . sums[0..2]; cot is
// the forward's cotangent [4] on the device.
int dvd_loss_bwd(const float* gp1, const float* w3, const float* sf,
                 const float* flow, const float* mask, const float* d1,
                 const float* cam, int B, int H, int W, int flags,
                 const float* cot, float* dgp1, float* dw3, float* dsf,
                 void* stream) {
  const int HW = H * W;
  if (B < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(row_blocks(HW), B);
  loss_bwd<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      make_inputs(gp1, w3, sf, flow, mask, d1, cam), HW, W, flags, cot, dgp1,
      dw3, dsf);
  return (int)cudaGetLastError();
}

}  // extern "C"
