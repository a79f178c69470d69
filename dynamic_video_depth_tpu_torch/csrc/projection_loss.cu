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
// What bounds it on the H100: memory. The forward reads 13 floats a pixel
// (global_p1 3, warped points 3, scene flow 3, flow 2, mask 1, depth 1:
// 52 B, 4.5 MB at 224x384) and writes 4 sums; the backward reads the same
// 13 and writes 9 (22 floats, 88 B, 7.6 MB). At 3.35 TB/s that is 1.3 and
// 2.3 microseconds, the order of one launch, so the design moves each byte
// once in wide accesses and launches once per direction.
//
// Design. A thread owns one pixel and a block 256 consecutive pixels of a
// batch row (blockIdx.y = batch): 336 blocks at 224x384, 2.5 per SM of
// 132. Many warps in flight hide the chain's latency: on the card, 4
// pixels a thread in float4s (a quarter of the warps) was slower, and so
// was staging each warp's 32 pixels through shared memory to make every
// global access 16 bytes. These 4-byte accesses are coalesced across the
// warp all the same (the 12-byte pixels of neighbouring lanes fill whole
// lines) when each field's floats are read and written back to back. So
// every shape and every alignment takes the same path, the ragged tail
// masked. The camera row
// (R_c2w 9, t 3, K 9) and the cotangent are read into registers by
// uniform loads before the fields, with no shared memory and no barrier.
// The forward sums in one launch: each block reduces its pixels in a fixed
// order (a shuffle tree, then the warps in order) to one partial, writes
// it, fences, and takes a ticket; the last block to arrive adds every
// partial in index order and puts the ticket counter back to 0. No float
// atomics: the sums are bit-identical from run to run. The counter and the
// partials live in a workspace the wrapper keeps per device and stream;
// the kernels allocate nothing. The backward recomputes the chain (cheaper
// than storing it).
//
// This file is built with --fmad=false, so every product and sum rounds on
// its own, in the order of the plain version (ops/cuda/loss_kernel.py::
// projection_loss_plain); per pixel the two agree bit for bit and only the
// order of the global sums differs.
//
// Traps the semantics pin: sign(0) = 0 (not copysign); dead pixels
// (z < 1e-3) take inv_z = 0, never 1/(z + 1e-8); the clamp's gradient
// passes only where c > 1e-3 (strict).

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

struct Camera {
  float R[9], t[3], K[9];  // R[3 i + j], K[3 i + j]
};

// One pixel's fields.
struct Fields {
  float g[3], w[3], s[3], f[2], m, d;
};

__device__ __forceinline__ float sgn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ Camera load_camera(const float* cam, int b) {
  const float* row = cam + 24 * b;
  Camera c;
#pragma unroll
  for (int i = 0; i < 9; ++i) c.R[i] = __ldg(row + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) c.t[i] = __ldg(row + 9 + i);
#pragma unroll
  for (int i = 0; i < 9; ++i) c.K[i] = __ldg(row + 12 + i);
  return c;
}

// This thread's pixel: its index r in the batch row, its flat index q, and
// whether it lies in the row.
struct Where {
  int r;
  int64_t q;
  bool valid;

  __device__ __forceinline__ explicit Where(int HW) {
    r = blockIdx.x * kThreads + threadIdx.x;
    q = (int64_t)blockIdx.y * HW + r;
    valid = r < HW;
  }
};

// n floats of the pixel from src into dst, zeros past the row (predicated
// loads, no branch).
template <int n>
__device__ __forceinline__ void load_field(const float* src, const Where& at,
                                           float* dst) {
#pragma unroll
  for (int i = 0; i < n; ++i)
    dst[i] = at.valid ? __ldg(src + n * at.q + i) : 0.0f;
}

// The pixel's fields, field after field.
__device__ __forceinline__ Fields load_pixel(const Inputs& in,
                                             const Where& at, int flags) {
  Fields F;
  load_field<3>(in.gp1, at, F.g);
  load_field<3>(in.w3, at, F.w);
  load_field<3>(in.sf, at, F.s);
  load_field<2>(in.flow, at, F.f);
  load_field<1>(in.mask, at, &F.m);
  F.d = 0.0f;
  if (flags & kMidas) load_field<1>(in.d1, at, &F.d);
  return F;
}

// Per-pixel values of _pixel_chain, in its order of operations.
struct Pixel {
  float occ, q[3], img[3], inv_z, live, rx, ry, c1, c2;
};

__device__ __forceinline__ Pixel pixel_chain(const Camera& C,
                                             const Fields& F, float bx,
                                             float by, int flags) {
  const float *g = F.g, *w = F.w, *s = F.s, *f = F.f;
  Pixel v;
  v.occ = F.m;
  if (flags & kMidas) {
    v.occ = v.occ * (F.d < kMidasFar ? 1.0f : 0.0f);
    v.occ = v.occ * (w[2] < kMidasFar ? 1.0f : 0.0f);
  }
  float rel[3], p1c2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float wg = C.R[3 * i] * w[0] + C.R[3 * i + 1] * w[1] +
                     C.R[3 * i + 2] * w[2] + C.t[i];
    v.q[i] = wg - g[i] - s[i];
    rel[i] = g[i] + s[i] - C.t[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p1c2[i] = C.R[i] * rel[0] + C.R[3 + i] * rel[1] + C.R[6 + i] * rel[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v.img[i] = C.K[3 * i] * p1c2[0] + C.K[3 * i + 1] * p1c2[1] +
               C.K[3 * i + 2] * p1c2[2];
  const float z = v.img[2];
  v.live = z >= kZDegenerate ? 1.0f : 0.0f;
  v.inv_z = v.live > 0.0f ? 1.0f / (z + kEpsProj) : 0.0f;
  const float pix_x = v.img[0] * v.inv_z;
  const float pix_y = v.img[1] * v.inv_z;
  v.rx = (pix_x - bx) * v.live - f[0];
  v.ry = (pix_y - by) * v.live - f[1];
  v.c1 = p1c2[2];
  v.c2 = w[2];
  return v;
}

// The four weighted residuals of one pixel: [flow, disp, sf, occ].
__device__ __forceinline__ void residuals(const Pixel& p, int flags,
                                          float r[4]) {
  float flow_r, disp_r;
  if (flags & kWarm)
    flow_r = p.rx * p.rx + p.ry * p.ry;
  else
    flow_r = fabsf(p.rx) + fabsf(p.ry);
  if (flags & (kUseDisp | kUseDispRatio)) {
    const float t1 = fmaxf(p.c1, kClipMin), t2 = fmaxf(p.c2, kClipMin);
    disp_r = (flags & kUseDisp) ? 100.0f * fabsf(1.0f / t1 - 1.0f / t2)
                                : fmaxf(t1, t2) / fminf(t1, t2) - 1.0f;
  } else {
    disp_r = fabsf(p.c1 - p.c2);
  }
  const float sf_r = fabsf(p.q[0]) + fabsf(p.q[1]) + fabsf(p.q[2]);
  r[0] = p.occ * flow_r;
  r[1] = p.occ * disp_r;
  r[2] = p.occ * sf_r;
  r[3] = p.occ;
}

// Gradients of a . flow + bb . disp + c . sf of one pixel at gp1 (dg),
// w3 (dw) and sf (ds).
__device__ __forceinline__ void pixel_grad(const Camera& C, const Pixel& v,
                                           int flags, float a, float bb,
                                           float c, float* dg, float* dw,
                                           float* ds) {
  const float occ = v.occ;
  // scene-flow residual: resid = sum_i |q_i|, q = R w3 + t - gp1 - sf
  float gq[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) gq[i] = c * occ * sgn(v.q[i]);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dw[j] = C.R[j] * gq[0] + C.R[3 + j] * gq[1] + C.R[6 + j] * gq[2];
#pragma unroll
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
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dp[j] = C.K[j] * dimg[0] + C.K[3 + j] * dimg[1] + C.K[6 + j] * dimg[2];
  dp[2] = dp[2] + dc1;
  // p1c2 = R^T (gp1 + sf - t) -> d rel = R dp
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dadv = C.R[3 * i] * dp[0] + C.R[3 * i + 1] * dp[1] +
                       C.R[3 * i + 2] * dp[2];
    dg[i] = dg[i] + dadv;
    ds[i] = ds[i] + dadv;
  }
}

// Fixed-order block sum of v[0..3] (warp shuffle tree, then warp 0 over the
// warp sums in order); thread 0 gets the result.
__device__ __forceinline__ void block_sum4(float v[4], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[4 * warp + c] = v[c];
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kThreads / 32;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = lane < kWarps ? red[4 * lane + c] : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
  }
}

// The pixel's position (x, y) in its image.
__device__ __forceinline__ void position(const Where& at, int W, float* x,
                                         float* y) {
  const int row = at.r / W;
  *x = (float)(at.r - row * W);
  *y = (float)row;
}

// The four sums in one launch. work: a ticket counter (16 B, left at 0)
// then one float4 partial a block.
__global__ void __launch_bounds__(kThreads)
    loss_fwd(Inputs in, int HW, int W, int flags, float* __restrict__ work,
             float* __restrict__ out) {
  __shared__ float red[4 * kThreads / 32];
  __shared__ bool last;
  unsigned* ticket = reinterpret_cast<unsigned*>(work);
  float4* part = reinterpret_cast<float4*>(work) + 1;
  const Where at(HW);
  const Camera C = load_camera(in.cam, blockIdx.y);
  const Fields F = load_pixel(in, at, flags);
  float x, y, v[4];
  position(at, W, &x, &y);
  residuals(pixel_chain(C, F, x, y, flags), flags, v);
  if (!at.valid) v[0] = v[1] = v[2] = v[3] = 0.0f;
  block_sum4(v, red);
  const unsigned n_blocks = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    part[blockIdx.y * gridDim.x + blockIdx.x] =
        make_float4(v[0], v[1], v[2], v[3]);
    __threadfence();  // the partial is visible before the ticket is
    last = atomicAdd(ticket, 1u) == n_blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial in index order (a fixed stride a thread,
  // then the fixed tree), whichever block this is
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (unsigned i = threadIdx.x; i < n_blocks; i += kThreads) {
    const float4 q = __ldcg(part + i);
    s[0] += q.x;
    s[1] += q.y;
    s[2] += q.z;
    s[3] += q.w;
  }
  block_sum4(s, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = s[c];
    *ticket = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
    loss_bwd(Inputs in, int HW, int W, int flags,
             const float* __restrict__ cot, float* __restrict__ dgp1,
             float* __restrict__ dw3, float* __restrict__ dsf) {
  const Where at(HW);
  if (!at.valid) return;
  const Camera C = load_camera(in.cam, blockIdx.y);
  // occ_mass (cot[3]) has no gradient
  const float a = __ldg(cot), bb = __ldg(cot + 1), c = __ldg(cot + 2);
  const Fields F = load_pixel(in, at, flags);
  float x, y, dg[3], dw[3], ds[3];
  position(at, W, &x, &y);
  pixel_grad(C, pixel_chain(C, F, x, y, flags), flags, a, bb, c, dg, dw, ds);
  // field after field: the three stores of one field back to back (stores
  // interleaved across the three fields were slower on the card)
#pragma unroll
  for (int i = 0; i < 3; ++i) dgp1[3 * at.q + i] = dg[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) dw3[3 * at.q + i] = dw[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) dsf[3 * at.q + i] = ds[i];
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

// The launch grid, or an error.
cudaError_t grid_of(int B, int H, int W, dim3* grid) {
  const int64_t HW = (int64_t)H * W;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || HW > (1 << 30))
    return cudaErrorInvalidValue;
  *grid = dim3((unsigned)((HW + kThreads - 1) / kThreads), (unsigned)B);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out[4] = [flow_sum, disp_sum, sf_sum, occ_mass] in one launch. work
// holds 4 + 4 * slots floats, 16-byte aligned, its first 4 zero (the
// ticket counter, which the kernel leaves at 0); slots must cover one a
// block, B * ceil(H W / 256).
int dvd_loss_fwd(const float* gp1, const float* w3, const float* sf,
                 const float* flow, const float* mask, const float* d1,
                 const float* cam, int B, int H, int W, int flags,
                 float* work, int slots, float* out, void* stream) {
  dim3 grid;
  cudaError_t e = grid_of(B, H, W, &grid);
  if (e != cudaSuccess) return (int)e;
  if ((int64_t)grid.x * grid.y > slots || ((uintptr_t)work & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  loss_fwd<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      make_inputs(gp1, w3, sf, flow, mask, d1, cam), H * W, W, flags, work,
      out);
  return (int)cudaGetLastError();
}

// Gradients at gp1, w3 and sf [B,H,W,3] of cot[0..2] . sums[0..2]; cot is
// the forward's cotangent [4] on the device.
int dvd_loss_bwd(const float* gp1, const float* w3, const float* sf,
                 const float* flow, const float* mask, const float* d1,
                 const float* cam, int B, int H, int W, int flags,
                 const float* cot, float* dgp1, float* dw3, float* dsf,
                 void* stream) {
  dim3 grid;
  cudaError_t e = grid_of(B, H, W, &grid);
  if (e != cudaSuccess) return (int)e;
  loss_bwd<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      make_inputs(gp1, w3, sf, flow, mask, d1, cam), H * W, W, flags, cot,
      dgp1, dw3, dsf);
  return (int)cudaGetLastError();
}

}  // extern "C"
