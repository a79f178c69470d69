// RAFT correlation-pyramid lookup, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of dynamic_video_depth_tpu/ops/pallas/
// correlation.py::fused_lookup_correlation (_lookup_kernel). For every point
// p = (b, i) of the 1/8-resolution grid, every level l and every window
// offset (dy, dx) in [-r, r]^2:
//   y = clamp(cy / 2^l + dy, 0, Hl - 1),  x = clamp(cx / 2^l + dx, 0, Wl - 1)
//   y0 = floor(y), y1 = min(y0 + 1, Hl - 1)  (the same for x)
//   out[p][l K^2 + (dy + r) K + (dx + r)] = bilinear lerp of the 4 taps of
//   level l's row of point p, where K = 2r + 1 (dy-major, levels in order).
// The continuous coordinate is clamped before the taps, as the JAX package
// does (models/raft.py::lookup_correlation).
//
// What bounds it on the H100. At 288x512 (B = 2, N = 36 x 64 = 2,304, four
// levels, r = 4) one launch writes 6.0 MB and gathers 4 x 324 floats per
// point from a 56 MB pyramid; the arithmetic is negligible, so it is bound by
// the gathers' latency and the L2 traffic. The TPU kernel split each gather
// into 128-lane vreg shuffles and selects because Mosaic has no general
// gather; Hopper gathers natively, so here one block owns one point and its
// threads walk the L K^2 window entries: neighbouring threads take
// neighbouring dx, so their taps fall on neighbouring addresses of the same
// row and the output row is written coalesced. No padding, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;

struct Pyramid {
  const float* corr[kMaxLevels];  // level l: [B, N, Hl, Wl]
  int h[kMaxLevels];
  int w[kMaxLevels];
  int L;
};

__global__ void __launch_bounds__(kThreads)
    corr_lookup(Pyramid pyr, const float* __restrict__ coords, int N,
                int radius, float* __restrict__ out) {
  const int i = blockIdx.x, b = blockIdx.y;
  const int64_t p = (int64_t)b * N + i;
  const int K = 2 * radius + 1, G = K * K;
  const float cx = coords[2 * p], cy = coords[2 * p + 1];
  for (int e = threadIdx.x; e < pyr.L * G; e += kThreads) {
    const int l = e / G, g = e - l * G;
    const int dy = g / K - radius, dx = g - (g / K) * K - radius;
    const int hl = pyr.h[l], wl = pyr.w[l];
    // 2^-l is exact, so this is the plain version's cy / 2^l + dy
    const float inv = 1.0f / (float)(1 << l);
    const float y = fminf(fmaxf(cy * inv + (float)dy, 0.0f), (float)(hl - 1));
    const float x = fminf(fmaxf(cx * inv + (float)dx, 0.0f), (float)(wl - 1));
    const float y0f = floorf(y), x0f = floorf(x);
    const float fy = y - y0f, fx = x - x0f;
    const int y0 = (int)y0f, x0 = (int)x0f;
    const int y1 = min(y0 + 1, hl - 1), x1 = min(x0 + 1, wl - 1);
    const float* row = pyr.corr[l] + p * (int64_t)hl * wl;
    const float v00 = __ldg(row + y0 * wl + x0);
    const float v01 = __ldg(row + y0 * wl + x1);
    const float v10 = __ldg(row + y1 * wl + x0);
    const float v11 = __ldg(row + y1 * wl + x1);
    out[p * pyr.L * G + e] = (1.0f - fy) * (1.0f - fx) * v00 +
                             (1.0f - fy) * fx * v01 + fy * (1.0f - fx) * v10 +
                             fy * fx * v11;
  }
}

}  // namespace

extern "C" {

// out [B, N, L (2r+1)^2] from coords [B, N, 2] (x, y) and the L level
// volumes corr[l] [B, N, h[l], w[l]].
int dvd_corr_lookup(const void* const* corr, const int* h, const int* w,
                    int L, const float* coords, int B, int N, int radius,
                    float* out, void* stream) {
  if (L < 1 || L > kMaxLevels || radius < 0 || B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr = {};
  pyr.L = L;
  for (int l = 0; l < L; ++l) {
    if (h[l] < 1 || w[l] < 1) return (int)cudaErrorInvalidValue;
    pyr.corr[l] = (const float*)corr[l];
    pyr.h[l] = h[l];
    pyr.w[l] = w[l];
  }
  if (B == 0 || N == 0) return (int)cudaGetLastError();
  corr_lookup<<<dim3((unsigned)N, (unsigned)B), kThreads, 0,
                (cudaStream_t)stream>>>(pyr, coords, N, radius, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
