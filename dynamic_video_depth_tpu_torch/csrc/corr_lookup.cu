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
// levels, r = 4) one launch writes 6.0 MB and weighs ~2 MB of distinct
// pyramid values, out of a 56 MB pyramid: bytes, ~2.7 microseconds at
// 3.35 TB/s, with the output most of it.
//
// Design. One warp owns one point, a block two points (2,304 blocks at
// that shape; blocks of one or eight points were slower on the card), and
// the radius is a compile-time constant (0..7), so every index of the
// window is constant arithmetic. All taps of a level lie in the rows
// [y0(dy = -r), y1(dy = r)] and the columns [x0(dx = -r), x1(dx = r)]
// (clamp and floor are monotonic), a patch of at most (2r + 2)^2 values. Lane l < L finds level l's patch; the warp then copies each
// patch into shared memory once, a row of lanes a patch row (cp.async, 4
// bytes a lane, no registers held), where the gather read 4 taps of 324
// window entries from memory. The window is separable: the K row samples
// (patch row offsets of y0 and y1, 1 - fy, fy) and the K column samples of
// every level are formed once, by 2 K L lanes, and every entry is then 4
// shared-memory taps and the lerp, in the plain version's formula and
// order. A lane keeps one column of the window at every level and walks
// its rows, so its column sample is read once a level; a store of the warp
// writes K G consecutive outputs of G consecutive rows (a float4 a lane
// would need four entries' samples a lane). A top level smaller than the
// window (4x8 at level 3) just gives a smaller patch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 7;
constexpr int kWarps = 2;  // points a block at most
constexpr int kSmemBytes = 48 * 1024;

struct Pyramid {
  const float* corr[kMaxLevels];  // level l: [B, N, Hl, Wl]
  int h[kMaxLevels];
  int w[kMaxLevels];
  int L;
};

// 2^-l, exact
__device__ __forceinline__ float pow2neg(int l) {
  return __int_as_float((127 - l) << 23);
}

// The clamped continuous coordinate of window offset d, as the plain
// version forms it (c * 2^-l is exact, so this is c / 2^l + d).
__device__ __forceinline__ float clamped(float c, float inv, int d,
                                         int size) {
  return fminf(fmaxf(c * inv + (float)d, 0.0f), (float)(size - 1));
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// One window entry of a level from its staged patch and its row and column
// samples: {offset of y0, offset of y1, 1 - fy, fy} and {x0, x1, 1 - fx,
// fx}, the plain version's lerp in its order.
__device__ __forceinline__ float entry(const float* patch, float4 Y,
                                       float4 X) {
  const int y0 = __float_as_int(Y.x), y1 = __float_as_int(Y.y);
  const int x0 = __float_as_int(X.x), x1 = __float_as_int(X.y);
  return Y.z * X.z * patch[y0 + x0] + Y.z * X.w * patch[y0 + x1] +
         Y.w * X.z * patch[y1 + x0] + Y.w * X.w * patch[y1 + x1];
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
    corr_lookup(Pyramid pyr, const float* __restrict__ coords,
                int64_t n_points, float* __restrict__ out) {
  constexpr int K = 2 * R + 1, P = K + 1, KK = K * K;
  // a level's shared memory: the patch (P x P) then K row and K column
  // samples (float4 each); P is even, so every part is 16-byte aligned
  constexpr int kLevelFloats = P * P + 8 * K;
  constexpr int kRows = 32 / P;          // patch rows a copy pass
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n_points) return;
  const int L = pyr.L;
  float* base = reinterpret_cast<float*>(smem4) + warp * L * kLevelFloats;
  const float cx = __ldg(coords + 2 * p), cy = __ldg(coords + 2 * p + 1);

  // lane l < L: level l's patch, rows [y_lo, y_lo + rows), columns
  // [x_lo, x_lo + cols)
  int y_lo = 0, x_lo = 0, rows = 0, cols = 0;
  if (lane < L) {
    const int hl = pyr.h[lane], wl = pyr.w[lane];
    const float inv = pow2neg(lane);
    y_lo = (int)floorf(clamped(cy, inv, -R, hl));
    x_lo = (int)floorf(clamped(cx, inv, -R, wl));
    rows = min((int)floorf(clamped(cy, inv, R, hl)) + 1,
               min(hl - 1, y_lo + P - 1)) - y_lo + 1;
    cols = min((int)floorf(clamped(cx, inv, R, wl)) + 1,
               min(wl - 1, x_lo + P - 1)) - x_lo + 1;
  }
  // copy every patch, a row of P lanes a patch row
  const int lr = lane / P, lc = lane - lr * P;
  for (int l = 0; l < L; ++l) {
    const int ly = __shfl_sync(0xffffffffu, y_lo, l);
    const int lx = __shfl_sync(0xffffffffu, x_lo, l);
    const int n_rows = __shfl_sync(0xffffffffu, rows, l);
    const int n_cols = __shfl_sync(0xffffffffu, cols, l);
    const int hl = pyr.h[l], wl = pyr.w[l];
    const float* vol =
        pyr.corr[l] + (p * hl + ly) * (int64_t)wl + lx + (int64_t)lr * wl;
    float* patch = base + l * kLevelFloats + lr * P + lc;
    if (lr < kRows && lc < n_cols)
      for (int r = lr; r < n_rows; r += kRows)
        copy_async(patch + (r - lr) * P, vol + (int64_t)(r - lr) * wl + lc);
  }
  // the row (k < K) and column samples of every level, 2 K L of them
  for (int i0 = 0; i0 < 2 * K * L; i0 += 32) {
    const int i = i0 + lane;
    const int l = min(i / (2 * K), L - 1);
    const int k = i - l * 2 * K;
    const int ly = __shfl_sync(0xffffffffu, y_lo, l);
    const int lx = __shfl_sync(0xffffffffu, x_lo, l);
    if (i < 2 * K * L) {
      const bool is_y = k < K;
      const int size = is_y ? pyr.h[l] : pyr.w[l];
      const float c = clamped(is_y ? cy : cx, pow2neg(l),
                              (is_y ? k : k - K) - R, size);
      const float f0 = floorf(c);
      const float frac = c - f0;
      const int i0c = (int)f0, i1c = min(i0c + 1, size - 1);
      const int lo = is_y ? ly : lx, pitch = is_y ? P : 1;
      reinterpret_cast<float4*>(base + l * kLevelFloats + P * P)[k] =
          make_float4(__int_as_float((i0c - lo) * pitch),
                      __int_as_float((i1c - lo) * pitch), 1.0f - frac, frac);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // the entries: lane l takes column l % K of the window, in row group
  // l / K of G = 32 / K groups, and walks the rows of its group: its column
  // sample is loaded once a level, and each store of the warp writes G
  // consecutive rows' K G consecutive outputs
  constexpr int G = 32 / K;
  const int col = lane % K, group = lane / K;
  float* dst = out + p * (L * KK);
  if (group < G)
    for (int l = 0; l < L; ++l) {
      const float* patch = base + l * kLevelFloats;
      const float4* samples = reinterpret_cast<const float4*>(patch + P * P);
      const float4 X = samples[K + col];
#pragma unroll
      for (int iy = group; iy < K; iy += G)
        dst[l * KK + iy * K + col] = entry(patch, samples[iy], X);
    }
}

template <int R>
cudaError_t launch(const Pyramid& pyr, const float* coords, int64_t n_points,
                   float* out, cudaStream_t stream) {
  constexpr int K = 2 * R + 1;
  const int warp_bytes =
      pyr.L * ((K + 1) * (K + 1) + 8 * K) * (int)sizeof(float);
  const int warps = kSmemBytes / warp_bytes < kWarps ? kSmemBytes / warp_bytes
                                                     : kWarps;
  const int64_t blocks = (n_points + warps - 1) / warps;
  if (warps < 1 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  corr_lookup<R><<<(unsigned)blocks, warps * 32, warps * warp_bytes,
                   stream>>>(pyr, coords, n_points, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B, N, L (2r+1)^2] from coords [B, N, 2] (x, y) and the L level
// volumes corr[l] [B, N, h[l], w[l]]; 0 <= r <= 7.
int dvd_corr_lookup(const void* const* corr, const int* h, const int* w,
                    int L, const float* coords, int B, int N, int radius,
                    float* out, void* stream) {
  if (L < 1 || L > kMaxLevels || radius < 0 || radius > kMaxRadius ||
      B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr = {};
  pyr.L = L;
  for (int l = 0; l < L; ++l) {
    if (h[l] < 1 || w[l] < 1) return (int)cudaErrorInvalidValue;
    pyr.corr[l] = (const float*)corr[l];
    pyr.h[l] = h[l];
    pyr.w[l] = w[l];
  }
  const int64_t n = (int64_t)B * N;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (radius) {
    case 0: return (int)launch<0>(pyr, coords, n, out, st);
    case 1: return (int)launch<1>(pyr, coords, n, out, st);
    case 2: return (int)launch<2>(pyr, coords, n, out, st);
    case 3: return (int)launch<3>(pyr, coords, n, out, st);
    case 4: return (int)launch<4>(pyr, coords, n, out, st);
    case 5: return (int)launch<5>(pyr, coords, n, out, st);
    case 6: return (int)launch<6>(pyr, coords, n, out, st);
    default: return (int)launch<7>(pyr, coords, n, out, st);
  }
}

}  // extern "C"
