// Bilinear backward warp, forward and source gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dynamic_video_depth_tpu/ops/pallas/
// warp_kernel.py::fused_backward_warp (forward, _fwd_kernel) and _warp_bwd
// (_bwd_kernel). The TPU version expressed the gather as tent-weight
// matmuls over a static row window because Mosaic has no gathers; here
// each thread gathers its four taps directly, and the backward keeps the
// TPU kernel's one idea that carries over: taps are accumulated in fast
// local memory and added to the image once.
//
// Semantics (ops/grid_sample.py): sample src [B,H,W,C] (channel-last,
// contiguous) at (x + flow_x, y + flow_y), clamp the continuous coordinate to
// [0, W-1] x [0, H-1] (align_corners + border padding), floor, x1 =
// min(x0 + 1, W - 1), bilinear weights from the clamped coordinate. The flow
// is data: its gradient is zero.
//
// The tile map, shared by both directions and mirrored by
// ops/cuda/warp_kernel.py (TILE, WINDOW, window_rows, window_plan): a block
// of 256 threads owns a 32x8 tile of output pixels, one per thread, so that
// a warp is one row of 32 neighbours whose taps cluster wherever the flow is
// smooth.
//
// What bounds it on the H100: neither bytes nor operations. At 224x384 the
// bytes bound (flow, g or src read once, the output written once) is
// 0.0008-0.0010 ms at 3.35 TB/s, under the launch floor: an empty kernel
// launched through ctypes takes ~0.002 ms of device time on this card
// (chip_smoke.py's [floor] line). What is left is latency (the chain of
// dependent loads) and, in the backward, the reductions into dsrc.
//
// The backward's window: each warp holds a private window of 48x4 source
// pixels in shared memory (one float4 slot a pixel at C = 3 and 4; 24 KB a
// block), starting at the warp's smallest taps. A tap that falls in it is
// added there by a plain read-modify-write: no other warp touches the
// window, and within the warp the adds go in 1, 2 or 4 sub-steps of lanes
// whose targets are provably distinct. Shared-memory float atomics are not
// used: on sm_90 they compile to compare-and-swap loops (ATOMS.CAST.SPIN),
// which doubled the kernel's time in this design's first version. A tap
// outside the window, and every tap of a warp whose targets may collide (a
// fold in the flow, a tap clamped onto its neighbour at the border), goes
// straight to dsrc with a global vector reduction: 16 bytes at C = 4, 16 or
// 8 + 4 bytes at C = 3, one per channel at other C. Then the window's
// non-zero entries, in the bounding box of the warp's taps, go to dsrc the
// same way. So the result is exact for every flow, with no fallback path to
// choose; on the train step's smooth flows most taps stay in a window.
// dsrc is zeroed first on the same stream. Sums land in atomic order: the
// backward is compared with a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32, kTileY = 8;     // output pixels of a block
constexpr int kThreads = kTileX * kTileY;  // one thread per output pixel
constexpr int kWinX = 48, kWinY = 4;       // a warp's window, pixels
constexpr int kWinBytes = 47 * 1024;       // a block's windows at most

// Clamped sample position of output pixel `pix` (x, y) and its corners.
struct Sample {
  int x0, x1, y0, y1;  // the taps' columns and rows
  float wx, wy;        // weights of the x1 / y1 taps
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ flow,
                                            int64_t pix, int x, int y, int H,
                                            int W) {
  float sx = fminf(fmaxf((float)x + flow[2 * pix], 0.0f), (float)(W - 1));
  float sy =
      fminf(fmaxf((float)y + flow[2 * pix + 1], 0.0f), (float)(H - 1));
  float x0f = floorf(sx), y0f = floorf(sy);
  Sample s;
  s.wx = sx - x0f;
  s.wy = sy - y0f;
  s.x0 = (int)x0f;
  s.y0 = (int)y0f;
  s.x1 = min(s.x0 + 1, W - 1);
  s.y1 = min(s.y0 + 1, H - 1);
  return s;
}

// Same order of operations as ops/grid_sample.py::grid_sample.
__device__ __forceinline__ float lerp2(float v00, float v01, float v10,
                                       float v11, float wx, float wy) {
  float top = v00 * (1.0f - wx) + v01 * wx;
  float bot = v10 * (1.0f - wx) + v11 * wx;
  return top * (1.0f - wy) + bot * wy;
}

// kC = 4: one 16-byte load per tap and one 16-byte store (src and out
// 16-byte aligned); kC = 3: the channels unrolled; kC = 0: any C, a loop.
template <int kC>
__global__ void __launch_bounds__(kThreads)
    warp_fwd(const float* __restrict__ src, const float* __restrict__ flow,
             float* __restrict__ out, int H, int W, int c_any) {
  const int C = kC ? kC : c_any;
  const int x = blockIdx.x * kTileX + threadIdx.x % kTileX;
  const int y = blockIdx.y * kTileY + threadIdx.x / kTileX;
  if (x >= W || y >= H) return;
  const int64_t img = (int64_t)blockIdx.z * H * W;
  const int64_t pix = img + (int64_t)y * W + x;
  const Sample p = sample_at(flow, pix, x, y, H, W);
  const int64_t t00 = img + (int64_t)p.y0 * W + p.x0;
  const int64_t t01 = img + (int64_t)p.y0 * W + p.x1;
  const int64_t t10 = img + (int64_t)p.y1 * W + p.x0;
  const int64_t t11 = img + (int64_t)p.y1 * W + p.x1;
  if constexpr (kC == 4) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4 a = __ldg(s + t00), c = __ldg(s + t01);
    float4 d = __ldg(s + t10), e = __ldg(s + t11);
    float4 o;
    o.x = lerp2(a.x, c.x, d.x, e.x, p.wx, p.wy);
    o.y = lerp2(a.y, c.y, d.y, e.y, p.wx, p.wy);
    o.z = lerp2(a.z, c.z, d.z, e.z, p.wx, p.wy);
    o.w = lerp2(a.w, c.w, d.w, e.w, p.wx, p.wy);
    reinterpret_cast<float4*>(out)[pix] = o;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[pix * C + c] = lerp2(__ldg(src + t00 * C + c),
                               __ldg(src + t01 * C + c),
                               __ldg(src + t10 * C + c),
                               __ldg(src + t11 * C + c), p.wx, p.wy);
    }
  }
}

// Adds v[0..kC) to dsrc at `d` (a pixel's first channel; dsrc ends at
// `end`) with global reductions: one of 16 bytes at C = 4 (d is 16-byte
// aligned); at C = 3 one of 16 bytes where the pixel's 12 lie in one
// aligned 16 (adding 0 to the neighbouring float), else one of 8 and one
// of 4 bytes.
template <int kC>
__device__ __forceinline__ void red_pixel(float* d, const float* v,
                                          const float* end) {
  if constexpr (kC == 4) {
    atomicAdd(reinterpret_cast<float4*>(d),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
    static_assert(kC == 3, "red_pixel: C = 3 or 4");
    switch ((reinterpret_cast<uintptr_t>(d) >> 2) & 3) {
      case 0:
        if (d + 4 <= end) {
          atomicAdd(reinterpret_cast<float4*>(d),
                    make_float4(v[0], v[1], v[2], 0.0f));
          return;
        }
        atomicAdd(reinterpret_cast<float2*>(d), make_float2(v[0], v[1]));
        atomicAdd(d + 2, v[2]);
        return;
      case 1:
        atomicAdd(reinterpret_cast<float4*>(d - 1),
                  make_float4(0.0f, v[0], v[1], v[2]));
        return;
      case 2:
        atomicAdd(reinterpret_cast<float2*>(d), make_float2(v[0], v[1]));
        atomicAdd(d + 2, v[2]);
        return;
      default:
        atomicAdd(d, v[0]);
        atomicAdd(reinterpret_cast<float2*>(d + 1), make_float2(v[1], v[2]));
    }
  }
}

// Adds (a, b, c) to dsrc at `d` (a pixel's first channel at C = 3) with one
// reduction of 8 and one of 4 bytes, the same two instructions on every
// lane: neighbouring lanes' pixels then merge into few L2 transactions.
__device__ __forceinline__ void red_pair3(float* d, float a, float b,
                                          float c) {
  const bool even = (reinterpret_cast<uintptr_t>(d) & 4) == 0;
  atomicAdd(reinterpret_cast<float2*>(even ? d : d + 1),
            even ? make_float2(a, b) : make_float2(b, c));
  atomicAdd(even ? d + 2 : d, even ? c : a);
}

// Transpose of the forward: each output pixel adds g times each tap's
// weight, (g * wy) * wx as autograd applies the forward's two lerps, into
// its four taps (where a tap is clamped onto its neighbour both adds land
// on one pixel). A warp is one row of 32 output pixels and owns a window
// of kWinX x win_rows source pixels in shared memory (channel-last, a slot
// of 4 floats a pixel at C = 3), from its smallest taps on. No other warp
// touches the window, so the adds into it are plain read-modify-writes, in
// one step per tap when the warp's targets are distinct, else in 2 or 4
// sub-steps of lanes whose targets are; a tap outside the window, and
// every tap of a warp whose targets may collide (a fold, a tap clamped at
// the border), goes straight to dsrc. Then the window's non-zero entries,
// in the bounding box of its taps, go to dsrc. dsrc is zeroed and 16-byte
// aligned; g is 16-byte aligned at kC = 4.
template <int kC>
__global__ void __launch_bounds__(kThreads)
    warp_bwd(const float* __restrict__ g, const float* __restrict__ flow,
             float* __restrict__ dsrc, int H, int W, int c_any,
             int win_rows) {
  extern __shared__ float4 smem4[];  // per warp: [win_rows][kWinX][slot]
  const int C = kC ? kC : c_any;
  const int slot = C == 3 ? 4 : C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx0 = blockIdx.x * kTileX;
  const int x = tx0 + lane, y = blockIdx.y * kTileY + warp;
  if (y >= H) return;  // the whole warp: no block-wide barrier follows
  const bool valid = x < W;  // the warp's valid lanes are a prefix
  const int64_t img = (int64_t)blockIdx.z * H * W;
  const int64_t pix = img + (int64_t)y * W + min(x, W - 1);
  float gc[kC ? kC : 1];  // loaded first: it does not depend on the flow
  if constexpr (kC == 4) {
    const float4 v = valid ? __ldg(reinterpret_cast<const float4*>(g) + pix)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    gc[0] = v.x;
    gc[1] = v.y;
    gc[2] = v.z;
    gc[3] = v.w;
  } else if constexpr (kC == 3) {
#pragma unroll
    for (int c = 0; c < 3; ++c) gc[c] = valid ? __ldg(g + pix * 3 + c) : 0.0f;
  }
  const Sample p = sample_at(flow, pix, min(x, W - 1), y, H, W);

  // the window starts at the warp's smallest top-left tap, clamped so
  // that it lies in the image where the image is large enough
  const int far = 1 << 30;  // lane 0 is always valid: the minima are taps
  const int wx0 = min(__reduce_min_sync(0xffffffffu, valid ? p.x0 : far),
                      max(W - kWinX, 0));
  const int wy0 = min(__reduce_min_sync(0xffffffffu, valid ? p.y0 : far),
                      max(H - win_rows, 0));

  // A tap step adds one offset to every lane's top-left target, so the
  // step's targets are distinct wherever the top-left taps, keyed
  // column-major in window coordinates, are, and no tap is clamped onto
  // its neighbour. `steps` is the least of 1, 2 and 4 for which the keys
  // strictly increase along the lanes of each residue class (lane mod
  // steps): the adds then go in `steps` sub-steps, one class each. Where
  // none holds (a fold, a tap clamped at the border) steps is 0: the warp
  // uses no window.
  const int key = (p.x0 - wx0) * max(win_rows, 1) + (p.y0 - wy0);
  const int key1 = __shfl_up_sync(0xffffffffu, key, 1);
  const int key2 = __shfl_up_sync(0xffffffffu, key, 2);
  const int key4 = __shfl_up_sync(0xffffffffu, key, 4);
  const bool unclamped = !valid || (p.x1 != p.x0 && p.y1 != p.y0);
  const int steps =
      win_rows == 0 || !__all_sync(0xffffffffu, unclamped) ? 0
      : __all_sync(0xffffffffu, !valid || lane < 1 || key > key1) ? 1
      : __all_sync(0xffffffffu, !valid || lane < 2 || key > key2) ? 2
      : __all_sync(0xffffffffu, !valid || lane < 4 || key > key4) ? 4
                                                                  : 0;
  float* win = reinterpret_cast<float*>(smem4) +
               warp * win_rows * kWinX * slot;
  if (steps) {
    for (int i = lane; i < win_rows * kWinX * slot / 4; i += 32) {
      reinterpret_cast<float4*>(win)[i] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncwarp();
  }

  const int xs[2] = {p.x0, p.x1}, ys[2] = {p.y0, p.y1};
  const float wxs[2] = {1.0f - p.wx, p.wx}, wys[2] = {1.0f - p.wy, p.wy};
  int bx0 = kWinX, bx1 = -1, by0 = win_rows, by1 = -1;  // window taps' box
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int lx = xs[s] - wx0, ly = ys[r] - wy0;
      const bool inside = steps && valid && (unsigned)lx < (unsigned)kWinX &&
                          (unsigned)ly < (unsigned)win_rows;
      if (inside) {
        bx0 = min(bx0, lx);
        bx1 = max(bx1, lx);
        by0 = min(by0, ly);
        by1 = max(by1, ly);
      }
      // two pointers, not one chosen between them: a pointer that may be
      // shared or global makes every atomic below a generic one, which the
      // compiler splits into a shared CAS loop and a global reduction
      float* at = win + (ly * kWinX + lx) * slot;
      float* d = dsrc + (img + (int64_t)ys[r] * W + xs[s]) * C;
      for (int sub = 0; sub < steps; ++sub) {
        if (inside && (lane & (steps - 1)) == sub) {
          if constexpr (kC > 0) {
            float4 o = *reinterpret_cast<float4*>(at);
            o.x += (gc[0] * wys[r]) * wxs[s];
            o.y += (gc[1] * wys[r]) * wxs[s];
            o.z += (gc[2] * wys[r]) * wxs[s];
            if constexpr (kC == 4) o.w += (gc[3] * wys[r]) * wxs[s];
            *reinterpret_cast<float4*>(at) = o;
          } else {
            for (int c = 0; c < C; ++c) {
              at[c] += (__ldg(g + pix * C + c) * wys[r]) * wxs[s];
            }
          }
        }
        __syncwarp();
      }
      if (valid && !inside) {
        if constexpr (kC > 0) {
          float v[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) v[c] = (gc[c] * wys[r]) * wxs[s];
          red_pixel<kC>(d, v, dsrc + gridDim.z * (int64_t)H * W * C);
        } else {
          for (int c = 0; c < C; ++c) {
            atomicAdd(d + c, (__ldg(g + pix * C + c) * wys[r]) * wxs[s]);
          }
        }
      }
    }
  }
  if (!steps) return;
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  by1 = __reduce_max_sync(0xffffffffu, by1);

  // flush: the box, a pixel a lane, 16-byte reductions at C = 4, a
  // branch-free 8 + 4-byte pair at C = 3, one per channel at other C
  for (int ly = by0; ly <= by1; ++ly) {
    const int64_t row = img + (int64_t)(wy0 + ly) * W + wx0;
    const float* wrow = win + ly * kWinX * slot;
    for (int px = bx0 + lane; px <= bx1; px += 32) {
      if constexpr (kC == 4) {
        const float4 o = reinterpret_cast<const float4*>(wrow)[px];
        if (o.x != 0.0f || o.y != 0.0f || o.z != 0.0f || o.w != 0.0f) {
          atomicAdd(reinterpret_cast<float4*>(dsrc) + row + px, o);
        }
      } else if constexpr (kC == 3) {
        const float4 o = reinterpret_cast<const float4*>(wrow)[px];
        if (o.x != 0.0f || o.y != 0.0f || o.z != 0.0f) {
          red_pair3(dsrc + (row + px) * 3, o.x, o.y, o.z);
        }
      } else {
        for (int c = 0; c < C; ++c) {
          const float v = wrow[px * slot + c];
          if (v != 0.0f) atomicAdd(dsrc + (row + px) * C + c, v);
        }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline dim3 tiles(int B, int H, int W) {
  return dim3((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
}

}  // namespace

extern "C" {

// out[B,H,W,C] = warp(src, flow).
int dvd_warp_fwd(const float* src, const float* flow, float* out, int B,
                 int H, int W, int C, void* stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 4 && aligned16(src) && aligned16(out)) {
    warp_fwd<4><<<tiles(B, H, W), kThreads, 0, s>>>(src, flow, out, H, W, C);
  } else if (C == 3) {
    warp_fwd<3><<<tiles(B, H, W), kThreads, 0, s>>>(src, flow, out, H, W, C);
  } else {
    warp_fwd<0><<<tiles(B, H, W), kThreads, 0, s>>>(src, flow, out, H, W, C);
  }
  return (int)cudaGetLastError();
}

// dsrc[B,H,W,C] = warp^T(g), zeroed here on the same stream; dsrc is
// 16-byte aligned (the wrapper allocates it). win_rows: the window's rows
// (warp_kernel.window_rows(C)): win_rows * 48 pixels of shared memory for
// each of the block's 8 warps, C floats a pixel (4 at C = 3).
int dvd_warp_bwd(const float* g, const float* flow, float* dsrc, int B, int H,
                 int W, int C, int win_rows, void* stream) {
  const size_t win_bytes = sizeof(float) * (kThreads / 32) *
                           (size_t)(C == 3 ? 4 : C) * win_rows * kWinX;
  if (B > 65535 || !aligned16(dsrc) || win_rows < 0 || win_rows > kWinY ||
      win_bytes > (size_t)kWinBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(dsrc, 0, sizeof(float) * (size_t)B * H * W * C, s);
  if (e != cudaSuccess) return (int)e;
  if ((int64_t)B * H * W == 0) return (int)cudaGetLastError();
  if (C == 4 && aligned16(g)) {
    warp_bwd<4><<<tiles(B, H, W), kThreads, win_bytes, s>>>(g, flow, dsrc, H,
                                                             W, C, win_rows);
  } else if (C == 3) {
    warp_bwd<3><<<tiles(B, H, W), kThreads, win_bytes, s>>>(g, flow, dsrc, H,
                                                             W, C, win_rows);
  } else {
    warp_bwd<0><<<tiles(B, H, W), kThreads, win_bytes, s>>>(g, flow, dsrc, H,
                                                             W, C, win_rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
