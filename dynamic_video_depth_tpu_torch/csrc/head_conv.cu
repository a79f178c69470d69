// Float32 3x3 convolution, stride 1, padding 1, with bias, forward only, for
// Hopper (sm_90a): the first layer of the depth heads (models/midas.py::
// output_head; 256 -> 128 channels at 112x192 in the train step).
//
// Replaces no TPU kernel: the JAX package leaves this convolution to XLA.
// It exists because cuDNN's float32 pick for this shape (TF32 off) is its
// FFT route, ~435 ms a call at batch 2 for 25.37 GFLOP of work.
//
// What bounds it on the H100: float32 FMAs on the CUDA cores (no TF32: the
// configurations compute in float32). Batch 2 at 112x192, 256 -> 128:
// 2 * (2 * 112 * 192) * 128 * (256 * 9) = 25.37 GFLOP, 0.379 ms at
// 67 TFLOP/s; batch 16: 202.9 GFLOP, 3.03 ms. Its bytes (x 44 MB, y 22 MB,
// w 1.2 MB at batch 2) take 0.02 ms at 3.35 TB/s.
//
// Layouts: x and y are NCHW tensors, in either memory order: contiguous
// (NCHW) or channels-last (NHWC, what the nets hand the head: their stem
// takes a permuted NHWC image and cuDNN keeps that order). y has x's order.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// input channels x 9 taps. A block of 256 threads computes 128 output
// channels for a tile of 2 rows x 64 columns of one image and walks K in
// chunks of 8 input channels. A two-slot cp.async ring in shared memory
// holds each chunk's input patch as [channel][row][column] (8 channels x 4
// rows x 72 columns: the tile's halo, from column x0 - 4 so that a 16-byte
// copy of an NCHW row is aligned; from NHWC, 4-byte copies, a warp's lanes
// along the 8 channels of a pixel, one 32-byte sector a pixel) and its
// weights, turned to [k][channel] on the way in (4-byte copies; a
// warp takes 8 consecutive k of 4 channels, one 32-byte sector a channel in
// memory and 32 distinct banks in shared memory). Zero padding is the
// copies' zero fill at the edges: there is no padded copy of x and no
// workspace. Each thread keeps 8 channels x 8 consecutive pixels of one row
// in registers: per input channel and kernel row it reads 10 input values
// once and the weights of the 3 taps (6 float4), and makes 192 FMAs. Each
// output sums its products in k = (channel, ky, kx) order, in float32.
// A block holds an SM (94,464 bytes of shared memory, ~150 registers a
// thread with no spills): on the card that was 3-5% faster than two blocks
// an SM held to 128 registers, which spilled, and cuts the waves' ragged
// end (batch 2: 336 tiles over 132 SMs). Unrolling the loop over a stage's
// input channels by 1, 2 or 8 moved nothing, and padding the patch's
// channel planes (the NHWC copies' 8-way bank conflicts) lost 0.4-2%.
// Stores go straight to y, with the bias: NCHW rows as float4s, or a
// pixel's channels as float4s in NHWC.
// NCHW rows whose width is not a multiple of 4 (or an x not 16-byte
// aligned) take 4-byte copies and stores: the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 2;                       // output rows of a tile
constexpr int kCols = 64;                      // output columns of a tile
constexpr int kCout = 128;                     // output channels of a tile
constexpr int kChunk = 8;                      // input channels a stage
constexpr int kThreads = 256;
constexpr int kPatchRows = kRows + 2;          // input rows y0-1 .. y0+2
constexpr int kPatchCols = kCols + 8;          // input columns x0-4 .. x0+67
constexpr int kK = kChunk * 9;                 // k values a stage
constexpr int kWStride = kCout + 4;            // a weight row, padded
constexpr int kPatchFloats = kChunk * kPatchRows * kPatchCols;  // 2,304
constexpr int kWeightFloats = kK * kWStride;                    // 9,504
constexpr int kStageFloats = kPatchFloats + kWeightFloats;
constexpr int kSmemBytes = 2 * kStageFloats * 4;                // 94,464
// memory orders of x and y, and how the patch is copied
constexpr int kNchwVec = 0;  // NCHW, W % 4 == 0, 16-byte aligned: 16 bytes
constexpr int kNchw = 1;     // NCHW otherwise: 4 bytes
constexpr int kNhwc = 2;     // channels-last: 4 bytes

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of input channels ci0 .. ci0+7 into a ring slot.
template <int kLayout>
__device__ __forceinline__ void load_stage(float* slot, const float* x,
                                           const float* w, int n, int ci0,
                                           int co0, int y0, int x0, int Cin,
                                           int H, int W, int tid) {
  float* xs = slot;
  float* ws = slot + kPatchFloats;
  const int64_t plane = (int64_t)H * W;
  if (kLayout == kNhwc) {  // x[n][iy][ix][ci0 + c]
    const float* xn = x + (int64_t)n * plane * Cin + ci0;
    for (int e = tid; e < kPatchFloats; e += kThreads) {
      const int c = e % kChunk, j = (e / kChunk) % kPatchCols;
      const int rr = e / (kChunk * kPatchCols);
      const int iy = y0 - 1 + rr, ix = x0 - 4 + j;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* src = ok ? xn + ((int64_t)iy * W + ix) * Cin + c : x;
      copy4(xs + (c * kPatchRows + rr) * kPatchCols + j, src, ok);
    }
  } else if (kLayout == kNchwVec) {
    // W % 4 == 0: a float4 lies wholly inside the row or outside
    const float* xc = x + ((int64_t)n * Cin + ci0) * plane;
    constexpr int kQuads = kPatchCols / 4;
    for (int e = tid; e < kChunk * kPatchRows * kQuads; e += kThreads) {
      const int q = e % kQuads, rr = (e / kQuads) % kPatchRows;
      const int c = e / (kQuads * kPatchRows);
      const int iy = y0 - 1 + rr, ix = x0 - 4 + 4 * q;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* src = ok ? xc + c * plane + (int64_t)iy * W + ix : x;
      copy16(xs + (c * kPatchRows + rr) * kPatchCols + 4 * q, src, ok);
    }
  } else {
    const float* xc = x + ((int64_t)n * Cin + ci0) * plane;
    for (int e = tid; e < kPatchFloats; e += kThreads) {
      const int j = e % kPatchCols, rr = (e / kPatchCols) % kPatchRows;
      const int c = e / (kPatchCols * kPatchRows);
      const int iy = y0 - 1 + rr, ix = x0 - 4 + j;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* src = ok ? xc + c * plane + (int64_t)iy * W + ix : x;
      copy4(xs + (c * kPatchRows + rr) * kPatchCols + j, src, ok);
    }
  }
  // w[co0 + co][ci0 + ci][ky][kx] -> ws[k][co], k = ci * 9 + ky * 3 + kx
  const int warp = tid >> 5, lane = tid & 31;
  const float* wb = w + (int64_t)co0 * Cin * 9 + ci0 * 9;
  for (int u = warp; u < (kK / 8) * (kCout / 4); u += kThreads / 32) {
    const int k = (u % (kK / 8)) * 8 + (lane & 7);
    const int co = (u / (kK / 8)) * 4 + (lane >> 3);
    copy4(ws + k * kWStride + co, wb + (int64_t)co * Cin * 9 + k, true);
  }
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
    head_conv_fwd(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int Cin, int H, int W, int Cout) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * kRows;
  const int co_tiles = Cout / kCout;
  const int n = blockIdx.z / co_tiles, co0 = (blockIdx.z % co_tiles) * kCout;
  // this thread: channels cg*4 .. cg*4+3 and 64+cg*4 .. 64+cg*4+3 of the
  // tile, pixels c0 .. c0+7 of tile row r
  const int cg = lane & 15, pg = warp * 2 + (lane >> 4);
  const int r = pg >> 3, c0 = (pg & 7) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int chunks = Cin / kChunk;
  load_stage<kLayout>(smem, x, w, n, 0, co0, y0, x0, Cin, H, W, tid);
  commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      load_stage<kLayout>(smem + ((c + 1) & 1) * kStageFloats, x, w, n,
                          (c + 1) * kChunk, co0, y0, x0, Cin, H, W, tid);
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    const float* xs = smem + (c & 1) * kStageFloats;
    const float* ws = xs + kPatchFloats;
#pragma unroll 2
    for (int ci = 0; ci < kChunk; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // input columns x0 + c0 - 1 .. x0 + c0 + 8 (patch column c0 + 3 on)
        const float* arow = xs + (ci * kPatchRows + r + ky) * kPatchCols + c0 + 3;
        const float4 a1 = *reinterpret_cast<const float4*>(arow + 1);
        const float4 a2 = *reinterpret_cast<const float4*>(arow + 5);
        const float a[10] = {arow[0], a1.x, a1.y, a1.z, a1.w,
                             a2.x,    a2.y, a2.z, a2.w, arow[9]};
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wrow = ws + (ci * 9 + ky * 3 + kx) * kWStride;
          const float4 b1 = *reinterpret_cast<const float4*>(wrow + cg * 4);
          const float4 b2 =
              *reinterpret_cast<const float4*>(wrow + 64 + cg * 4);
          const float b[8] = {b1.x, b1.y, b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(b[i], a[j + kx], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the slot is refilled by the next iteration's copies
  }

  const int oy = y0 + r, ox = x0 + c0;
  if (oy >= H) return;
  float bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    bv[i] = bias ? bias[co0 + (i < 4 ? cg * 4 + i : 60 + cg * 4 + i)] : 0.0f;
  if (kLayout == kNhwc) {  // a pixel's 2 x 4 channels as two float4
    float* yp = y + (((int64_t)n * H + oy) * W + ox) * Cout + co0 + cg * 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ox + j >= W) break;
      *reinterpret_cast<float4*>(yp + (int64_t)j * Cout) =
          make_float4(acc[0][j] + bv[0], acc[1][j] + bv[1],
                      acc[2][j] + bv[2], acc[3][j] + bv[3]);
      *reinterpret_cast<float4*>(yp + (int64_t)j * Cout + 64) =
          make_float4(acc[4][j] + bv[4], acc[5][j] + bv[5],
                      acc[6][j] + bv[6], acc[7][j] + bv[7]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + (i < 4 ? cg * 4 + i : 60 + cg * 4 + i);
    float* yrow = y + (((int64_t)n * Cout + co) * H + oy) * W + ox;
    if (kLayout == kNchwVec && ox + 8 <= W) {
      *reinterpret_cast<float4*>(yrow) =
          make_float4(acc[i][0] + bv[i], acc[i][1] + bv[i],
                      acc[i][2] + bv[i], acc[i][3] + bv[i]);
      *reinterpret_cast<float4*>(yrow + 4) =
          make_float4(acc[i][4] + bv[i], acc[i][5] + bv[i],
                      acc[i][6] + bv[i], acc[i][7] + bv[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (ox + j < W) yrow[j] = acc[i][j] + bv[i];
    }
  }
}

template <int kLayout>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int N, int Cin, int H, int W, int Cout,
                   cudaStream_t stream) {
  static uint64_t configured = 0;  // devices whose shared-memory limit is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !((configured >> dev) & 1)) {
    e = cudaFuncSetAttribute(head_conv_fwd<kLayout>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return e;
    if (dev < 64) configured |= uint64_t(1) << dev;
  }
  const dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows,
                  N * (Cout / kCout));
  head_conv_fwd<kLayout><<<grid, kThreads, kSmemBytes, stream>>>(
      x, w, b, y, Cin, H, W, Cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [N, Cout, H, W] = conv3x3(x [N, Cin, H, W], w [Cout, Cin, 3, 3]) + b
// [Cout] (b may be null), stride 1, zero padding 1, all float32; w
// contiguous, x and y contiguous (nhwc = 0) or both channels-last (nhwc =
// 1, y 16-byte aligned); Cin a multiple of 8, Cout of 128. Returns
// cudaGetLastError() after the launch.
int dvd_head_conv_fwd(const float* x, const float* w, const float* b,
                      float* y, int N, int Cin, int H, int W, int Cout,
                      int nhwc, void* stream) {
  if (N < 0 || H < 0 || W < 0 || Cin <= 0 || Cin % kChunk != 0 ||
      Cout <= 0 || Cout % kCout != 0 || (int64_t)N * (Cout / kCout) > 65535 ||
      (H + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (nhwc) {
    if (((uintptr_t)y & 15) != 0) return (int)cudaErrorMisalignedAddress;
    return (int)launch<kNhwc>(x, w, b, y, N, Cin, H, W, Cout, st);
  }
  if (W % 4 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)y & 15) == 0)
    return (int)launch<kNchwVec>(x, w, b, y, N, Cin, H, W, Cout, st);
  return (int)launch<kNchw>(x, w, b, y, N, Cin, H, W, Cout, st);
}

}  // extern "C"
