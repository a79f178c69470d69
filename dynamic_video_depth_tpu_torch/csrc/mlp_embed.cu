// Fourier-embedded scene-flow MLP, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dynamic_video_depth_tpu/ops/pallas/
// mlp_kernel.py::fused_mlp_embed (forward, _fwd_embed_kernel) and
// _fused_mlp_embed_bwd (_bwd_embed_kernel). Per point:
//   ang  = ts * ft + pts[0] * fx[0] + pts[1] * fx[1] + pts[2] * fx[2]
//   feat = raw * ang + cos_m * cos(ang) + sin_m * sin(ang)     (C0 = 132)
//   h    = leaky_0.2(h W_l^T + b_l) for every layer but the last (no act.)
// with the canonical widths 132 -> 256 -> 256 x4 -> 3. Weights are in the
// torch Linear layout [out, in].
//
// What bounds it on the H100. One evaluation at 224x384 (86,016 points) is
// about 51 GFLOP; everything runs as float32 FMAs on the CUDA cores (no
// tensor cores, so no TF32: the JAX oracle is float32), which makes it
// compute-bound on the FMA pipes (67 TFLOP/s peak). The TPU kept all weights
// (about 1.2 MB) resident in VMEM; a block here has at most 227 KB of shared
// memory, so each block keeps one tile of 64 points' activations in shared
// memory (64 x 256 floats) and streams each layer's weights through shared
// memory 32 rows at a time. Each of 256 threads holds a 4 x 16 output tile
// in registers.
//
// Backward. The TPU summed dW and db across its sequential grid; a CUDA grid
// runs in no order, so that carry is replaced by scheme (b), which is
// deterministic and uses no float atomics:
//   1. mlp_bwd_points: per 64-point tile, recompute the forward, write each
//      layer's input activations A_l [N, in_l] and output gradients dZ_l
//      [N, out_l] to scratch, and emit dpts [N,3] and dts [N,1] through the
//      embedding. The leaky-relu mask comes from the sign of the
//      pre-activation, read as the sign of the stored activation (slope 0.2
//      > 0 keeps signs, and z = 0 gives 0 >= 0, as _leaky_grad does).
//   2. mlp_dw_partial: dW_l = dZ_l^T A_l and db_l = sum dZ_l, split over
//      S chunks of points into partial sums (db is the column of a virtual
//      all-ones activation).
//   3. mlp_dw_reduce: sums the S partials in a fixed order.
// The scratch is about 2.7 kfloat per point (0.93 GB at 86,016 points).
// The tile code (GEMM tiles, forward recompute, layer backward, embedding
// gradient, dW partials and reduce) is shared with the chain backward
// (mlp_chain.cu) through mlp_tile.cuh.

#include "mlp_tile.cuh"

namespace {

// Xs[p][c] = feat of point p0 + p (zero past N).
__device__ void embed_tile(const float* __restrict__ pts,
                           const float* __restrict__ ts,
                           const float* __restrict__ k, int C0, int p0, int N,
                           float* Xs) {
  for (int e = threadIdx.x; e < kTile * C0; e += kThreads) {
    int p = e / C0, c = e - p * C0;
    int gp = p0 + p;
    float f = 0.0f;
    if (gp < N)
      f = embed_feature(k, C0, c, pts[3 * (int64_t)gp],
                        pts[3 * (int64_t)gp + 1], pts[3 * (int64_t)gp + 2],
                        ts[gp]);
    Xs[p * kLdx + c] = f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    mlp_fwd(const float* __restrict__ pts, const float* __restrict__ ts,
            const float* __restrict__ consts, int C0, Mlp m,
            float* __restrict__ out, int N) {
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Ws = smem + kTile * kLdx;
  const int p0 = blockIdx.x * kTile;
  embed_tile(pts, ts, consts, C0, p0, N, Xs);
  float acc[4][16];
  for (int l = 0; l < m.L; ++l) {
    const bool last = l == m.L - 1;
    gemm_tile<false>(Xs, m.W[l], m.din[l], m.dout[l], Ws, acc);
    bias_act(acc, m.b[l], m.dout[l], !last);
    __syncthreads();  // every thread is done reading Xs
    store_tile(acc, m.dout[l], last ? nullptr : Xs, last ? out : nullptr, p0,
               N);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    mlp_bwd_points(const float* __restrict__ pts,
                   const float* __restrict__ ts,
                   const float* __restrict__ consts, int C0, Mlp m,
                   Scratch s, const float* __restrict__ g,
                   float* __restrict__ dpts, float* __restrict__ dts, int N) {
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Ws = smem + kTile * kLdx;
  const int p0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;

  embed_tile(pts, ts, consts, C0, p0, N, Xs);
  forward_store(m, s, Xs, Ws, p0, N);

  // Xs <- g, then walk the layers back
  const int dl = m.dout[m.L - 1];
  for (int e = tid; e < kTile * dl; e += kThreads) {
    int p = e / dl, n = e - p * dl;
    Xs[p * kLdx + n] = p0 + p < N ? g[(int64_t)(p0 + p) * dl + n] : 0.0f;
  }
  backward_store(m, s, Xs, Ws, p0, N);

  const int p = tid >> 2, q = tid & 3;
  const int gp = p0 + p;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, t = 0.f;
  if (gp < N) {
    x0 = pts[3 * (int64_t)gp];
    x1 = pts[3 * (int64_t)gp + 1];
    x2 = pts[3 * (int64_t)gp + 2];
    t = ts[gp];
  }
  float d[4];
  embed_grad(consts, C0, Xs + p * kLdx, q, x0, x1, x2, t, d);
  if (q == 0 && gp < N) {
    dpts[3 * (int64_t)gp] = d[0];
    dpts[3 * (int64_t)gp + 1] = d[1];
    dpts[3 * (int64_t)gp + 2] = d[2];
    dts[gp] = d[3];
  }
}

// The point kernels take more than the default 48 KB of dynamic shared
// memory; the attribute is per device, so it is set before every launch.
cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      mlp_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPointSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(mlp_bwd_points,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kPointSmem);
}

}  // namespace

extern "C" {

// out [N, dims[L]] = MLP(embed(pts [N,3], ts [N,1])). W[l] is [dims[l+1],
// dims[l]], b[l] is [dims[l+1]]; consts is [7, dims[0]].
int dvd_mlp_fwd(const float* pts, const float* ts, const float* consts,
                const void* const* W, const void* const* b, const int* dims,
                int L, float* out, int N, void* stream) {
  Mlp m = make_mlp(W, b, dims, L);
  if (!valid(m, dims[0])) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((N + kTile - 1) / kTile);
  mlp_fwd<<<grid, kThreads, kPointSmem, (cudaStream_t)stream>>>(
      pts, ts, consts, dims[0], m, out, N);
  return (int)cudaGetLastError();
}

// Gradients of sum(g * out): dpts [N,3], dts [N,1], dW[l], db[l]. A[l] and
// dZ[l] are scratch of N x dims[l] and N x dims[l+1] floats; P is scratch of
// S x max_l(dims[l+1] x (dims[l] + 1)) floats.
int dvd_mlp_bwd(const float* pts, const float* ts, const float* consts,
                const void* const* W, const void* const* b, const int* dims,
                int L, const float* g, float* dpts, float* dts,
                void* const* dW, void* const* db, void* const* A,
                void* const* dZ, float* P, int S, int N, void* stream) {
  Mlp m = make_mlp(W, b, dims, L);
  if (!valid(m, dims[0]) || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) return (int)zero_grads(dims, L, dW, db, st);
  Scratch s = make_scratch(A, dZ, L);
  const unsigned grid = (unsigned)((N + kTile - 1) / kTile);
  mlp_bwd_points<<<grid, kThreads, kPointSmem, st>>>(
      pts, ts, consts, dims[0], m, s, g, dpts, dts, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)weight_grads(m, s, N, S, P, dW, db, 0, st);
}

}  // extern "C"
