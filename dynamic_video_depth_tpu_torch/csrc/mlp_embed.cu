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
// about 51 GFLOP of matrix products, so it is bound by arithmetic: 0.76 ms
// at the 67 TFLOP/s of float32 FMAs, or 0.31 ms on the tensor cores at
// float32 accuracy (3xTF32: three TF32 products per float32 product at 495
// TFLOP/s). The design (mlp_tile.cuh) takes the tensor cores: 3xTF32
// warpgroup products (wgmma) on 128-point tiles whose activations stay in
// shared memory, the weights packed once per launch (hi/lo split,
// zero-padded to multiples of 8) and streamed through a 4-slot ring by
// bulk async copies (TMA) across the layers. It reaches 23% of the 3xTF32
// bound at 86,016 points and 29% at 1,376,256 (the forward; the mma.sync
// tiles before it 20-22%, PERF.md's kernel table): each warpgroup waits
// for its products before it promotes them, so the tensor cores idle
// while the two warpgroups promote. The TPU kept all weights (about 1.2 MB)
// resident in VMEM; here every block streams them from L2 (2.4 MB packed
// per walk).
//
// Backward. The TPU summed dW and db across its sequential grid; a CUDA grid
// runs in no order, so that carry is replaced by a scheme that is
// deterministic and uses no float atomics:
//   1. mlp_bwd_points: per 128-point tile, recompute the forward, write each
//      layer's input activations A_l [N, pad8(in_l)] and output gradients
//      dZ_l [N, pad8(out_l)] to scratch (the padding zeros, so that every
//      copy is 16 bytes), and emit dpts [N,3] and dts [N,1] through the
//      embedding. The leaky-relu mask comes from the sign of the
//      pre-activation, read as the sign of the stored activation (slope 0.2
//      > 0 keeps signs, and z = 0 gives 0 >= 0, as _leaky_grad does).
//   2. mlp_dw_partial: dW_l = dZ_l^T A_l and db_l = sum dZ_l, split over
//      S chunks of points into partial sums (3xTF32 MMAs; db a column sum).
//   3. mlp_dw_reduce: sums the S partials in a fixed order.
// The scratch is about 2.7 kfloat per point (0.93 GB at 86,016 points),
// written once and read once: a floor of about 1.85 GB of traffic, 0.55 ms
// at 3.35 TB/s, per backward.
//
// The dense stack without the embedding (dvd_dense_fwd, dvd_dense_bwd)
// replaces mlp_kernel.py::fused_mlp (forward, _fwd_kernel) and
// _fused_mlp_bwd (_bwd_kernel): the same tiles and the same deterministic
// weight-gradient reduce, with the features read from feat [N, C0] and
// their gradient written to dfeat [N, C0].

#include "mlp_tile.cuh"

namespace {

struct Embed {
  const float* pts;     // [N,3]
  const float* ts;      // [N]
  const float* consts;  // [7, C0]
  int C0;
  __device__ float operator()(int64_t gp, const float*, int c) const {
    return embed_feature(consts, C0, c, pts[3 * gp], pts[3 * gp + 1],
                         pts[3 * gp + 2], ts[gp]);
  }
};

struct Rows {  // feature c of point gp from a row-major [N, C0] array
  const float* x;
  int C0;
  __device__ float operator()(int64_t gp, const float*, int c) const {
    return x[gp * C0 + c];
  }
};

// The forward of every tile of this block's range.
template <typename Feature>
__device__ __forceinline__ void forward_tiles(const Mlp& m, const Walk& fw,
                                              Feature feature, float* out,
                                              int N, int chunk) {
  extern __shared__ float4 smem[];
  Tile t = make_tile(smem);
  const Range r = block_range(N, chunk);
  if (producer(r.begin, r.end, fw, nullptr, t.ring)) return;
  for (int p0 = r.begin; p0 < r.end; p0 += kTile) {
    const Place w = warp_place(t, p0, min(kTile, r.end - p0));
    feature_rows(m.din[0], w.pw0, r.end, w.Xw, nullptr, feature);
    forward_layers(m, fw, w.Xw, w.Sw, t.ring, nullptr, out, w.pw0, w.rows,
                   w.active);
  }
}

// For this warp's rows of a tile of a range ending at `end`: recompute
// (storing A_l), then walk back from dZ_{L-1} = grad(gp, n); leaves the
// gradient at the features in the warp's rows of Xs.
template <typename Feature, typename Grad>
__device__ __forceinline__ void backward_rows(const Mlp& m, const Walk& rec,
                                              const Walk& bw,
                                              const Scratch& s,
                                              const Place& w, Ring& ring,
                                              Feature feature, Grad grad,
                                              int end) {
  feature_rows(m.din[0], w.pw0, end, w.Xw, s.A[0], feature);
  forward_layers(m, rec, w.Xw, w.Sw, ring, &s, nullptr, w.pw0, w.rows,
                 w.active);
  load_grad(m, s, w.Xw, w.pw0, end, grad);
  backward_layers(m, bw, s, w.Xw, w.Sw, ring, w.pw0, w.rows, w.active);
}

__global__ void __launch_bounds__(kThreads, 1)
    mlp_fwd(const float* __restrict__ pts, const float* __restrict__ ts,
            const float* __restrict__ consts, const __grid_constant__ Mlp m,
            const __grid_constant__ Walk fw, float* __restrict__ out,
            int N, int chunk) {
  forward_tiles(m, fw, Embed{pts, ts, consts, m.din[0]}, out, N, chunk);
}

__global__ void __launch_bounds__(kThreads, 1)
    mlp_bwd_points(const float* __restrict__ pts,
                   const float* __restrict__ ts,
                   const float* __restrict__ consts,
                   const __grid_constant__ Mlp m,
                   const __grid_constant__ Walk rec,
                   const __grid_constant__ Walk bw,
                   const __grid_constant__ Scratch s,
                   const float* __restrict__ g, float* __restrict__ dpts,
                   float* __restrict__ dts, int N, int chunk) {
  extern __shared__ float4 smem[];
  Tile t = make_tile(smem);
  const Range r = block_range(N, chunk);
  if (producer(r.begin, r.end, rec, &bw, t.ring)) return;
  const int C0 = m.din[0], no = m.dout[m.L - 1];
  const int lane = threadIdx.x & 31;
  for (int p0 = r.begin; p0 < r.end; p0 += kTile) {
    const Place w = warp_place(t, p0, min(kTile, r.end - p0));
    backward_rows(
        m, rec, bw, s, w, t.ring, Embed{pts, ts, consts, C0},
        [&](int64_t gp, int n) { return g[gp * no + n]; }, r.end);
    for (int half = 0; half < 2; ++half) {
      const int p = 8 * half + (lane >> 2), q = lane & 3;
      const int64_t gp = w.pw0 + p;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, tt = 0.f;
      if (p < w.rows) {
        x0 = pts[3 * gp];
        x1 = pts[3 * gp + 1];
        x2 = pts[3 * gp + 2];
        tt = ts[gp];
      }
      float d[4];
      embed_grad(consts, C0, w.Xw + p * kLdx, q, x0, x1, x2, tt, d);
      if (q == 0 && p < w.rows) {
        dpts[3 * gp] = d[0];
        dpts[3 * gp + 1] = d[1];
        dpts[3 * gp + 2] = d[2];
        dts[gp] = d[3];
      }
    }
  }
}

// The dense stack alone (fused_mlp): the same tiles with the features read
// from feat [N, C0] instead of computed from the embedding.
__global__ void __launch_bounds__(kThreads, 1)
    dense_fwd(const float* __restrict__ feat, const __grid_constant__ Mlp m,
              const __grid_constant__ Walk fw, float* __restrict__ out,
              int N, int chunk) {
  forward_tiles(m, fw, Rows{feat, m.din[0]}, out, N, chunk);
}

// Per 128-point tile: recompute, store A_l and dZ_l for the weight
// gradients, and write dfeat (the gradient left in Xs).
__global__ void __launch_bounds__(kThreads, 1)
    dense_bwd_points(const float* __restrict__ feat,
                     const __grid_constant__ Mlp m,
                     const __grid_constant__ Walk rec,
                     const __grid_constant__ Walk bw,
                     const __grid_constant__ Scratch s,
                     const float* __restrict__ g, float* __restrict__ dfeat,
                     int N, int chunk) {
  extern __shared__ float4 smem[];
  Tile t = make_tile(smem);
  const Range r = block_range(N, chunk);
  if (producer(r.begin, r.end, rec, &bw, t.ring)) return;
  const int C0 = m.din[0], no = m.dout[m.L - 1];
  for (int p0 = r.begin; p0 < r.end; p0 += kTile) {
    const Place w = warp_place(t, p0, min(kTile, r.end - p0));
    backward_rows(
        m, rec, bw, s, w, t.ring, Rows{feat, C0},
        [&](int64_t gp, int n) { return g[gp * no + n]; }, r.end);
    for (int e = threadIdx.x & 31; e < w.rows * C0; e += 32) {
      const int p = e / C0, c = e - p * C0;
      dfeat[(w.pw0 + p) * C0 + c] = w.Xw[p * kLdx + c];
    }
  }
}

}  // namespace

extern "C" {

// out [N, dims[L]] = MLP(embed(pts [N,3], ts [N,1])). W[l] is [dims[l+1],
// dims[l]], b[l] is [dims[l+1]]; consts is [7, dims[0]]; packed is scratch
// for the forward's packed weights: 2 pad8(dims[l]) pad8(dims[l+1]) floats
// per layer (pad8 rounds up to a multiple of 8).
int dvd_mlp_fwd(const float* pts, const float* ts, const float* consts,
                const void* const* W, const void* const* b, const int* dims,
                int L, float* packed, float* out, int N, void* stream) {
  Mlp m = make_mlp(W, b, dims, L);
  if (!valid(m, dims[0])) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)mlp_fwd, kPointSmem);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  e = pack_layers(m, packed, false, st);
  if (e != cudaSuccess) return (int)e;
  const int chunk = range_chunk(N);
  mlp_fwd<<<range_blocks(N, chunk), kThreads, kPointSmem, st>>>(
      pts, ts, consts, m, forward_walk(m, L), out, N, chunk);
  return (int)cudaGetLastError();
}

// Gradients of sum(g * out): dpts [N,3], dts [N,1], dW[l], db[l]. A[l] and
// dZ[l] are scratch of N x pad8(dims[l]) and N x pad8(dims[l+1]) floats; P
// is scratch of S x max_l(dims[l+1] x (dims[l] + 1)) floats; packed of
// twice the forward's (both operands).
int dvd_mlp_bwd(const float* pts, const float* ts, const float* consts,
                const void* const* W, const void* const* b, const int* dims,
                int L, float* packed, const float* g, float* dpts,
                float* dts, void* const* dW, void* const* db, void* const* A,
                void* const* dZ, float* P, int S, int N, void* stream) {
  Mlp m = make_mlp(W, b, dims, L);
  if (!valid(m, dims[0]) || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)mlp_bwd_points, kPointSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) return (int)zero_grads(dims, L, dW, db, st);
  e = pack_layers(m, packed, true, st);
  if (e != cudaSuccess) return (int)e;
  Scratch s = make_scratch(A, dZ, L);
  const int chunk = range_chunk(N);
  mlp_bwd_points<<<range_blocks(N, chunk), kThreads, kPointSmem, st>>>(
      pts, ts, consts, m, forward_walk(m, L - 1), backward_walk(m), s, g,
      dpts, dts, N, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)weight_grads(m, s, N, S, P, dW, db, 0, st);
}

// out [N, dims[L]] = MLP(feat [N, dims[0]]), the layers as dvd_mlp_fwd.
int dvd_dense_fwd(const float* feat, const void* const* W,
                  const void* const* b, const int* dims, int L,
                  float* packed, float* out, int N, void* stream) {
  Mlp m = make_mlp(W, b, dims, L);
  if (!valid(m, dims[0])) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)dense_fwd, kPointSmem);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  e = pack_layers(m, packed, false, st);
  if (e != cudaSuccess) return (int)e;
  const int chunk = range_chunk(N);
  dense_fwd<<<range_blocks(N, chunk), kThreads, kPointSmem, st>>>(
      feat, m, forward_walk(m, L), out, N, chunk);
  return (int)cudaGetLastError();
}

// Gradients of sum(g * out): dfeat [N, dims[0]], dW[l], db[l]; the scratch
// as dvd_mlp_bwd.
int dvd_dense_bwd(const float* feat, const void* const* W,
                  const void* const* b, const int* dims, int L,
                  float* packed, const float* g, float* dfeat,
                  void* const* dW, void* const* db, void* const* A,
                  void* const* dZ, float* P, int S, int N, void* stream) {
  Mlp m = make_mlp(W, b, dims, L);
  if (!valid(m, dims[0]) || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)dense_bwd_points, kPointSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) return (int)zero_grads(dims, L, dW, db, st);
  e = pack_layers(m, packed, true, st);
  if (e != cudaSuccess) return (int)e;
  Scratch s = make_scratch(A, dZ, L);
  const int chunk = range_chunk(N);
  dense_bwd_points<<<range_blocks(N, chunk), kThreads, kPointSmem, st>>>(
      feat, m, forward_walk(m, L - 1), backward_walk(m), s, g, dfeat, N,
      chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)weight_grads(m, s, N, S, P, dW, db, 0, st);
}

}  // extern "C"
