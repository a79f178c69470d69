// Backward of the whole Euler chain of scene-flow field evaluations, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of dynamic_video_depth_tpu/ops/pallas/
// mlp_kernel.py::fused_mlp_embed_chain's backward (_chain_bwd,
// _bwd_chain_kernel). The forward stays the JAX split: one launch of the
// embedded-MLP forward (mlp_embed.cu) per evaluation plus the advects
//   sf_k = MLP(embed(p_k, t_k)) / sf_div,  p_{k+1} = p_k + sf_k,
//   t_{k+1} = t_k + dt,
// returning acc = sum of the first n_steps evaluations, f0 = sf_0 and
// f1 = sf_1, and stashing p_1 .. p_{K-1} (K = n_evals).
//
// The backward is BPTT with recompute. In reverse over the evaluations, for
// each point:
//   fbar = (pbar if k + 1 < K) + (gacc if k < n_steps) + (g0 if k == 0)
//          + (g1 if k == 1);  g = fbar / sf_div
// then eval k's activations are recomputed from the stashed p_k and from
// t_k, rebuilt by the forward's own sequential float adds (never
// t0 + k dt), the gradient walks back through the layers and the
// embedding, and the carries advance: ddt += tbar (the old tbar, which is
// the gradient at t_{k+1} = t_k + dt), pbar += d(p_k), tbar += d(t_k).
//
// One launch per evaluation. The TPU carried dW and db across its
// sequential grid; a CUDA grid runs in no order, so this is kernel B's
// scheme (b): chain_bwd_points writes eval k's layer inputs A_l and output
// gradients dZ_l to scratch (reused by every evaluation), mlp_dw_partial
// sums dZ_l^T A_l over S chunks of points, and mlp_dw_reduce adds the
// chunks in a fixed order onto the running dW_l, db_l (assigned at the
// first evaluation done, k = K - 1, added after that). No float atomics:
// the result is deterministic.
//
// What bounds it on the H100: arithmetic, as kernel B's backward, times K
// evaluations (about 153 GFLOP per evaluation at 86,016 points and the
// canonical widths: the recompute, dX and dW): 2.28 ms per evaluation at
// the 67 TFLOP/s of float32 FMAs, 0.93 ms on the tensor cores at float32
// accuracy (3xTF32 at 495 TFLOP/s); the per-point carries are 7 floats of
// device memory. The design runs on kernel B's tiles (mlp_tile.cuh):
// 3xTF32 warpgroup products (wgmma) on 128-point tiles, the weights packed
// once per backward and streamed through a TMA-fed ring; the dW pass is
// 3xTF32 mma.sync. It reaches 20-21% of the 3xTF32 bound at 86,016 points
// and 24.5% at 1,376,256 (PERF.md's kernel table): the point kernel is
// about 0.64 of the time and the dW pass, unchanged, 0.35. The shared
// memory per block is kernel B's; the tile's staged p_k, t_k sit in its
// activation rows' padding.

#include "mlp_tile.cuh"

namespace {

struct Chain {
  const float* p;     // p_k [N,3]
  const float* t0;    // [N]
  const float* dt;    // [N]
  const float* gacc;  // [N,3] cotangents of acc, f0, f1
  const float* g0;
  const float* g1;
  float* pbar;  // [N,3] carry: gradient at p_{k+1}, then at p_k
  float* tbar;  // [N]   carry: gradient at t_{k+1}, then at t_k
  float* ddt;   // [N]
  int k;
  int advanced;  // k + 1 < K: sf_k fed p_{k+1}
  int in_acc;    // k < n_steps
  float sf_div;
};

// The tile's p_k, t_k (x, y, z, t) sit in the padding columns of its rows
// of Xs, past every layer's width.
constexpr int kPkCol = kMaxWidth;

struct ChainEmbed {  // features of the staged p_k, t_k of row X
  const float* consts;
  int C0;
  __device__ float operator()(int64_t, const float* X, int c) const {
    const float* P = X + kPkCol;
    return embed_feature(consts, C0, c, P[0], P[1], P[2], P[3]);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    chain_bwd_points(const float* __restrict__ consts,
                     const __grid_constant__ Mlp m,
                     const __grid_constant__ Walk rec,
                     const __grid_constant__ Walk bw,
                     const __grid_constant__ Scratch s,
                     const __grid_constant__ Chain c, int N, int chunk) {
  extern __shared__ float4 smem[];
  Tile t = make_tile(smem);
  const Range r = block_range(N, chunk);
  if (producer(r.begin, r.end, rec, &bw, t.ring)) return;
  const int lane = threadIdx.x & 31;
  const int C0 = m.din[0], end = r.end;
  for (int p0 = r.begin; p0 < end; p0 += kTile) {
    const Place w = warp_place(t, p0, min(kTile, end - p0));
    if (lane < 16) {
      const int64_t gp = w.pw0 + lane;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, tk = 0.f;
      if (lane < w.rows) {
        x0 = c.p[3 * gp];
        x1 = c.p[3 * gp + 1];
        x2 = c.p[3 * gp + 2];
        tk = c.t0[gp];
        const float d = c.dt[gp];
        for (int j = 0; j < c.k; ++j) tk = __fadd_rn(tk, d);
      }
      float* P = w.Xw + lane * kLdx + kPkCol;
      P[0] = x0;
      P[1] = x1;
      P[2] = x2;
      P[3] = tk;
    }
    __syncwarp();
    feature_rows(C0, w.pw0, end, w.Xw, s.A[0], ChainEmbed{consts, C0});
    forward_layers(m, rec, w.Xw, w.Sw, t.ring, &s, nullptr, w.pw0, w.rows,
                   w.active);

    // dZ_{L-1} = g = fbar / sf_div (the field's output is 3 wide)
    load_grad(m, s, w.Xw, w.pw0, end, [&](int64_t gp, int n) {
      const int64_t i = 3 * gp + n;
      float f = c.advanced ? c.pbar[i] : 0.0f;
      if (c.in_acc) f = f + c.gacc[i];
      if (c.k == 0) f = f + c.g0[i];
      if (c.k == 1) f = f + c.g1[i];
      return f / c.sf_div;
    });
    backward_layers(m, bw, s, w.Xw, w.Sw, t.ring, w.pw0, w.rows, w.active);

    for (int half = 0; half < 2; ++half) {
      const int p = 8 * half + (lane >> 2), q = lane & 3;
      const int64_t gp = w.pw0 + p;
      const float* P = w.Xw + p * kLdx + kPkCol;
      float d[4];
      embed_grad(consts, C0, w.Xw + p * kLdx, q, P[0], P[1], P[2], P[3], d);
      if (q == 0 && p < w.rows) {
        const int64_t i = 3 * gp;
        if (c.advanced) {
          c.ddt[gp] = c.ddt[gp] + c.tbar[gp];
          c.pbar[i] = c.pbar[i] + d[0];
          c.pbar[i + 1] = c.pbar[i + 1] + d[1];
          c.pbar[i + 2] = c.pbar[i + 2] + d[2];
          c.tbar[gp] = c.tbar[gp] + d[3];
        } else {
          c.pbar[i] = d[0];
          c.pbar[i + 1] = d[1];
          c.pbar[i + 2] = d[2];
          c.tbar[gp] = d[3];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Gradients of the chain: dpts [N,3], dts [N], ddt [N] (zeroed here),
// dW[l], db[l]. pts [N,3], stash [K-1,N,3] (p_1..p_{K-1}), ts and dt [N];
// gacc, g0, g1 [N,3] are the cotangents of acc, f0 and f1. packed, A[l],
// dZ[l] and P are kernel B's backward scratch (dvd_mlp_bwd). The field's
// output must be 3 wide.
int dvd_chain_bwd(const float* pts, const float* stash, const float* ts,
                  const float* dt, const float* gacc, const float* g0,
                  const float* g1, const float* consts, const void* const* W,
                  const void* const* b, const int* dims, int L,
                  float* packed, int n_steps, int n_evals, float sf_div,
                  float* dpts, float* dts,
                  float* ddt, void* const* dW, void* const* db,
                  void* const* A, void* const* dZ, float* P, int S, int N,
                  void* stream) {
  Mlp m = make_mlp(W, b, dims, L);
  if (!valid(m, dims[0]) || dims[L] != 3 || S < 1 || n_evals < 1 ||
      n_steps < 0 || n_steps > n_evals)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)chain_bwd_points, kPointSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 0) return (int)zero_grads(dims, L, dW, db, st);
  e = pack_layers(m, packed, true, st);
  if (e != cudaSuccess) return (int)e;
  const Walk rec = forward_walk(m, L - 1), bw = backward_walk(m);
  e = cudaMemsetAsync(ddt, 0, sizeof(float) * N, st);
  if (e != cudaSuccess) return (int)e;
  Scratch s = make_scratch(A, dZ, L);
  Chain c = {};
  c.t0 = ts;
  c.dt = dt;
  c.gacc = gacc;
  c.g0 = g0;
  c.g1 = g1;
  c.pbar = dpts;
  c.tbar = dts;
  c.ddt = ddt;
  c.sf_div = sf_div;
  const int chunk = range_chunk(N);
  const unsigned grid = range_blocks(N, chunk);
  for (int k = n_evals - 1; k >= 0; --k) {
    c.k = k;
    c.p = k == 0 ? pts : stash + (int64_t)(k - 1) * N * 3;
    c.advanced = k + 1 < n_evals;
    c.in_acc = k < n_steps;
    chain_bwd_points<<<grid, kThreads, kPointSmem, st>>>(consts, m, rec, bw,
                                                         s, c, N, chunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = weight_grads(m, s, N, S, P, dW, db, k + 1 < n_evals, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
