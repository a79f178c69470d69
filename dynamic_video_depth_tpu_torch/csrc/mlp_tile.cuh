// Device code shared by the embedded scene-flow MLP kernels (mlp_embed.cu,
// kernel B) and the Euler-chain backward (mlp_chain.cu, kernel C).
//
// A block owns a tile of kTile points. Their activations live in shared
// memory (Xs, kTile x kLdx floats) and each layer's weights stream through
// shared memory (Ws) kChunk rows at a time; each of the kThreads threads
// holds a 4 x 16 output tile in registers. Everything is float32 FMAs on the
// CUDA cores (no tensor cores, so no TF32: the JAX oracle is float32).
//
// The weight gradient of a layer is dW = dZ^T A over all points. Instead of
// the TPU's sequential-grid carry it is split over S chunks of points into
// partial sums (mlp_dw_partial) and summed in a fixed order (mlp_dw_reduce):
// deterministic, no float atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;     // widest layer the tile holds
constexpr int kTile = 64;          // points per block
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kChunk = 32;         // weight rows staged per step
constexpr int kLdx = 272;          // activation row stride (bank-friendly)
constexpr int kLdw = kMaxWidth + 1;  // staged weight row stride
constexpr float kSlope = 0.2f;
constexpr size_t kPointSmem =
    sizeof(float) * (size_t)(kTile * kLdx + kChunk * kLdw);

struct Mlp {
  const float* W[kMaxLayers];  // [out, in]
  const float* b[kMaxLayers];  // [out]
  int din[kMaxLayers];
  int dout[kMaxLayers];
  int L;
};

struct Scratch {
  float* A[kMaxLayers];   // [N, din[l]]  layer inputs
  float* dZ[kMaxLayers];  // [N, dout[l]] gradients at layer outputs
};

// consts: 7 rows of C0 floats: fx[0], fx[1], fx[2], ft, raw, cos_m, sin_m.
__device__ __forceinline__ float embed_angle(const float* __restrict__ k,
                                             int C0, int c, float x0,
                                             float x1, float x2, float t) {
  float ang = t * k[3 * C0 + c];
  ang = ang + x0 * k[c];
  ang = ang + x1 * k[C0 + c];
  ang = ang + x2 * k[2 * C0 + c];
  return ang;
}

// Feature c of one point: raw * ang + cos_m * cos(ang) + sin_m * sin(ang).
__device__ __forceinline__ float embed_feature(const float* __restrict__ k,
                                               int C0, int c, float x0,
                                               float x1, float x2, float t) {
  const float ang = embed_angle(k, C0, c, x0, x1, x2, t);
  return k[4 * C0 + c] * ang + k[5 * C0 + c] * cosf(ang) +
         k[6 * C0 + c] * sinf(ang);
}

// acc[i][j] = sum_k Xs[ty + 16 i][k] * M(k, tx + 16 j) over k < K, n < N.
// kKN = false: M(k, n) = W[n * K + k] (torch [out, in]; the forward).
// kKN = true:  M(k, n) = W[k * N + n] (the same matrix read as [in, out]
//              transposed; the backward's dX = dZ W).
template <bool kKN>
__device__ void gemm_tile(const float* Xs, const float* __restrict__ W, int K,
                          int N, float* Ws, float acc[4][16]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk's readers are done
    if (kKN) {
      for (int e = tid; e < kc * N; e += kThreads) {
        int kk = e / N, n = e - kk * N;
        Ws[kk * kLdw + n] = W[(int64_t)(k0 + kk) * N + n];
      }
    } else {
      for (int e = tid; e < kChunk * N; e += kThreads) {
        int n = e / kChunk, kk = e - n * kChunk;
        if (kk < kc) Ws[kk * kLdw + n] = W[(int64_t)n * K + k0 + kk];
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(ty + 16 * i) * kLdx + k0 + kk];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = tx + 16 * j;
        const float w = n < N ? Ws[kk * kLdw + n] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }
}

// acc += bias, then leaky-relu unless this is the last layer.
__device__ __forceinline__ void bias_act(float acc[4][16],
                                         const float* __restrict__ b, int N,
                                         bool act) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = tx + 16 * j;
    const float bj = n < N ? b[n] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float z = acc[i][j] + bj;
      acc[i][j] = (act && !(z >= 0.0f)) ? kSlope * z : z;
    }
  }
}

// Xs[row][n] = acc for n < N; optionally also to global G[(p0+row)*N + n].
__device__ __forceinline__ void store_tile(const float acc[4][16], int N,
                                           float* Xs, float* G, int p0,
                                           int Npts) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = tx + 16 * j;
      if (n < N) {
        if (Xs) Xs[p * kLdx + n] = acc[i][j];
        if (G && p0 + p < Npts) G[(int64_t)(p0 + p) * N + n] = acc[i][j];
      }
    }
  }
}

// Forward recompute of a tile whose features are in Xs: stores every
// layer's input A_l to scratch and leaves the last hidden layer in Xs.
__device__ void forward_store(const Mlp& m, const Scratch& s, float* Xs,
                              float* Ws, int p0, int N) {
  const int C0 = m.din[0];
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * C0; e += kThreads) {
    int p = e / C0, c = e - p * C0;
    if (p0 + p < N) s.A[0][(int64_t)(p0 + p) * C0 + c] = Xs[p * kLdx + c];
  }
  float acc[4][16];
  for (int l = 0; l + 1 < m.L; ++l) {
    gemm_tile<false>(Xs, m.W[l], m.din[l], m.dout[l], Ws, acc);
    bias_act(acc, m.b[l], m.dout[l], true);
    __syncthreads();
    store_tile(acc, m.dout[l], Xs, s.A[l + 1], p0, N);
  }
  __syncthreads();
}

// Xs holds the gradient at the last layer's output; walk the layers back,
// storing each dZ_l (the leaky-relu mask is the sign of the stored
// activation: slope 0.2 > 0 keeps signs, and z = 0 gives 0 >= 0), and leave
// the gradient at the features in Xs.
__device__ void backward_store(const Mlp& m, const Scratch& s, float* Xs,
                               float* Ws, int p0, int N) {
  float acc[4][16];
  for (int l = m.L - 1; l >= 0; --l) {
    const int no = m.dout[l];
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * no; e += kThreads) {
      int p = e / no, n = e - p * no;
      const int gp = p0 + p;
      float dz = 0.0f;
      if (gp < N) {
        dz = Xs[p * kLdx + n];
        if (l + 1 < m.L && !(s.A[l + 1][(int64_t)gp * no + n] >= 0.0f))
          dz *= kSlope;
        s.dZ[l][(int64_t)gp * no + n] = dz;
      }
      Xs[p * kLdx + n] = dz;
    }
    gemm_tile<true>(Xs, m.W[l], no, m.din[l], Ws, acc);
    __syncthreads();
    store_tile(acc, m.din[l], Xs, nullptr, p0, N);
  }
  __syncthreads();
}

// Through the embedding: dang = (raw - cos_m sin(ang) + sin_m cos(ang)) g,
// then d(pts) and d(ts) of one point from the feature gradient row X. Four
// threads per point (q = 0..3 of an aligned quad of lanes), each a quarter
// of the columns, reduced across the quad; every lane gets the sums.
__device__ __forceinline__ void embed_grad(const float* __restrict__ k,
                                           int C0, const float* X, int q,
                                           float x0, float x1, float x2,
                                           float t, float d[4]) {
  float sx = 0.f, sy = 0.f, sz = 0.f, st = 0.f;
  for (int c = q; c < C0; c += 4) {
    const float ang = embed_angle(k, C0, c, x0, x1, x2, t);
    const float dang = (k[4 * C0 + c] - k[5 * C0 + c] * sinf(ang) +
                        k[6 * C0 + c] * cosf(ang)) *
                       X[c];
    sx += dang * k[c];
    sy += dang * k[C0 + c];
    sz += dang * k[2 * C0 + c];
    st += dang * k[3 * C0 + c];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
    sz += __shfl_xor_sync(0xffffffffu, sz, off);
    st += __shfl_xor_sync(0xffffffffu, st, off);
  }
  d[0] = sx;
  d[1] = sy;
  d[2] = sz;
  d[3] = st;
}

constexpr int kDwTile = 64;  // output tile (n x k) of the dW kernel
constexpr int kDwPts = 32;   // points staged per step

// P[s][n][k] = sum over the points of chunk s of dZ[p][n] * A'[p][k], where
// A'[p][k] = A[p][k] for k < K and 1 for k == K (the bias column).
__global__ void __launch_bounds__(kThreads)
    mlp_dw_partial(const float* __restrict__ dZ, const float* __restrict__ A,
                   int N, int Nout, int K, int chunk,
                   float* __restrict__ P) {
  __shared__ float Zs[kDwPts][kDwTile];
  __shared__ float As[kDwPts][kDwTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kDwTile, k0 = blockIdx.y * kDwTile;
  const int s = blockIdx.z;
  const int pb = s * chunk, pe = min(N, pb + chunk);
  float acc[4][4] = {};
  for (int p = pb; p < pe; p += kDwPts) {
    for (int e = tid; e < kDwPts * kDwTile; e += kThreads) {
      const int pp = e / kDwTile, c = e - pp * kDwTile;
      const int gp = p + pp;
      const bool in = gp < pe;
      const int n = n0 + c, kx = k0 + c;
      Zs[pp][c] = (in && n < Nout) ? dZ[(int64_t)gp * Nout + n] : 0.0f;
      As[pp][c] = !in ? 0.0f
                  : kx < K ? A[(int64_t)gp * K + kx]
                           : (kx == K ? 1.0f : 0.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < kDwPts; ++pp) {
      float z[4], a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) z[i] = Zs[pp][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = As[pp][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(z[i], a[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int K1 = K + 1;
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    for (int j = 0; j < 4; ++j) {
      const int kx = k0 + tx + 16 * j;
      if (n < Nout && kx < K1)
        P[((int64_t)s * Nout + n) * K1 + kx] = acc[i][j];
    }
  }
}

// sum = P[0][n][k] + ... + P[S-1][n][k] in that order; then dW[n][k]
// (k < K) or db[n] (k == K) = sum, or, with `accumulate`, its old value +
// sum.
__global__ void mlp_dw_reduce(const float* __restrict__ P, int S, int Nout,
                              int K, float* __restrict__ dW,
                              float* __restrict__ db, int accumulate) {
  const int K1 = K + 1;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)Nout * K1) return;
  const int n = (int)(idx / K1), kx = (int)(idx - (int64_t)n * K1);
  float sum = 0.0f;
  for (int s = 0; s < S; ++s) sum += P[((int64_t)s * Nout + n) * K1 + kx];
  float* dst = kx < K ? dW + (int64_t)n * K + kx : db + n;
  *dst = accumulate ? *dst + sum : sum;
}

// dW_l, db_l of every layer from the dZ_l, A_l in scratch: partial sums
// over S chunks of points, then the fixed-order reduce.
inline cudaError_t weight_grads(const Mlp& m, const Scratch& s, int N, int S,
                                float* P, void* const* dW, void* const* db,
                                int accumulate, cudaStream_t st) {
  const int chunk = (N + S - 1) / S;
  for (int l = 0; l < m.L; ++l) {
    const int K = m.din[l], Nout = m.dout[l];
    dim3 g2((Nout + kDwTile - 1) / kDwTile, (K + 1 + kDwTile - 1) / kDwTile,
            S);
    mlp_dw_partial<<<g2, kThreads, 0, st>>>(s.dZ[l], s.A[l], N, Nout, K,
                                            chunk, P);
    const int64_t outs = (int64_t)Nout * (K + 1);
    mlp_dw_reduce<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
        P, S, Nout, K, (float*)dW[l], (float*)db[l], accumulate);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

inline bool valid(const Mlp& m, int C0) {
  if (m.L < 1 || m.L > kMaxLayers || m.din[0] != C0) return false;
  for (int l = 0; l < m.L; ++l) {
    if (m.din[l] < 1 || m.din[l] > kMaxWidth || m.dout[l] < 1 ||
        m.dout[l] > kMaxWidth)
      return false;
    if (l > 0 && m.din[l] != m.dout[l - 1]) return false;
  }
  return true;
}

inline Mlp make_mlp(const void* const* W, const void* const* b,
                    const int* dims, int L) {
  Mlp m = {};
  m.L = L;
  for (int l = 0; l < L && l < kMaxLayers; ++l) {
    m.W[l] = (const float*)W[l];
    m.b[l] = (const float*)b[l];
    m.din[l] = dims[l];
    m.dout[l] = dims[l + 1];
  }
  return m;
}

inline Scratch make_scratch(void* const* A, void* const* dZ, int L) {
  Scratch s = {};
  for (int l = 0; l < L && l < kMaxLayers; ++l) {
    s.A[l] = (float*)A[l];
    s.dZ[l] = (float*)dZ[l];
  }
  return s;
}

// Zero dW_l and db_l (the gradients of an empty point set).
inline cudaError_t zero_grads(const int* dims, int L, void* const* dW,
                              void* const* db, cudaStream_t st) {
  for (int l = 0; l < L; ++l) {
    cudaMemsetAsync(dW[l], 0, sizeof(float) * dims[l] * dims[l + 1], st);
    cudaMemsetAsync(db[l], 0, sizeof(float) * dims[l + 1], st);
  }
  return cudaGetLastError();
}

}  // namespace
