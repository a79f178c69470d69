// Device code shared by the embedded scene-flow MLP kernels (mlp_embed.cu,
// kernel B, and the dense stack of fused_mlp) and the Euler-chain backward
// (mlp_chain.cu, kernel C): a tensor-core tile GEMM at float32 accuracy.
//
// Arithmetic: 3xTF32. Each float32 operand x is split into
//   hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi)
// and a product is hi*hi + hi*lo + lo*hi (the small products first). The
// lost lo*lo term is below float32's rounding, so the stack keeps the JAX
// package's float32 parity; a single TF32 product would not
// (tests/test_torch_kernels.py emulates both). The conversion is explicit:
// an MMA fed raw float32 bits would truncate them to TF32. The tensor cores
// also add into their accumulator by truncation, which biases a long run of
// MMAs on one accumulator; so each k8 step's products go to a zeroed
// accumulator and reach the running sum by one rounded float32 add.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, the warp
// MMA, which runs on Hopper's tensor cores. Not wgmma: wgmma takes TF32
// only with both operands K-major in shared memory, while the backward's
// dX = dZ W and dW = dZ^T A read their operands transposed; mma.sync takes
// its fragments from registers, loaded from shared memory in any layout.
//
// Point kernels: one block of 16 warps per SM walks a contiguous range of
// points in tiles of kTile = 128 (2 row halves x 8 column groups, each
// warp a 64 x 32 output tile: 4 x 4 MMA tiles, 64 float32 accumulators a
// thread; the last, ragged tile skips its empty m-tiles). The tile's
// activations stay in shared memory (Xs, float32, split when a fragment is
// loaded). The weights are packed once per launch (pack_weights): split
// into hi/lo, zero-padded to multiples of 8 (K = 132 -> 136 for the
// features, N = 3 -> 8 for the field's output), and laid out in the MMA's
// per-lane B-fragment order, so one 16-byte shared load gives a lane hi and
// lo of both its B values. A walk over the layers streams them through a
// ring of kStages slots in shared memory (one k8 step of up to 256
// columns, 16 KB, per slot) by bulk async copies (TMA, issued by one
// thread, completing on mbarriers), a pair of steps ahead and across layer
// boundaries, so the next pair loads while the current one is multiplied.
// The forward packs each layer as [out][in] (F), the backward also
// transposed (G). Scratch (A_l, dZ_l) has the tile's padded widths (pad8,
// the padding zeros) and leaves shared memory by coalesced 16-byte copies
// after each layer; the backward's leaky-relu mask is applied in the same
// pass.
//
// The weight gradient of a layer is dW = dZ^T A over all points. Instead of
// the TPU's sequential-grid carry it is split over S chunks of points into
// partial sums (mlp_dw_partial, the same 3xTF32 MMA on 128 x 128 output
// tiles, the bias a column sum in point order) and summed in a fixed order
// (mlp_dw_reduce): deterministic, no float atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;   // widest layer the tile holds
constexpr int kTile = 128;       // points per block
constexpr int kThreads = 512;    // 16 warps: 2 (rows) x 8 (columns)
constexpr int kLdx = 260;        // activation row stride: = 4 mod 32, so an
                                 // A fragment's 32 loads hit 32 banks
constexpr int kStages = 4;       // weight ring slots: two pairs of steps
constexpr int kStageF4 = kMaxWidth * 4;  // one k8 step: 8 x 256 x (hi, lo)
constexpr float kSlope = 0.2f;
// the ring's slots, the activation tile, the ring's two mbarriers
constexpr size_t kPointSmem = sizeof(float4) * kStages * kStageF4 +
                              sizeof(float) * kTile * kLdx +
                              2 * sizeof(uint64_t);

__host__ __device__ __forceinline__ int pad8(int x) { return (x + 7) & ~7; }

struct Mlp {
  const float* W[kMaxLayers];   // [out, in]
  const float* b[kMaxLayers];   // [out]
  const float4* F[kMaxLayers];  // packed W (reduction over in)
  const float4* G[kMaxLayers];  // packed W^T (reduction over out)
  int din[kMaxLayers];
  int dout[kMaxLayers];
  int L;
};

// The packed operands of a walk over the layers, in walk order: layer i
// takes global steps first[i] .. first[i+1] - 1 (one k8 step each) and has
// cols[i] (padded) output columns.
struct Walk {
  const float4* B[kMaxLayers];
  int first[kMaxLayers + 1];
  int cols[kMaxLayers];
  int n;
};

struct Scratch {
  float* A[kMaxLayers];   // [N, pad8(din[l])]  layer inputs
  float* dZ[kMaxLayers];  // [N, pad8(dout[l])] gradients at layer outputs
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[nt] += a b[nt] at float32 accuracy for the n-tiles nt < my; b =
// (hi b0, hi b1, lo b0, lo b1). The tensor cores accumulate by truncation,
// which biases a long run of MMAs on one accumulator; so each step's three
// products go to zeroed accumulators (the n-tiles interleaved, for
// independent MMAs in flight) and reach c by one rounded float32 add.
__device__ __forceinline__ void mma3(float c[4][4], const uint32_t ah[4],
                                     const uint32_t al[4], const float4 b[4],
                                     int my) {
  float t[4][4] = {};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    if (nt < my) mma(t[nt], al, __float_as_uint(b[nt].x),
                     __float_as_uint(b[nt].y));
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    if (nt < my) mma(t[nt], ah, __float_as_uint(b[nt].z),
                     __float_as_uint(b[nt].w));
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    if (nt < my) mma(t[nt], ah, __float_as_uint(b[nt].x),
                     __float_as_uint(b[nt].y));
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] += t[nt][e];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The weight ring: kStages slots of one k8 step each, filled a pair of
// steps at a time by bulk async copies (the TMA engine) that complete on
// an mbarrier. Pairs are numbered in issue order over the whole kernel;
// pair number s completes on bar[s & 1], its (s >> 1)-th phase. Every
// thread keeps the same numbers (q0: the current walk's first pair).
struct Ring {
  float4* slot;
  uint64_t* bar;  // two mbarriers in shared memory
  int q0, next;
};

// Initialise the barriers (one arrival each: the issuing thread's); ends
// past a barrier.
__device__ __forceinline__ Ring make_ring(float4* slots, uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(bar + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return Ring{slots, bar, 0, 0};
}

// Issue global steps 2j and 2j + 1 of the walk (nothing past its end): one
// thread arms the pair's barrier with their byte count (an empty pair
// completes at once) and starts one bulk copy per step into its slot.
// Every thread calls it, so that all count the pairs alike. The caller
// guarantees that no thread still reads those slots.
__device__ __forceinline__ void issue_pair(const Walk& w, int j, Ring& r) {
  const int s = r.next++;
  if (threadIdx.x != 0) return;
  const unsigned bar = smem_addr(r.bar + (s & 1));
  const float4* src[2];
  unsigned dst[2], bytes[2] = {0u, 0u};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = 2 * j + h;
    if (g >= w.first[w.n]) break;
    int i = 0;
    while (g >= w.first[i + 1]) ++i;
    const int count = w.cols[i] * 4;  // float4s
    src[h] = w.B[i] + (int64_t)(g - w.first[i]) * count;
    dst[h] = smem_addr(r.slot + (g % kStages) * kStageF4);
    bytes[h] = 16u * count;
  }
  // the slots' last reads were generic-proxy loads; order them before the
  // async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes[0] + bytes[1])
               : "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (bytes[h])
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(dst[h]),
          "l"(src[h]), "r"(bytes[h]), "r"(bar)
          : "memory");
}

// Wait until pair j of the current walk has landed.
__device__ __forceinline__ void wait_pair(const Ring& r, int j) {
  const int s = r.q0 + j;
  const unsigned bar = smem_addr(r.bar + (s & 1)), parity = (s >> 1) & 1;
  uint32_t done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The walk's first pair of steps. The caller guarantees that no thread
// still reads the ring.
__device__ __forceinline__ void start_walk(const Walk& w, Ring& r) {
  r.q0 = r.next;
  issue_pair(w, 0, r);
}

// The n-tiles (8 columns each) of this warp that a layer of `cols` padded
// columns has: its first tile and how many (0..4), the same for the warp.
__device__ __forceinline__ int warp_tiles(int cols, int& nt0) {
  nt0 = (threadIdx.x >> 6) * 4;
  return max(0, min(4, cols / 8 - nt0));
}

// acc = Xs . B over layer i of the walk, B(c, r) the packed operand: this
// warp's rows 64 (warp & 1) + 16 mt + .. for mt < mts (the m-tiles with
// points; the rest stay 0), columns 8 (nt0 + nt) + ... The
// ring holds two pairs of steps. Each even step waits for its pair, then
// (past a barrier every thread crosses) issues the next pair into the
// slots the last pair freed; so the next pair loads while this one is
// multiplied, with one barrier per two steps. Xs must be complete and
// visible on entry.
__device__ __forceinline__ void walk_layer(const Walk& w, int i,
                                           const float* Xs, Ring& ring,
                                           float acc[4][4][4], int mts) {
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 1) * 64 + (lane >> 2);
  int nt0;
  const int my = warp_tiles(w.cols[i], nt0);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  for (int g = w.first[i]; g < w.first[i + 1]; ++g) {
    if ((g & 1) == 0) {
      wait_pair(ring, g / 2);
      __syncthreads();
      issue_pair(w, g / 2 + 1, ring);
    }
    if (my == 0 || mts == 0) continue;
    const float4* S = ring.slot + (g % kStages) * kStageF4;
    const int k0 = 8 * (g - w.first[i]) + (lane & 3);
    float4 b[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      b[nt] = nt < my ? S[(nt0 + nt) * 32 + lane]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    // the next m-tile's A values load while this one's MMAs run
    const float* x = Xs + row0 * kLdx + k0;
    float xr[4] = {x[0], x[8 * kLdx], x[4], x[8 * kLdx + 4]};
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mts) break;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(xr[e], ah[e], al[e]);
      if (mt + 1 < mts) {
        x += 16 * kLdx;
        xr[0] = x[0];
        xr[1] = x[8 * kLdx];
        xr[2] = x[4];
        xr[3] = x[8 * kLdx + 4];
      }
      mma3(acc[mt], ah, al, b, my);
    }
  }
}

// Calls f(row, col, value) for each accumulator of this warp's valid tiles
// (row in the tile, col < the layer's padded width).
template <typename Fn>
__device__ __forceinline__ void for_each_acc(int cols, float acc[4][4][4],
                                             Fn f) {
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 1) * 64 + (lane >> 2);
  int nt0;
  const int my = warp_tiles(cols, nt0);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (nt < my)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(row0 + 16 * mt + 8 * (e >> 1),
            8 * (nt0 + nt) + 2 * (lane & 3) + (e & 1), acc[mt][nt][e]);
}

// f(x, e) over the tile's first `rows` rows and `width` (a multiple of 8)
// columns, four consecutive elements x of Xs per call: e indexes float4s
// of the row-major [rows, width] block that starts the tile's rows in a
// global [N, width] array (coalesced).
template <typename F4>
__device__ __forceinline__ void tile_rows(float* Xs, int rows, int width,
                                          F4 f4) {
  const int w4 = width >> 2;
  for (int e = threadIdx.x; e < rows * w4; e += kThreads) {
    const int p = e / w4, c = 4 * (e - p * w4);
    f4(*(float4*)(Xs + p * kLdx + c), e);
  }
}

// The forward over the layers of walk fw (layer l of the walk is layer l
// of m) on the tile in Xs (complete and visible; rows valid rows, mts of
// them this warp's m-tiles). Hidden layers: bias and leaky-relu, back into
// Xs (zeros in the padded columns) and, given scratch, copied from there
// to A[l + 1] with the padding (coalesced). The last layer of m: bias, to
// out [N, dout]. Each layer ends past a barrier.
__device__ __forceinline__ void forward_layers(const Mlp& m, const Walk& fw,
                                               float* Xs, Ring& ring,
                                               const Scratch* s, float* out,
                                               int p0, int rows, int mts) {
  float acc[4][4][4];
  for (int l = 0; l < fw.n; ++l) {
    walk_layer(fw, l, Xs, ring, acc, mts);
    __syncthreads();  // every warp is done reading Xs
    const int no = m.dout[l];
    const float* __restrict__ b = m.b[l];
    if (l == m.L - 1) {
      for_each_acc(fw.cols[l], acc, [&](int r, int c, float v) {
        if (c < no && r < rows) out[(int64_t)(p0 + r) * no + c] = v + b[c];
      });
      __syncthreads();
      continue;
    }
    for_each_acc(fw.cols[l], acc, [&](int r, int c, float v) {
      float z = c < no ? v + b[c] : 0.0f;
      Xs[r * kLdx + c] = z >= 0.0f ? z : kSlope * z;
    });
    __syncthreads();
    if (s) {
      float4* A = (float4*)(s->A[l + 1] + (int64_t)p0 * pad8(no));
      tile_rows(Xs, rows, pad8(no), [&](float4& x, int e) { A[e] = x; });
    }
  }
}

// The leaky-relu gradient, its mask the sign of the stored activation a
// (slope 0.2 > 0 keeps signs, and z = 0 gives 0 >= 0, as _leaky_grad does).
__device__ __forceinline__ float leaky_grad(float v, float a) {
  return a >= 0.0f ? v : kSlope * v;
}

// Xs holds dZ_{L-1}, the gradient at the last layer's output (zero-padded
// to 8 columns). Walk the layers back over bw (walk layer i is layer
// L - 1 - i): dX = dZ_l W_l into Xs, then for l > 0 one coalesced pass
// reads A_l and turns Xs into dZ_{l-1} = dX * leaky'(A_l), stored to
// scratch too; leaves the gradient at the features in Xs, past a barrier.
__device__ __forceinline__ void backward_layers(const Mlp& m, const Walk& bw,
                                                const Scratch& s, float* Xs,
                                                Ring& ring, int p0,
                                                int rows, int mts) {
  float acc[4][4][4];
  for (int i = 0; i < bw.n; ++i) {
    const int l = m.L - 1 - i;
    walk_layer(bw, i, Xs, ring, acc, mts);
    __syncthreads();
    for_each_acc(bw.cols[i], acc, [&](int r, int c, float v) {
      Xs[r * kLdx + c] = v;
    });
    __syncthreads();
    if (l == 0) break;
    const int ni = pad8(m.din[l]);
    const float4* A = (const float4*)(s.A[l] + (int64_t)p0 * ni);
    float4* dZ = (float4*)(s.dZ[l - 1] + (int64_t)p0 * ni);
    tile_rows(Xs, rows, ni, [&](float4& x, int e) {
      const float4 a = A[e];
      x = make_float4(leaky_grad(x.x, a.x), leaky_grad(x.y, a.y),
                      leaky_grad(x.z, a.z), leaky_grad(x.w, a.w));
      dZ[e] = x;
    });
    __syncthreads();
  }
}

// Points are split into one contiguous range per block (a multiple of 16
// points, one block per SM), walked in tiles of kTile; only the last tile
// of a range is ragged, and its warps skip the 16-row m-tiles with no
// points. With 86,016 points on 132 SMs that is 5 tiles and 16 points per
// block, where tiles of 128 would take 6 waves for 5.09 waves of work.
struct Range {
  int begin, end;
};

__device__ __forceinline__ Range block_range(int N, int chunk) {
  const int b = blockIdx.x * chunk;
  return {b, min(N, b + chunk)};
}

// This warp's m-tiles with points, in a tile of `rows` points.
__device__ __forceinline__ int row_tiles(int rows) {
  const int mine = rows - ((threadIdx.x >> 5) & 1) * 64;
  return max(0, min(4, (mine + 15) / 16));
}

// Points per block: N over the SMs, rounded up to 16.
inline int range_chunk(int N) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = max(sms, 1);
  const int per = (N + sms - 1) / sms;
  return (per + 15) / 16 * 16;
}

inline unsigned range_blocks(int N, int chunk) {
  return (unsigned)((N + chunk - 1) / chunk);
}

// Xs[p][n] = dZ_{L-1}[p][n] = value(p, n) for the tile (zeros past N and in
// the padded columns), stored to scratch too (with the padding).
template <typename Fn>
__device__ __forceinline__ void load_grad(const Mlp& m, const Scratch& s,
                                          float* Xs, int p0, int N,
                                          Fn value) {
  const int no = m.dout[m.L - 1], np = pad8(no);
  float* dZ = s.dZ[m.L - 1];
  for (int e = threadIdx.x; e < kTile * np; e += kThreads) {
    const int p = e / np, n = e - p * np;
    const int gp = p0 + p;
    const float v = gp < N && n < no ? value(gp, n) : 0.0f;
    if (gp < N) dZ[(int64_t)gp * np + n] = v;
    Xs[p * kLdx + n] = v;
  }
}

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

// Xs[p][c] = feature(p0 + p, c) for c < C0 (zeros past N and in the padded
// columns up to pad8(C0)); given A0, also stored there ([N, pad8(C0)]).
template <typename Fn>
__device__ __forceinline__ void feature_tile(int C0, int p0, int N,
                                             float* Xs, float* A0,
                                             Fn feature) {
  const int cp = pad8(C0);
  for (int e = threadIdx.x; e < kTile * cp; e += kThreads) {
    const int p = e / cp, c = e - p * cp;
    const int gp = p0 + p;
    const float f = gp < N && c < C0 ? feature(gp, p, c) : 0.0f;
    if (A0 && gp < N) A0[(int64_t)gp * cp + c] = f;
    Xs[p * kLdx + c] = f;
  }
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

// Packing: one job per layer and operand. The operand B(c, r) has R
// (reduction) rows and C columns: W[c][r] (forward, trans = 0) or W[r][c]
// (backward, trans = 1), zero past the layer; element (step s, n-tile t,
// lane) is the float4 (hi b0, hi b1, lo b0, lo b1) with b0 = B(8t + lane/4,
// 8s + lane%4), b1 = B(8t + lane/4, 8s + lane%4 + 4).
struct PackJob {
  const float* W;
  float4* dst;
  int din, dout, trans;
};

struct PackJobs {
  PackJob job[2 * kMaxLayers];
  int n;
};

__global__ void __launch_bounds__(256)
    pack_weights(const __grid_constant__ PackJobs jobs) {
  const PackJob& J = jobs.job[blockIdx.y];
  const int R = J.trans ? J.dout : J.din, C = J.trans ? J.din : J.dout;
  const int tiles = pad8(C) / 8;
  const int total = pad8(R) / 8 * tiles * 32;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int lane = idx & 31, st = idx >> 5;
    const int s = st / tiles, t = st - s * tiles;
    const int c = 8 * t + (lane >> 2), r = 8 * s + (lane & 3);
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 4 * h;
      v[h] = c < C && rr < R
                 ? (J.trans ? J.W[(int64_t)rr * J.din + c]
                            : J.W[(int64_t)c * J.din + rr])
                 : 0.0f;
    }
    uint32_t hi0, lo0, hi1, lo1;
    split(v[0], hi0, lo0);
    split(v[1], hi1, lo1);
    J.dst[idx] = make_float4(__uint_as_float(hi0), __uint_as_float(hi1),
                             __uint_as_float(lo0), __uint_as_float(lo1));
  }
}

// float4s of one packed operand of a layer (din x dout).
inline int64_t packed_f4(int din, int dout) {
  return (int64_t)pad8(din) * pad8(dout) / 2;
}

// Pack every layer's F (and, for a backward, G) into `packed` (floats:
// 2 pad8(in) pad8(out) per layer and operand, F_0..F_{L-1} then G_0..) and
// point m at them.
inline cudaError_t pack_layers(Mlp& m, float* packed, bool backward,
                               cudaStream_t st) {
  PackJobs jobs = {};
  float4* dst = (float4*)packed;
  for (int pass = 0; pass < (backward ? 2 : 1); ++pass)
    for (int l = 0; l < m.L; ++l) {
      PackJob& J = jobs.job[jobs.n++];
      J = PackJob{m.W[l], dst, m.din[l], m.dout[l], pass};
      (pass ? m.G : m.F)[l] = dst;
      dst += packed_f4(m.din[l], m.dout[l]);
    }
  pack_weights<<<dim3(128, jobs.n), 256, 0, st>>>(jobs);
  return cudaGetLastError();
}

// The forward's walk over the first `layers` layers (F operands).
inline Walk forward_walk(const Mlp& m, int layers) {
  Walk w = {};
  w.n = layers;
  for (int l = 0; l < layers; ++l) {
    w.B[l] = m.F[l];
    w.cols[l] = pad8(m.dout[l]);
    w.first[l + 1] = w.first[l] + pad8(m.din[l]) / 8;
  }
  return w;
}

// The backward's walk from the last layer to the first (G operands).
inline Walk backward_walk(const Mlp& m) {
  Walk w = {};
  w.n = m.L;
  for (int i = 0; i < m.L; ++i) {
    const int l = m.L - 1 - i;
    w.B[i] = m.G[l];
    w.cols[i] = pad8(m.din[l]);
    w.first[i + 1] = w.first[i] + pad8(m.dout[l]) / 8;
  }
  return w;
}

constexpr int kDwTile = 128;    // output tile (n x k) of the dW kernel
constexpr int kDwPts = 32;      // points staged per step (four k8 steps)
constexpr int kDwLd = 136;      // = 8 mod 32: fragment loads hit 32 banks
constexpr int kDwThreads = 256; // 8 warps: 2 (n) x 4 (k), 64 x 32 each

constexpr size_t kDwSmem = sizeof(float) * 2 * 2 * kDwPts * kDwLd;

// The point kernels and the dW kernel take more than the default 48 KB of
// dynamic shared memory; the attribute is per device, so each launch sets
// it for the kernel it launches.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Stage kDwPts rows of one operand [N, ld] (ld a multiple of 8, so rows
// and tile offsets are 16-byte aligned) from row p of the chunk [pb, pe):
// S[pp][c] = X[p+pp][c0+c] for c0 + c < ld (zeros outside), by 16-byte
// copies.
__device__ __forceinline__ void dw_stage(float (*S)[kDwLd],
                                         const float* __restrict__ X, int p,
                                         int pe, int ld, int c0) {
  constexpr int kPerRow = kDwTile / 4;
#pragma unroll
  for (int j = 0; j < kDwPts * kPerRow / kDwThreads; ++j) {
    const int e = threadIdx.x + kDwThreads * j;
    const int pp = e / kPerRow, c = 4 * (e - pp * kPerRow);
    const int gp = p + pp, x = c0 + c;
    if (gp < pe && x < ld)
      cp_async16(&S[pp][c], X + (int64_t)gp * ld + x);
    else
      *(float4*)&S[pp][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// P[s][n][k] = sum over the points of chunk s of dZ[p][n] * A[p][k] for
// k < K (3xTF32 MMAs over 32-point steps, double-buffered by cp.async; each
// k8 step's MMAs go to zeroed accumulators, added to the sum rounded, as in
// mma3), and P[s][n][K] = sum of dZ[p][n] in point order (the bias; k-tile
// 0 only). dZ and A are scratch at the padded widths. Two blocks fit an
// SM.
__global__ void __launch_bounds__(kDwThreads, 2)
    mlp_dw_partial(const float* __restrict__ dZ, const float* __restrict__ A,
                   int N, int Nout, int K, int chunk,
                   float* __restrict__ P) {
  extern __shared__ float4 dw_smem[];  // Zs, As: [2][kDwPts][kDwLd] each
  float (*Zs)[kDwPts][kDwLd] = (float (*)[kDwPts][kDwLd])dw_smem;
  float (*As)[kDwPts][kDwLd] = Zs + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int n0 = blockIdx.x * kDwTile, k0 = blockIdx.y * kDwTile;
  const int s = blockIdx.z;
  const int pb = s * chunk, pe = min(N, pb + chunk);
  const int steps = pe > pb ? (pe - pb + kDwPts - 1) / kDwPts : 0;
  const bool bias = blockIdx.y == 0 && tid < kDwTile;

  // this warp's valid m-tiles (rows of dW) and n-tiles (columns)
  const int mrows = Nout - (n0 + wm * 64), ncols = K - (k0 + wn * 32);
  const int mts = max(0, min(4, (mrows + 15) / 16));
  const int nts = max(0, min(4, (ncols + 7) / 8));
  float acc[4][4][4] = {};
  float bsum = 0.0f;
  auto stage = [&](int buf, int p) {
    dw_stage(Zs[buf], dZ, p, pe, pad8(Nout), n0);
    dw_stage(As[buf], A, p, pe, pad8(K), k0);
  };
  if (steps > 0) stage(0, pb);
  cp_async_commit();
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) stage((it + 1) & 1, pb + (it + 1) * kDwPts);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = it & 1;
    if (bias)
      for (int pp = 0; pp < kDwPts; ++pp) bsum += Zs[buf][pp][tid];
    if (mts > 0 && nts > 0) {
#pragma unroll
      for (int ks = 0; ks < kDwPts; ks += 8) {
        const int r = ks + (lane & 3);
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + (lane >> 2);
          split(As[buf][r][c], bh[nt][0], bl[nt][0]);
          split(As[buf][r + 4][c], bh[nt][1], bl[nt][1]);
        }
        // the next m-tile's values load while this one's MMAs run
        const float* z0 = &Zs[buf][r][wm * 64 + (lane >> 2)];
        float zr[4] = {z0[0], z0[8], z0[4 * kDwLd], z0[4 * kDwLd + 8]};
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= mts) break;
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(zr[e], ah[e], al[e]);
          if (mt + 1 < mts) {
            z0 += 16;
            zr[0] = z0[0];
            zr[1] = z0[8];
            zr[2] = z0[4 * kDwLd];
            zr[3] = z0[4 * kDwLd + 8];
          }
          float t[4][4] = {};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (nt < nts) mma(t[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (nt < nts) mma(t[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (nt < nts) mma(t[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[nt][e];
        }
      }
    }
    __syncthreads();  // the buffer is free to be staged again
  }
  const int K1 = K + 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * (e >> 1);
        const int kx = k0 + wn * 32 + nt * 8 + 2 * (lane & 3) + (e & 1);
        if (n < Nout && kx < K)
          P[((int64_t)s * Nout + n) * K1 + kx] = acc[mt][nt][e];
      }
  if (bias && n0 + tid < Nout)
    P[((int64_t)s * Nout + n0 + tid) * K1 + K] = bsum;
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
    dim3 g2((Nout + kDwTile - 1) / kDwTile, (K + kDwTile - 1) / kDwTile, S);
    cudaError_t e = allow_smem((const void*)mlp_dw_partial, kDwSmem);
    if (e != cudaSuccess) return e;
    mlp_dw_partial<<<g2, kDwThreads, kDwSmem, st>>>(s.dZ[l], s.A[l], N, Nout,
                                                    K, chunk, P);
    const int64_t outs = (int64_t)Nout * (K + 1);
    mlp_dw_reduce<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
        P, S, Nout, K, (float*)dW[l], (float*)db[l], accumulate);
    e = cudaGetLastError();
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
