// Device code shared by the embedded scene-flow MLP kernels (mlp_embed.cu,
// kernel B, and the dense stack of fused_mlp) and the Euler-chain backward
// (mlp_chain.cu, kernel C): a tensor-core tile GEMM at float32 accuracy.
//
// Arithmetic: 3xTF32. Each float32 operand x is split into
//   hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi)
// and a product is lo*hi + hi*lo + hi*hi (the small products first). The
// lost lo*lo term is below float32's rounding, so the stack keeps the JAX
// package's float32 parity; a single TF32 product would not
// (tests/test_torch_kernels.py emulates both). The conversion is explicit:
// a tensor-core op fed raw float32 bits would truncate them to TF32.
//
// Promotion interval: k8. The tensor cores add into their accumulator by
// truncation, which biases a long run of products on one accumulator. So
// each k8 step's three products go to an accumulator that the first of them
// overwrites (scale-d = 0) and reach the running float32 sum, held in
// registers outside the tensor core, by one rounded add. On the card the
// largest error of this order against the plain float32 stack is 6.1e-6 of
// the largest value (kernel B's backward at 1,376,256 points; C's 5.9e-6,
// the forward's 1.7e-6), within the checks' 1e-5; tests/test_torch_kernels.py
// emulates the order (_mm_3xtf32_k8) against the JAX package.
//
// Point kernels: wgmma.mma_async m64nNk8 .f32.tf32.tf32, A from registers,
// B from shared memory by descriptor. One persistent block per SM walks a
// contiguous range of points in tiles of kTile = 128: two consumer
// warpgroups of 64 rows each, plus one producer warp. The tile's
// activations stay in shared memory (Xs, float32 [128][kLdx]). Every warp
// reads and writes only its own 16 rows of Xs: wgmma's A fragment and its
// accumulator both give warp w of a warpgroup rows 16w..16w+15 of the
// group's 64. So nothing in a tile needs a barrier across warps; only the
// weight ring is shared. A warp loads its four A values of a k8 step from
// Xs and splits them once for all the columns of the pass (N up to 128).
//
// A layer of C output columns (a multiple of 8) runs as one pass of N = C,
// or, for C > 128, two passes of 128 and C - 128: a pass's accumulator (N/2
// floats a thread) and its running sum (N/2) must both fit in registers, of
// which a thread has 168 (the compiler budgets the block's 288 threads as
// three warpgroups). The first pass of a two-pass layer parks its outputs
// in a per-thread stage in shared memory (the second pass still reads the
// layer's input from Xs) and writes them to Xs after the second.
//
// The weights are packed once per launch (pack_weights): split into hi/lo,
// zero-padded to multiples of 8 (K = 132 -> 136 for the features, N = 3 -> 8
// for the field's output) and laid out as wgmma's K-major shared-memory
// operand without swizzle: per pass and k8 step, hi then lo, each as N/8
// groups of two 8-column x 4-k core matrices of 128 bytes (k-neighbours 128
// bytes apart, the descriptor's leading offset; column groups 256 bytes
// apart, its stride offset). The forward packs W [out][in] (F), the backward
// also W^T (G), so that dX = dZ W reads its operand K-major too. The
// producer warp streams them, one k8 step of one pass (up to 8 KB) per
// slot, through a ring of kStages slots by bulk async copies (TMA) that
// complete on the slot's full mbarrier; each consumer warp arrives on the
// slot's empty mbarrier once its warpgroup's products have completed. The
// producer runs ahead across layers and tiles, so the next tile's first
// steps load during the last one's epilogue.
//
// Budget, per block (one per SM): shared memory 231,488 of 232,448 bytes:
// the ring (4 x 8 KB), Xs (128 x 260 floats, 133,120 bytes; the row stride
// of 4 mod 32 words puts a warp's 32 A loads in 32 banks), the stage (8
// warps x 64 floats x 32 lanes, 64 KB) and 8 mbarriers; kernel C keeps its
// staged p_k, t_k in Xs's padding columns 256..259.
//
// Scratch (A_l, dZ_l) has the tile's padded widths (pad8, the padding
// zeros) and leaves shared memory by coalesced 16-byte copies of each
// warp's rows after each layer; the backward's leaky-relu mask is applied
// in the same pass.
//
// The weight gradient of a layer is dW = dZ^T A over all points. Instead of
// the TPU's sequential-grid carry it is split over S chunks of points into
// partial sums (mlp_dw_partial, 3xTF32 mma.sync on 128 x 128 output tiles,
// the bias a column sum in point order) and summed in a fixed order
// (mlp_dw_reduce): deterministic, no float atomics. It reduces over the
// points, which the scratch holds as rows, so wgmma's K-major TF32 operands
// cannot read it in place.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;   // widest layer the tile holds
constexpr int kTile = 128;       // points per tile: two warpgroups of 64
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kLdx = 260;        // activation row stride: = 4 mod 32, so an
                                 // A fragment's 32 loads hit 32 banks
constexpr int kPassCols = 128;   // widest pass
constexpr int kStages = 4;       // weight ring slots
constexpr int kSlotFloats = 16 * kPassCols;  // one k8 step: 8 x 128 x (hi, lo)
constexpr int kStageFloats = 32 * kPassCols / 2;  // a warp's parked pass
constexpr float kSlope = 0.2f;
// the ring's slots, the activation tile, the stage, the ring's mbarriers
constexpr size_t kPointSmem =
    sizeof(float) * (kStages * kSlotFloats + kTile * kLdx +
                     kConsumerWarps * kStageFloats) +
    2 * kStages * sizeof(uint64_t);

__host__ __device__ __forceinline__ int pad8(int x) { return (x + 7) & ~7; }

// A layer of `cols` (padded) output columns runs in passes of at most
// kPassCols columns.
__host__ __device__ __forceinline__ int passes(int cols) {
  return cols > kPassCols ? 2 : 1;
}

__host__ __device__ __forceinline__ int pass_cols(int cols, int p) {
  return p ? cols - kPassCols : min(cols, kPassCols);
}

struct Mlp {
  const float* W[kMaxLayers];  // [out, in]
  const float* b[kMaxLayers];  // [out]
  const float* F[kMaxLayers];  // packed W (reduction over in)
  const float* G[kMaxLayers];  // packed W^T (reduction over out)
  int din[kMaxLayers];
  int dout[kMaxLayers];
  int L;
};

// The packed operands of a walk over the layers, in walk order: layer i
// has cols[i] (padded) output columns and steps[i] k8 steps a pass; its
// passes lie one after the other from B[i].
struct Walk {
  const float* B[kMaxLayers];
  int steps[kMaxLayers];
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

// The warp MMA of the dW pass (mlp_dw_partial).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ---- wgmma ---------------------------------------------------------------

// The shared-memory descriptor of a K-major operand without swizzle whose
// 128-byte core matrices (8 rows x 16 bytes) lie 128 bytes apart along K
// (leading offset) and 256 bytes apart along N (stride offset).
__device__ __forceinline__ uint64_t operand_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(128 >> 4) << 16 |
         (uint64_t)(256 >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps a register the asynchronous products read or write live and
// unmoved across the fence it stands at.
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d[0 .. N/2) = a b (scale_d == 0) or d + a b: a the warpgroup's 64 x 8 TF32
// A fragment in registers, b the N x 8 K-major operand at desc. The
// operand list names all 64 accumulators; the instruction writes N/2.
template <int N>
__device__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                      int scale_d);

#define DVD_D4(a, b, c, d) "%" #a ", %" #b ", %" #c ", %" #d
#define DVD_D1 DVD_D4(0, 1, 2, 3)
#define DVD_D2 DVD_D1 ", " DVD_D4(4, 5, 6, 7)
#define DVD_D3 DVD_D2 ", " DVD_D4(8, 9, 10, 11)
#define DVD_D4_ DVD_D3 ", " DVD_D4(12, 13, 14, 15)
#define DVD_D5 DVD_D4_ ", " DVD_D4(16, 17, 18, 19)
#define DVD_D6 DVD_D5 ", " DVD_D4(20, 21, 22, 23)
#define DVD_D7 DVD_D6 ", " DVD_D4(24, 25, 26, 27)
#define DVD_D8 DVD_D7 ", " DVD_D4(28, 29, 30, 31)
#define DVD_D9 DVD_D8 ", " DVD_D4(32, 33, 34, 35)
#define DVD_D10 DVD_D9 ", " DVD_D4(36, 37, 38, 39)
#define DVD_D11 DVD_D10 ", " DVD_D4(40, 41, 42, 43)
#define DVD_D12 DVD_D11 ", " DVD_D4(44, 45, 46, 47)
#define DVD_D13 DVD_D12 ", " DVD_D4(48, 49, 50, 51)
#define DVD_D14 DVD_D13 ", " DVD_D4(52, 53, 54, 55)
#define DVD_D15 DVD_D14 ", " DVD_D4(56, 57, 58, 59)
#define DVD_D16 DVD_D15 ", " DVD_D4(60, 61, 62, 63)
#define DVD_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DVD_WGMMA(N, DLIST)                                                  \
  template <>                                                               \
  __device__ __forceinline__ void wgmma<N>(                                 \
      float(&d)[64], const uint32_t(&a)[4], uint64_t desc, int scale_d) {   \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" DLIST  \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"                      \
        : DVD_F4(0), DVD_F4(4), DVD_F4(8), DVD_F4(12), DVD_F4(16),          \
          DVD_F4(20), DVD_F4(24), DVD_F4(28), DVD_F4(32), DVD_F4(36),       \
          DVD_F4(40), DVD_F4(44), DVD_F4(48), DVD_F4(52), DVD_F4(56),       \
          DVD_F4(60)                                                        \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),            \
          "r"(scale_d));                                                    \
  }
DVD_WGMMA(8, DVD_D1)
DVD_WGMMA(16, DVD_D2)
DVD_WGMMA(24, DVD_D3)
DVD_WGMMA(32, DVD_D4_)
DVD_WGMMA(40, DVD_D5)
DVD_WGMMA(48, DVD_D6)
DVD_WGMMA(56, DVD_D7)
DVD_WGMMA(64, DVD_D8)
DVD_WGMMA(72, DVD_D9)
DVD_WGMMA(80, DVD_D10)
DVD_WGMMA(88, DVD_D11)
DVD_WGMMA(96, DVD_D12)
DVD_WGMMA(104, DVD_D13)
DVD_WGMMA(112, DVD_D14)
DVD_WGMMA(120, DVD_D15)
DVD_WGMMA(128, DVD_D16)

// ---- the weight ring -----------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
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

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// The ring: kStages slots of one k8 step of one pass each. Steps are
// numbered in issue order over the whole kernel (g, the same count in the
// producer and in every consumer warp); step g uses slot g % kStages in
// that slot's (g / kStages)-th phase. full: one arrival (the producer's,
// with the step's bytes); empty: one arrival per consumer warp.
struct Ring {
  unsigned slots, full, empty;  // shared addresses
  int g;
};

// The tile's shared memory, and the ring's barriers initialised; ends past
// a barrier of the whole block.
struct Tile {
  float* Xs;
  float* stage;
  Ring ring;
};

__device__ __forceinline__ Tile make_tile(float4* smem) {
  float* slots = (float*)smem;
  float* Xs = slots + kStages * kSlotFloats;
  float* stage = Xs + kTile * kLdx;
  uint64_t* bars = (uint64_t*)(stage + kConsumerWarps * kStageFloats);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(bars + s), 1);
      mbar_init(smem_addr(bars + kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return Tile{Xs, stage,
              Ring{smem_addr(slots), smem_addr(bars),
                   smem_addr(bars + kStages), 0}};
}

// The producer: lane 0 of the last warp streams every step of walk w,
// each into its slot once the consumers have freed it.
__device__ __forceinline__ void produce(const Walk& w, Ring& r) {
  for (int i = 0; i < w.n; ++i)
    for (int p = 0; p < passes(w.cols[i]); ++p) {
      const int np = pass_cols(w.cols[i], p), steps = w.steps[i];
      const float* src = w.B[i] + (int64_t)p * steps * kSlotFloats;
      const unsigned bytes = 64u * np;
      for (int s = 0; s < steps; ++s, ++r.g) {
        const int slot = r.g % kStages;
        const unsigned full = r.full + 8 * slot;
        mbar_wait(r.empty + 8 * slot, ((r.g / kStages) & 1) ^ 1);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                full),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(r.slots + 4 * slot *
                                                           kSlotFloats),
            "l"(src + (int64_t)s * 16 * np), "r"(bytes), "r"(full)
            : "memory");
      }
    }
}

// The producer warp's share of a kernel: lane 0 streams, for every tile of
// the block's range, the walk a and then, given, b. True for the
// producer warp's threads, which have nothing else to do.
__device__ __forceinline__ bool producer(int begin, int end, const Walk& a,
                                         const Walk* b, Ring& r) {
  if (threadIdx.x < kConsumers) return false;
  if (threadIdx.x == kConsumers)
    for (int p0 = begin; p0 < end; p0 += kTile) {
      produce(a, r);
      if (b) produce(*b, r);
    }
  return true;
}

// ---- a consumer warp's rows ----------------------------------------------

// What a pass does with its sums (row rr of the warp's 16, column c of the
// layer, sum index i of the thread).
struct Epilogue {
  enum Kind { kHidden, kLast, kGrad };
  Kind kind;
  float* Xw;          // the warp's rows of Xs
  float* stage;       // the warp's stage (park the pass there), or null
  const float* b;     // bias (kHidden, kLast)
  float* out;         // [N, no] (kLast)
  int64_t pw0;        // the global point of the warp's first row
  int no, rows, c0;   // the layer's width, the warp's valid rows, the pass
                      // column offset
  __device__ __forceinline__ void operator()(int i, int rr, int c,
                                             float v) const {
    const int lane = threadIdx.x & 31;
    c += c0;
    if (kind == kLast) {
      if (c < no && rr < rows) out[(pw0 + rr) * no + c] = v + b[c];
      return;
    }
    if (kind == kHidden) {
      const float z = c < no ? v + b[c] : 0.0f;
      v = z >= 0.0f ? z : kSlope * z;
    }
    if (stage)
      stage[i * 32 + lane] = v;
    else
      Xw[rr * kLdx + c] = v;
  }
};

// One pass of a layer for this warp: sum = X W over `steps` k8 steps of
// its N columns (the warp's A rows from Xw), then e(i, row, col, sum[i])
// for each of the thread's N/2 sums (wgmma's accumulator layout: sum 4j + e
// is row g + 8 (e / 2), column 8j + 2t + e % 2, g = lane / 4, t = lane % 4).
// An inactive warpgroup (no points in its 64 rows) only keeps the ring's
// count. Xw must be complete and visible to the warp on entry.
template <int N>
__device__ __forceinline__ void mma_pass(int steps, const float* Xw,
                                         Ring& r, bool active,
                                         const Epilogue& e) {
  const int lane = threadIdx.x & 31;
  const float* x = Xw + (lane >> 2) * kLdx + (lane & 3);
  float acc[64], sum[N / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = 0.0f;
  // the next step's A values load while this step's products run
  float xr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
    xr[0] = x[0];
    xr[1] = x[8 * kLdx];
    xr[2] = x[4];
    xr[3] = x[8 * kLdx + 4];
  }
  for (int s = 0; s < steps; ++s, ++r.g) {
    const int slot = r.g % kStages;
    mbar_wait(r.full + 8 * slot, (r.g / kStages) & 1);
    if (active) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split(xr[k], ah[k], al[k]);
      if (s + 1 < steps) {
        x += 8;
        xr[0] = x[0];
        xr[1] = x[8 * kLdx];
        xr[2] = x[4];
        xr[3] = x[8 * kLdx + 4];
      }
      const unsigned b = r.slots + 4 * slot * kSlotFloats;
      const uint64_t hi = operand_desc(b), lo = operand_desc(b + 32 * N);
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(acc[i]);
      wgmma_fence();
      wgmma<N>(acc, al, hi, 0);
      wgmma<N>(acc, ah, lo, 1);
      wgmma<N>(acc, ah, hi, 1);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(acc[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        keep(ah[k]);
        keep(al[k]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty + 8 * slot);
    if (active) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sum[i] += acc[i];
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    e(i, (lane >> 2) + 8 * ((i & 3) >> 1),
      8 * (i >> 2) + 2 * (lane & 3) + (i & 1), sum[i]);
}

// The pass of n columns (a multiple of 8, at most kPassCols).
__device__ __forceinline__ void run_pass(int n, int steps, const float* Xw,
                                         Ring& r, bool active,
                                         const Epilogue& e) {
  switch (n) {
#define DVD_PASS(N)                          \
  case N:                                    \
    mma_pass<N>(steps, Xw, r, active, e);    \
    break;
    DVD_PASS(8) DVD_PASS(16) DVD_PASS(24) DVD_PASS(32)
    DVD_PASS(40) DVD_PASS(48) DVD_PASS(56) DVD_PASS(64)
    DVD_PASS(72) DVD_PASS(80) DVD_PASS(88) DVD_PASS(96)
    DVD_PASS(104) DVD_PASS(112) DVD_PASS(120) DVD_PASS(128)
#undef DVD_PASS
  }
}

// Layer i of walk w for this warp: its passes, then the parked first pass
// written to Xw's columns 0..127 (wgmma's accumulator layout, as parked);
// ends with the warp's writes visible to the warp.
__device__ __forceinline__ void run_layer(const Walk& w, int i, float* Xw,
                                          float* Sw, Ring& r, bool active,
                                          Epilogue e) {
  const int cols = w.cols[i], np = passes(cols);
  for (int p = 0; p < np; ++p) {
    e.c0 = p * kPassCols;
    e.stage = np == 2 && p == 0 && e.kind != Epilogue::kLast ? Sw : nullptr;
    run_pass(pass_cols(cols, p), w.steps[i], Xw, r, active, e);
  }
  if (np == 2 && active && e.kind != Epilogue::kLast) {
    const int lane = threadIdx.x & 31;
    for (int k = 0; k < kPassCols / 2; ++k)
      Xw[((lane >> 2) + 8 * ((k & 3) >> 1)) * kLdx + 8 * (k >> 2) +
         2 * (lane & 3) + (k & 1)] = Sw[k * 32 + lane];
  }
  __syncwarp();
}

// f(x, e) over the warp's first `rows` rows and `width` (a multiple of 8)
// columns, four consecutive elements x of Xw per call: e indexes float4s
// of the row-major [rows, width] block that starts the warp's rows in a
// global [N, width] array (coalesced).
template <typename F4>
__device__ __forceinline__ void warp_rows(float* Xw, int rows, int width,
                                          F4 f4) {
  const int w4 = width >> 2;
  for (int e = threadIdx.x & 31; e < rows * w4; e += 32) {
    const int p = e / w4, c = 4 * (e - p * w4);
    f4(*(float4*)(Xw + p * kLdx + c), e);
  }
}

// The forward over the layers of walk fw (layer l of the walk is layer l
// of m) on the warp's rows of Xw (complete and visible to the warp; rows
// valid rows, active its warpgroup has points). Hidden layers: bias and
// leaky-relu, back into Xw (zeros in the padded columns) and, given
// scratch, copied from there to A[l + 1] with the padding (coalesced). The
// last layer of m: bias, to out [N, dout].
__device__ __forceinline__ void forward_layers(const Mlp& m, const Walk& fw,
                                               float* Xw, float* Sw, Ring& r,
                                               const Scratch* s, float* out,
                                               int64_t pw0, int rows,
                                               bool active) {
  for (int l = 0; l < fw.n; ++l) {
    const int no = m.dout[l];
    const Epilogue e = {l == m.L - 1 ? Epilogue::kLast : Epilogue::kHidden,
                        Xw, nullptr, m.b[l], out, pw0, no, rows, 0};
    run_layer(fw, l, Xw, Sw, r, active, e);
    if (s && e.kind == Epilogue::kHidden) {
      float4* A = (float4*)(s->A[l + 1] + pw0 * pad8(no));
      warp_rows(Xw, rows, pad8(no), [&](float4& x, int i) { A[i] = x; });
    }
  }
}

// The leaky-relu gradient, its mask the sign of the stored activation a
// (slope 0.2 > 0 keeps signs, and z = 0 gives 0 >= 0, as _leaky_grad does).
__device__ __forceinline__ float leaky_grad(float v, float a) {
  return a >= 0.0f ? v : kSlope * v;
}

// Xw holds dZ_{L-1}, the gradient at the last layer's output (zero-padded
// to 8 columns). Walk the layers back over bw (walk layer i is layer
// L - 1 - i): dX = dZ_l W_l into Xw, then for l > 0 one coalesced pass
// reads A_l and turns Xw into dZ_{l-1} = dX * leaky'(A_l), stored to
// scratch too; leaves the gradient at the features in Xw, visible to the
// warp.
__device__ __forceinline__ void backward_layers(const Mlp& m, const Walk& bw,
                                                const Scratch& s, float* Xw,
                                                float* Sw, Ring& r,
                                                int64_t pw0, int rows,
                                                bool active) {
  for (int i = 0; i < bw.n; ++i) {
    const int l = m.L - 1 - i;
    const Epilogue e = {Epilogue::kGrad, Xw, nullptr, nullptr, nullptr,
                        pw0, 0, rows, 0};
    run_layer(bw, i, Xw, Sw, r, active, e);
    if (l == 0) break;
    const int ni = pad8(m.din[l]);
    const float4* A = (const float4*)(s.A[l] + pw0 * ni);
    float4* dZ = (float4*)(s.dZ[l - 1] + pw0 * ni);
    warp_rows(Xw, rows, ni, [&](float4& x, int k) {
      const float4 a = A[k];
      x = make_float4(leaky_grad(x.x, a.x), leaky_grad(x.y, a.y),
                      leaky_grad(x.z, a.z), leaky_grad(x.w, a.w));
      dZ[k] = x;
    });
    __syncwarp();
  }
}

// Points are split into one contiguous range per block (a multiple of 16
// points, one block per SM), walked in tiles of kTile; only the last tile
// of a range is ragged, and a warpgroup whose 64 rows hold no points skips
// its products.
struct Range {
  int begin, end;
};

__device__ __forceinline__ Range block_range(int N, int chunk) {
  const int b = blockIdx.x * chunk;
  return {b, min(N, b + chunk)};
}

// A consumer warp's place in a tile of `rows` points: its rows of Xs and
// of the stage, its first point, its valid rows, and whether its
// warpgroup has any.
struct Place {
  float* Xw;
  float* Sw;
  int64_t pw0;
  int rows;
  bool active;
};

__device__ __forceinline__ Place warp_place(const Tile& t, int p0,
                                            int rows) {
  const int w = threadIdx.x >> 5;
  return Place{t.Xs + 16 * w * kLdx, t.stage + w * kStageFloats,
               (int64_t)p0 + 16 * w, max(0, min(16, rows - 16 * w)),
               rows > 64 * (w >> 2)};
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

// Xw[p][n] = dZ_{L-1}[p][n] = value(p, n) for the warp's 16 rows (zeros
// past `end` and in the padded columns), stored to scratch too (with the
// padding); visible to the warp on return.
template <typename Fn>
__device__ __forceinline__ void load_grad(const Mlp& m, const Scratch& s,
                                          float* Xw, int64_t pw0, int end,
                                          Fn value) {
  const int no = m.dout[m.L - 1], np = pad8(no);
  float* dZ = s.dZ[m.L - 1];
  for (int e = threadIdx.x & 31; e < 16 * np; e += 32) {
    const int p = e / np, n = e - p * np;
    const int64_t gp = pw0 + p;
    const float v = gp < end && n < no ? value(gp, n) : 0.0f;
    if (gp < end) dZ[gp * np + n] = v;
    Xw[p * kLdx + n] = v;
  }
  __syncwarp();
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

// Xw[p][c] = feature(gp, row p of Xw, c) for the warp's 16 rows and
// c < C0 (zeros past `end` and in the padded columns up to pad8(C0));
// given A0, also stored there ([N, pad8(C0)]); visible to the warp on
// return.
template <typename Fn>
__device__ __forceinline__ void feature_rows(int C0, int64_t pw0, int end,
                                             float* Xw, float* A0,
                                             Fn feature) {
  const int cp = pad8(C0);
  for (int e = threadIdx.x & 31; e < 16 * cp; e += 32) {
    const int p = e / cp, c = e - p * cp;
    const int64_t gp = pw0 + p;
    const float f =
        gp < end && c < C0 ? feature(gp, Xw + p * kLdx, c) : 0.0f;
    if (A0 && gp < end) A0[gp * cp + c] = f;
    Xw[p * kLdx + c] = f;
  }
  __syncwarp();
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
// (backward, trans = 1), zero past the layer. Pass p holds columns 128 p ..
// 128 p + np - 1 (np = pass_cols(pad8(C), p)); its k8 step s is 16 np
// floats, hi then lo, each np / 8 column groups j of two core matrices h
// (k = 8 s + 4 h .. + 3) of 8 columns i x 4 k: B(128 p + 8 j + i, 8 s + 4 h
// + kk) at ((j * 2 + h) * 8 + i) * 4 + kk.
struct PackJob {
  const float* W;
  float* dst;
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
  const int Rp = pad8(R), Cp = pad8(C), steps = Rp / 8;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < Rp * Cp;
       idx += gridDim.x * blockDim.x) {
    const int c = idx / Rp, r = idx - c * Rp;
    const float v = c < C && r < R ? (J.trans ? J.W[(int64_t)r * J.din + c]
                                              : J.W[(int64_t)c * J.din + r])
                                   : 0.0f;
    uint32_t hi, lo;
    split(v, hi, lo);
    const int p = c / kPassCols, cc = c - p * kPassCols;
    const int np = pass_cols(Cp, p);
    float* step = J.dst + (int64_t)p * steps * kSlotFloats +
                  (int64_t)(r >> 3) * 16 * np;
    const int off = (((cc >> 3) * 2 + ((r >> 2) & 1)) * 8 + (cc & 7)) * 4 +
                    (r & 3);
    step[off] = __uint_as_float(hi);
    step[8 * np + off] = __uint_as_float(lo);
  }
}

// floats of one packed operand of a layer (din x dout).
inline int64_t packed_floats(int din, int dout) {
  return 2 * (int64_t)pad8(din) * pad8(dout);
}

// Pack every layer's F (and, for a backward, G) into `packed` (floats:
// 2 pad8(in) pad8(out) per layer and operand, F_0..F_{L-1} then G_0..) and
// point m at them.
inline cudaError_t pack_layers(Mlp& m, float* packed, bool backward,
                               cudaStream_t st) {
  PackJobs jobs = {};
  float* dst = packed;
  for (int pass = 0; pass < (backward ? 2 : 1); ++pass)
    for (int l = 0; l < m.L; ++l) {
      PackJob& J = jobs.job[jobs.n++];
      J = PackJob{m.W[l], dst, m.din[l], m.dout[l], pass};
      (pass ? m.G : m.F)[l] = dst;
      dst += packed_floats(m.din[l], m.dout[l]);
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
    w.steps[l] = pad8(m.din[l]) / 8;
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
    w.steps[i] = pad8(m.dout[l]) / 8;
  }
  return w;
}

// ---- the weight gradient -------------------------------------------------

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
// k8 step's MMAs go to zeroed accumulators, added to the sum rounded, the
// point kernels' promotion interval), and P[s][n][K] = sum of dZ[p][n] in
// point order (the bias; k-tile 0 only). dZ and A are scratch at the
// padded widths. Two blocks fit an SM.
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
