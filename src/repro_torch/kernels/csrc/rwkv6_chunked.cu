// RWKV6 WKV recurrence, forward and backward, chunked and parallel over
// time, with the chunk products on the tensor cores.  Hopper (sm_90a), plain
// C interface for ctypes.  The `mma` variant of kernels/rwkv6_chunk.py.
//
// Replaces the Pallas TPU kernel `rwkv6_chunk`
// (src/repro/kernels/rwkv6_chunk.py, body `_rwkv_kernel`), and computes the
// function of the JAX model's `_chunked_wkv` (src/repro/models/rwkv.py).  Per
// b*h, with S_{-1} = 0 and w_t = exp(logw_t):
//
//   out_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// r, k, v: [BH, S, D] bf16; logw: [BH, S, D] f32; u: [BH, D] f32; out f32.
// D = 32 or 64, any S >= 1 (the ragged last chunk is zero-filled: k = v = 0
// and logw = 0 there change nothing).
//
// Chunks.  C = 16 steps (the model's _CHUNK).  In a chunk with start state
// S0, local steps t, cum_t = sum_{j<=t} logw_j and cp_t = cum_{t-1} (cp_0 =
// 0; a shift of cum, so cp_t - cum_{t-1} is exactly 0):
//
//   A[t,s] = sum_d r_t k_s exp(cp_t - cum_s)  (s < t),  A[t,t] = r_t.(u k_t)
//   out    = (r * pre) S0 + A v                       pre_t = prod_{j<t} w_j
//   S1     = tot * S0 + (k * suf)^T v                 suf_s = prod_{j>s} w_j
//
// Every decay is a later cumulative decay over an earlier one, never above
// 1: no exp(-cum), which overflows f32 where the Pallas kernel gives NaN.
// pre, suf, tot and the backward's pairwise weights are running products of
// the steps' own w_j rather than exps of differences of log sums: a chunk's
// log-decay reaches -873 at the model's steepest clip (-e^4 a step), where
// a difference of two such sums keeps ~1e-4 of a step's exp(-54.6), the
// whole of the decay gradient there.  The forward's A takes exp(cp_t -
// cum_s) (C^2 D / 2 exps a chunk, __expf on the CUDA cores, f32): its
// largest weights, exp(0) next to the diagonal, are exact.
//
// Spans, parallel over time.  S is cut into spans of `span` steps (128
// forward: 8 chunks; 64 backward: 4, whose start states fit shared memory)
// and each kernel runs a block per (b*h, span): 1024 forward blocks and 2048
// backward blocks at the train shape [128,1024,64], where a block per b*h
// gave 128 on 132 SMs.  Forward, three launches:
//   1. span pass: each span's local end state from zero (held in the
//      warps' mma accumulators across the span's chunks), and its total
//      decay (a product), to scratch;
//   2. scan over spans: scratch holds each span's start state instead, the
//      local states folded in span order (at most 7 at the train shape);
//   3. output pass: each block walks its span's chunks from its start state.
// Backward (g = dL/dout f32 -> gr, gk, gv bf16, glogw, gu f32): G_t =
// dL/dS_t, G_{S-1} = 0, G_{t-1} = r_t g_t^T + diag(w_t) G_t.
//   1. span pass: also each span's local start adjoint from zero, sum of
//      (r_t * prod of the span's decays before t) g_t^T, and its u gradient;
//   2. scan: start states forward, end adjoints in reverse span order, and
//      gu summed over spans in order;
//   3. each block walks its span forward, keeping each chunk's start state
//      in shared memory, then backward holding G, a chunk at a time:
//        Bm = g v^T, P1 = g S0^T, P2 = v G^T (tensor cores);
//        gr = pre*P1 + sum_{s<t} Bm[t,s] E[t,s] k_s + Bm[t,t] u k_t
//        gk = suf*P2 + sum_{t>s} Bm[t,s] E[t,s] r_t + Bm[s,s] u r_s
//        gv = (k * suf) G + A^T g (tensor cores)
//        glogw_t = T1 + T2_t + T3_t + T4_t, the direct form
//          w_t * sum_e G_t S_{t-1} split into finite terms:
//          T1 = tot * sum_e G_end S0, T2_t = sum_{s<t} suf_s k_s P2_s,
//          T3_t = sum_{tau>t} pre_tau r_tau P1_tau,
//          T4_t = sum_{s<t<tau} E[tau,s] r_tau k_s Bm[tau,s]
//        with E[t,s] = prod_{s<j<t} w_j, built per channel step by step;
//        G <- tot * G + (r * pre)^T g.
// No float atomics: every sum has a fixed order, so two runs give the same
// bits.  Scratch a call, f32: BH * nspan * (D^2 + D) forward (17.0 MB at the
// train shape), twice that per 64-step span backward (68.2 MB; the serial
// kernel's checkpoints took 268 MB).
//
// Tensor cores.  mma.sync m16n8k8 TF32: a chunk is M = 16 rows, so the
// [16,D]x[D,D], [16,16]x[16,D] and [D,16]x[16,D] products are whole tiles;
// a warp's tiles of a state update share one row of tiles, so their A
// fragments are loaded and split once.
// r, k, v (bf16) are exact in TF32.  An f32 operand (the state, the
// adjoint, g, the decayed r and k, A) is split into two TF32 parts, and
// its product takes two or three mma: rounded once to TF32 (10-bit
// mantissa), an output was off by 0.17 at the flattest decay (a 256-step
// sum; chip_smoke.py on an H100), past the bf16 tolerance of 4e-2; split,
// the products keep f32's accuracy to ~2^-21.  TF32 keeps f32's exponent
// range, so decayed factors near e^-54 keep their relative accuracy.
// Sums and the state are f32.  Each chunk's r, k, v, logw (and g) are
// staged with cp.async, 16 bytes a copy, and the next chunk's copies are in
// flight while this one computes.
//
// What bounds it.  At the train shape the forward moves 117.5 MB (0.035 ms at
// 3.35 TB/s) and the backward 201.4 MB (0.060 ms); their operations at the
// TF32 rate take 0.004 and 0.013 ms (three times that as split products):
// bytes bound both.  This design is bound by neither.  It adds the scratch
// traffic and three launches each way, and each block walks its chunks in
// sequence, 8 warps a block and one (backward) or two (forward) blocks an
// SM, with a barrier between the steps of a chunk: the pairwise weights
// (exps on the CUDA cores), the fragment loads and splits of the TF32
// products and the per-channel walks are chains of latency, not streams of
// bytes.  PERF.md has the times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 16;            // steps a chunk
constexpr int THREADS = 256;     // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int BWD_CHUNKS = 4;    // most chunks a backward span holds
constexpr int SCAN_THREADS = 256;

typedef __nv_bfloat16 bf16;

// ---- shared memory layout, in floats ----------------------------------------

template <int D>
struct Smem {
  static constexpr int LDR = D + 4;   // a chunk row: conflict-free A loads
  static constexpr int LDS = D + 8;   // a state row: conflict-free B loads
  static constexpr int LDA = C + 4;   // a row of a [16,16] matrix
  static constexpr int CH = C * LDR;  // one [C,D] array
  static constexpr int ST = D * LDS;  // one [D,D] state
  // Staging for cp.async: r, k, v bf16 [C][D] and logw, g f32 [C][D].
  static constexpr int RAW = C * D * 7 / 2;
  enum { R, K, V, G, CUM, CP, PRE, SUF, W, RD, KD, P1, P2, ARRAYS };
  static constexpr int ARR = RAW;
  static constexpr int AMAT = ARR + ARRAYS * CH;
  static constexpr int BMAT = AMAT + C * LDA;
  // u, tot, base, t1 [D]; vg [C]
  static constexpr int VEC = BMAT + C * LDA;
  static constexpr int STATES = VEC + 4 * D + C;
  static constexpr int bytes(int states) {
    return 4 * (STATES + states * ST);
  }
  static_assert(RAW % 4 == 0 && LDR % 4 == 0 && VEC % 4 == 0 &&
                    STATES % 4 == 0 && ST % 4 == 0,
                "16-byte aligned arrays and rows");
};

// ---- tensor cores -----------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x as a TF32 value and the TF32 rounding of what that leaves out.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// acc[j] (16x8 tiles) += A[16,K] B_j[K,8] on the tensor cores, one warp,
// NB tiles that share A.  A(m,k) = a[m*am + k*ak], B_j(k,n) = b[k*bk +
// (8j + n)*bn], in shared memory.  acc: rows lane/4 and lane/4 + 8,
// columns 2*(lane%4) and +1.  An f32 operand (SPLIT_A, SPLIT_B) goes in as
// two TF32 parts, hi + lo, and the product as hi*hi + hi*lo + lo*hi (three
// mma for two split operands, two for one): f32's accuracy to ~2^-21.
// Operands widened from bf16 are exact in TF32 and go in once.  A is loaded
// and split once a k-step for all NB tiles.
template <int K, bool SPLIT_A, bool SPLIT_B, int NB>
__device__ __forceinline__ void mma_tiles(float (&acc)[NB][4], const float* a,
                                          int am, int ak, const float* b,
                                          int bk, int bn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a[g * am + (k0 + q) * ak],
                         a[(g + 8) * am + (k0 + q) * ak],
                         a[g * am + (k0 + q + 4) * ak],
                         a[(g + 8) * am + (k0 + q + 4) * ak]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* bj = b + 8 * j * bn;
      const float bv[2] = {bj[(k0 + q) * bk + g * bn],
                           bj[(k0 + q + 4) * bk + g * bn]};
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) split(bv[i], bh[i], bl[i]);
      if (SPLIT_A) mma(acc[j], al, bh);
      if (SPLIT_B) mma(acc[j], ah, bl);
      mma(acc[j], ah, bh);
    }
  }
}

template <int K, bool SPLIT_A, bool SPLIT_B>
__device__ __forceinline__ void mma_tile(float (&acc)[4], const float* a,
                                         int am, int ak, const float* b,
                                         int bk, int bn) {
  mma_tiles<K, SPLIT_A, SPLIT_B, 1>(*reinterpret_cast<float(*)[1][4]>(&acc),
                                    a, am, ak, b, bk, bn);
}

// A tile's row and column for accumulator element i.
__device__ __forceinline__ int tile_row(int i) {
  return ((threadIdx.x & 31) >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int tile_col(int i) {
  return 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ void store_tile(const float (&acc)[4], float* out,
                                           int ld) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[tile_row(i) * ld + tile_col(i)] = acc[i];
}

// The [D,D] state tiles a warp owns: NB of the (D/16) x (D/8) 16x8 tiles,
// side by side in one row of tiles, so that they share A.
template <int D>
struct StateTiles {
  static constexpr int NT = D / 8;
  static constexpr int NB = (D / 16) * NT / WARPS;
  static_assert(NB >= 1 && NT % NB == 0, "a warp's tiles in one tile row");
  __device__ static int m0() { return (threadIdx.x >> 5) * NB / NT * 16; }
  __device__ static int n0() { return (threadIdx.x >> 5) * NB % NT * 8; }
};

// acc = diag(scale) acc + A^T B over one chunk, on the warp's state tiles:
// A (f32), B [C,D] chunk arrays, B f32 where SPLIT_B (else widened bf16).
// scale == nullptr means 1.
template <int D, bool SPLIT_B>
__device__ __forceinline__ void decay_tiles(
    float (&acc)[StateTiles<D>::NB][4], const float* scale, const float* a,
    const float* b) {
  using L = Smem<D>;
  using T = StateTiles<D>;
  if (scale != nullptr) {
#pragma unroll
    for (int j = 0; j < T::NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= scale[T::m0() + tile_row(i)];
  }
  mma_tiles<C, true, SPLIT_B, T::NB>(acc, a + T::m0(), 1, L::LDR,
                                     b + T::n0(), L::LDR, 1);
}

// The same on a state in shared memory (rows LDS): dst = diag(scale) src +
// A^T B.  dst may be src (each element is read and written by one thread).
template <int D, bool SPLIT_B>
__device__ void decay_update(float* dst, const float* src, const float* scale,
                             const float* a, const float* b) {
  using L = Smem<D>;
  using T = StateTiles<D>;
  const int at = T::m0() * L::LDS + T::n0();
  float acc[T::NB][4];
#pragma unroll
  for (int j = 0; j < T::NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[j][i] = src[at + tile_row(i) * L::LDS + 8 * j + tile_col(i)];
  decay_tiles<D, SPLIT_B>(acc, scale, a, b);
#pragma unroll
  for (int j = 0; j < T::NB; ++j) store_tile(acc[j], dst + at + 8 * j, L::LDS);
}

// ---- staging ----------------------------------------------------------------

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0));
}

struct Inputs {
  const bf16* r;
  const bf16* k;
  const bf16* v;
  const float* logw;
  const float* g;
  const float* u;
};

// Start the copies of chunk steps [t0, t0 + n) of one b*h (element offset
// `base`) into the staging area; rows past n are zero-filled.
template <int D, bool WITH_R, bool WITH_G>
__device__ void fetch_chunk(unsigned char* raw, const Inputs& in, size_t base,
                            int t0, int n) {
  constexpr int BP = D * 2 / 16, FP = D * 4 / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < C * BP; i += THREADS) {
    const int t = i / BP, j = i % BP;
    const bool ok = t < n;
    const size_t off = base + static_cast<size_t>(t0 + (ok ? t : 0)) * D;
    if (WITH_R) cp16(raw + i * 16, reinterpret_cast<const char*>(in.r + off)
                                        + j * 16, ok);
    cp16(raw + C * D * 2 + i * 16,
         reinterpret_cast<const char*>(in.k + off) + j * 16, ok);
    cp16(raw + 2 * C * D * 2 + i * 16,
         reinterpret_cast<const char*>(in.v + off) + j * 16, ok);
  }
  for (int i = threadIdx.x; i < C * FP; i += THREADS) {
    const int t = i / FP, j = i % FP;
    const bool ok = t < n;
    const size_t off = base + static_cast<size_t>(t0 + (ok ? t : 0)) * D;
    cp16(raw + 3 * C * D * 2 + i * 16,
         reinterpret_cast<const char*>(in.logw + off) + j * 16, ok);
    if (WITH_G) cp16(raw + 3 * C * D * 2 + C * D * 4 + i * 16,
                     reinterpret_cast<const char*>(in.g + off) + j * 16, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_chunk() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The staged chunk widened into f32 arrays (R, K, V, G) and each step's
// decay W = exp(logw), all threads.
template <int D, bool WITH_R, bool WITH_G>
__device__ void unpack_chunk(const unsigned char* raw, float* sm) {
  using L = Smem<D>;
  const bf16* rb = reinterpret_cast<const bf16*>(raw);
  const float* lw = reinterpret_cast<const float*>(raw + 3 * C * D * 2);
  float* arr = sm + L::ARR;
  for (int i = threadIdx.x; i < C * D; i += THREADS) {
    const int at = (i / D) * L::LDR + i % D;
    if (WITH_R) arr[L::R * L::CH + at] = __bfloat162float(rb[i]);
    arr[L::K * L::CH + at] = __bfloat162float(rb[C * D + i]);
    arr[L::V * L::CH + at] = __bfloat162float(rb[2 * C * D + i]);
    if (WITH_G) arr[L::G * L::CH + at] = lw[C * D + i];
    arr[L::W * L::CH + at] = expf(lw[i]);
  }
}

// The chunk's decays, one thread a channel (call with threadIdx.x < D,
// after unpack_chunk and a barrier): CUM, CP (log sums), PRE, SUF, tot
// (running products of W), KD = K * SUF and, WITH_R, RD = R * (scale *
// PRE), scale per channel (nullptr: 1).
template <int D, bool WITH_R>
__device__ void chunk_decays(const unsigned char* raw, float* sm,
                             const float* scale) {
  using L = Smem<D>;
  const float* lw = reinterpret_cast<const float*>(raw + 3 * C * D * 2);
  float* arr = sm + L::ARR;
  const int d = threadIdx.x;
  const float sc = scale == nullptr ? 1.f : scale[d];
  float c = 0.f, p = 1.f;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int at = t * L::LDR + d;
    arr[L::CP * L::CH + at] = c;
    c += lw[t * D + d];
    arr[L::CUM * L::CH + at] = c;
    arr[L::PRE * L::CH + at] = p;
    if (WITH_R) arr[L::RD * L::CH + at] = arr[L::R * L::CH + at] * (sc * p);
    p *= arr[L::W * L::CH + at];
  }
  sm[L::VEC + D + d] = p;  // tot
  float q = 1.f;
#pragma unroll
  for (int t = C - 1; t >= 0; --t) {
    const int at = t * L::LDR + d;
    arr[L::SUF * L::CH + at] = q;
    arr[L::KD * L::CH + at] = arr[L::K * L::CH + at] * q;
    q *= arr[L::W * L::CH + at];
  }
}

// The forward's intra-chunk weights A (bonus on the diagonal), pairwise on
// the CUDA cores, by the NTHREADS threads `tid` = 0.. of whole warps;
// entries above the diagonal stay 0.  Where there are threads enough, two
// take each strictly lower pair, half the channels each.
template <int D, int NTHREADS>
__device__ void intra_weights(float* sm, int tid) {
  using L = Smem<D>;
  constexpr int PAIRS = C * (C - 1) / 2;
  constexpr int PER = NTHREADS >= 2 * PAIRS + C ? 2 : 1;
  static_assert(NTHREADS >= PER * PAIRS + C, "a thread a pair");
  const float* arr = sm + L::ARR;
  const float* R = arr + L::R * L::CH;
  const float* K = arr + L::K * L::CH;
  const float* U = sm + L::VEC;
  const int lane = threadIdx.x & 31;
  // float4 reads: a quarter of the shared-memory instructions, and a lane
  // offset that puts neighbouring lanes on other banks.
  constexpr int Q = D / 4;
  int t = -1, s = 0;
  float acc = 0.f;
  if (tid < PER * PAIRS) {
    const int i = tid / PER, part = tid % PER;
    t = 1;
    while (t * (t + 1) / 2 <= i) ++t;
    s = i - t * (t - 1) / 2;
    const float4* rt = reinterpret_cast<const float4*>(R + t * L::LDR);
    const float4* ks = reinterpret_cast<const float4*>(K + s * L::LDR);
    const float4* cpt =
        reinterpret_cast<const float4*>(arr + L::CP * L::CH + t * L::LDR);
    const float4* cums =
        reinterpret_cast<const float4*>(arr + L::CUM * L::CH + s * L::LDR);
    for (int j = part * (Q / PER); j < (part + 1) * (Q / PER); ++j) {
      const int x = (j + lane / PER) & (Q - 1);
      const float4 a = rt[x], b = ks[x], c = cpt[x], e = cums[x];
      acc += a.x * b.x * __expf(c.x - e.x) + a.y * b.y * __expf(c.y - e.y) +
             a.z * b.z * __expf(c.z - e.z) + a.w * b.w * __expf(c.w - e.w);
    }
    if (part != 0) t = -1;
  } else if (tid < PER * PAIRS + C) {
    t = s = tid - PER * PAIRS;
    const float4* rt = reinterpret_cast<const float4*>(R + t * L::LDR);
    const float4* kt = reinterpret_cast<const float4*>(K + t * L::LDR);
    const float4* u4 = reinterpret_cast<const float4*>(U);
    for (int j = 0; j < Q; ++j) {
      const int x = (j + lane) & (Q - 1);
      const float4 a = rt[x], b = kt[x], c = u4[x];
      acc += a.x * c.x * b.x + a.y * c.y * b.y + a.z * c.z * b.z +
             a.w * c.w * b.w;
    }
  }
  if (PER == 2) {  // every lane of the warp, then the pair's first keeps it
    const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid < PER * PAIRS) acc += other;
  }
  if (t >= 0) sm[L::AMAT + t * L::LDA + s] = acc;
}

// Copy a [D,D] state between global memory (dense) and shared (rows LDS).
template <int D>
__device__ void load_state(float* dst, const float* src) {
  for (int i = threadIdx.x; i < D * D; i += THREADS)
    dst[(i / D) * Smem<D>::LDS + i % D] = src[i];
}
// A warp's state tiles to a dense [D,D] state in global memory.
template <int D>
__device__ void store_tiles(float* dst,
                            const float (&acc)[StateTiles<D>::NB][4]) {
  using T = StateTiles<D>;
#pragma unroll
  for (int j = 0; j < T::NB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(
          dst + (T::m0() + tile_row(2 * h)) * D + T::n0() + 8 * j +
          tile_col(0)) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
}

struct Spans {
  int S, nspan, chunks_per_span;
  __device__ int bh() const { return blockIdx.x / nspan; }
  __device__ int span() const { return blockIdx.x % nspan; }
  __device__ int first() const { return span() * chunks_per_span; }
  __device__ int last() const {  // one past
    return min(first() + chunks_per_span, (S + C - 1) / C);
  }
};

// ---- 1. span pass -----------------------------------------------------------

// Each span's local end state from zero and its total decay; with BWD also
// its local start adjoint and its u gradient.  Scratch: states
// [BH,nspan,D,D], decays [BH,nspan,D], then (BWD) adjoints [BH,nspan,D,D]
// and u gradients [BH,nspan,D].
template <int D, bool BWD>
__global__ void __launch_bounds__(THREADS)
span_kernel(Inputs in, float* scratch, Spans sp, int BH) {
  using L = Smem<D>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  unsigned char* raw = reinterpret_cast<unsigned char*>(sm);
  float* arr = sm + L::ARR;
  float* tot = sm + L::VEC + D;
  float* base = sm + L::VEC + 2 * D;   // decay of the span's earlier chunks
  float* vg = sm + L::VEC + 4 * D;     // g_t . v_t
  using T = StateTiles<D>;
  float st[T::NB][4] = {}, gl[T::NB][4] = {};  // this warp's state tiles
  const int tid = threadIdx.x, bh = sp.bh();
  const size_t base_el = static_cast<size_t>(bh) * sp.S * D;
  if (tid < D) base[tid] = 1.f;
  float gu_acc = 0.f;
  const int c0 = sp.first(), c1 = sp.last();
  fetch_chunk<D, BWD, BWD>(raw, in, base_el, c0 * C, min(C, sp.S - c0 * C));
  for (int c = c0; c < c1; ++c) {
    wait_chunk();
    unpack_chunk<D, BWD, BWD>(raw, sm);
    __syncthreads();
    if (tid < D) chunk_decays<D, BWD>(raw, sm, base);
    if (BWD && tid >= THREADS - C * 8) {
      // vg[t]: 8 lanes a row (the last C * 8 threads, whole warps), D/8
      // products each.
      const int t = (tid - (THREADS - C * 8)) / 8, part = tid % 8;
      float x = 0.f;
      for (int e = part; e < D; e += 8)
        x += arr[L::G * L::CH + t * L::LDR + e] *
             arr[L::V * L::CH + t * L::LDR + e];
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off, 8);
      if (part == 0) vg[t] = x;
    }
    __syncthreads();
    if (c + 1 < c1)
      fetch_chunk<D, BWD, BWD>(raw, in, base_el, (c + 1) * C,
                               min(C, sp.S - (c + 1) * C));
    decay_tiles<D, false>(st, tot, arr + L::KD * L::CH, arr + L::V * L::CH);
    if (BWD) {
      decay_tiles<D, true>(gl, nullptr, arr + L::RD * L::CH,
                           arr + L::G * L::CH);
      if (tid < D) {
#pragma unroll
        for (int t = 0; t < C; ++t)
          gu_acc += vg[t] * arr[L::R * L::CH + t * L::LDR + tid] *
                    arr[L::K * L::CH + t * L::LDR + tid];
      }
    }
    if (tid < D) base[tid] *= tot[tid];
  }
  __syncthreads();
  const size_t at = static_cast<size_t>(bh) * sp.nspan + sp.span();
  const size_t n_states = static_cast<size_t>(BH) * sp.nspan * D * D;
  const size_t n_vecs = static_cast<size_t>(BH) * sp.nspan * D;
  store_tiles<D>(scratch + at * D * D, st);
  if (tid < D) scratch[n_states + at * D + tid] = base[tid];
  if (BWD) {
    float* adj = scratch + n_states + n_vecs;
    store_tiles<D>(adj + at * D * D, gl);
    if (tid < D) adj[n_states + at * D + tid] = gu_acc;
  }
}

// ---- 2. scan over spans -----------------------------------------------------

// One state element over the spans, in place: x[p] <- the fold of the
// elements of the spans before p (after p, `reverse`), each earlier fold
// decayed by its span's total decay.  16 spans' loads go out at once:
// the fold is a chain of FMAs, and one load a step would wait out the
// memory's latency every time.
__device__ __forceinline__ void fold_spans(float* __restrict__ x,
                                           const float* __restrict__ dec,
                                           size_t stride, int D, int nspan,
                                           bool reverse) {
  constexpr int U = 16;
  float acc = 0.f;
  for (int p0 = 0; p0 < nspan; p0 += U) {
    float v[U], w[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int p = reverse ? nspan - 1 - (p0 + j) : p0 + j;
      if (p0 + j < nspan) {
        v[j] = x[p * stride];
        w[j] = dec[static_cast<size_t>(p) * D];
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int p = reverse ? nspan - 1 - (p0 + j) : p0 + j;
      if (p0 + j < nspan) {
        x[p * stride] = acc;
        acc = w[j] * acc + v[j];
      }
    }
  }
}

// In place, per state element: local end states -> start states (span
// order); backward also local start adjoints -> end adjoints (reverse
// order) and the spans' u gradients summed in span order.  (A template, so
// a profile tells the forward's scan from the backward's.)
template <bool BWD>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(float* __restrict__ states, const float* __restrict__ decay,
            float* __restrict__ adj, const float* __restrict__ gu_part,
            float* __restrict__ gu, int BH, int nspan, int D) {
  const size_t i = static_cast<size_t>(blockIdx.x) * SCAN_THREADS +
                   threadIdx.x;
  const size_t dd = static_cast<size_t>(D) * D;
  if (i < BH * dd) {
    const size_t bh = i / dd, rem = i % dd;
    const size_t off = bh * nspan * dd + rem;
    const float* dec = decay + bh * nspan * D + rem / D;
    fold_spans(states + off, dec, dd, D, nspan, false);
    if (BWD) fold_spans(adj + off, dec, dd, D, nspan, true);
  }
  if (BWD && i < static_cast<size_t>(BH) * D) {
    const size_t bh = i / D, d = i % D;
    float acc = 0.f;
    for (int p = 0; p < nspan; ++p)
      acc += gu_part[(bh * nspan + p) * D + d];
    gu[i] = acc;
  }
}

// ---- 3. forward output pass -------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(Inputs in, float* __restrict__ out, const float* scratch,
           Spans sp) {
  using L = Smem<D>;
  constexpr int NT = D / 8;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  unsigned char* raw = reinterpret_cast<unsigned char*>(sm);
  float* arr = sm + L::ARR;
  float* st = sm + L::STATES;
  const int tid = threadIdx.x, warp = tid >> 5, bh = sp.bh();
  const size_t base_el = static_cast<size_t>(bh) * sp.S * D;
  if (tid < D) sm[L::VEC + tid] = in.u[static_cast<size_t>(bh) * D + tid];
  for (int i = tid; i < C * L::LDA; i += THREADS) sm[L::AMAT + i] = 0.f;
  load_state<D>(st, scratch + (static_cast<size_t>(bh) * sp.nspan +
                               sp.span()) * D * D);
  const int c0 = sp.first(), c1 = sp.last();
  fetch_chunk<D, true, false>(raw, in, base_el, c0 * C,
                              min(C, sp.S - c0 * C));
  for (int c = c0; c < c1; ++c) {
    const int t0 = c * C, n = min(C, sp.S - t0);
    wait_chunk();
    unpack_chunk<D, true, false>(raw, sm);
    __syncthreads();
    if (tid < D) chunk_decays<D, true>(raw, sm, nullptr);
    __syncthreads();
    if (c + 1 < c1)
      fetch_chunk<D, true, false>(raw, in, base_el, t0 + C,
                                  min(C, sp.S - t0 - C));
    intra_weights<D, THREADS>(sm, tid);
    __syncthreads();
    // out = (r * pre) S0 + A v, a 16x8 tile a warp at a time.
    float* o = out + base_el + static_cast<size_t>(t0) * D;
    for (int nt = warp; nt < NT; nt += WARPS) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tile<D, true, true>(acc, arr + L::RD * L::CH, L::LDR, 1,
                              st + nt * 8, L::LDS, 1);
      mma_tile<C, true, false>(acc, sm + L::AMAT, L::LDA, 1,
                               arr + L::V * L::CH + nt * 8, L::LDR, 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = tile_row(2 * h);
        if (t < n)
          *reinterpret_cast<float2*>(o + t * D + nt * 8 + tile_col(0)) =
              make_float2(acc[2 * h], acc[2 * h + 1]);
      }
    }
    if (c + 1 < c1) {
      __syncthreads();  // every read of S0 is done
      decay_update<D, false>(st, st, sm + L::VEC + D, arr + L::KD * L::CH,
                             arr + L::V * L::CH);
    }
  }
}

// ---- 3. backward ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(Inputs in, bf16* __restrict__ gr, bf16* __restrict__ gk,
           bf16* __restrict__ gv, float* __restrict__ glogw,
           const float* scratch, Spans sp, int BH) {
  using L = Smem<D>;
  constexpr int NT = D / 8;
  constexpr int WALKERS = D / 32;  // warps that walk channels; the rest: gv
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  unsigned char* raw = reinterpret_cast<unsigned char*>(sm);
  float* arr = sm + L::ARR;
  const float* R = arr + L::R * L::CH;
  const float* K = arr + L::K * L::CH;
  const float* V = arr + L::V * L::CH;
  const float* GG = arr + L::G * L::CH;
  float* P1 = arr + L::P1 * L::CH;
  float* P2 = arr + L::P2 * L::CH;
  float* amat = sm + L::AMAT;
  float* bm = sm + L::BMAT;
  const float* U = sm + L::VEC;
  const float* tot = sm + L::VEC + D;
  float* stash = sm + L::STATES;                 // [BWD_CHUNKS] start states
  float* gs = stash + BWD_CHUNKS * L::ST;        // G at the chunk's end
  const int tid = threadIdx.x, warp = tid >> 5, bh = sp.bh();
  const size_t base_el = static_cast<size_t>(bh) * sp.S * D;
  const size_t at = static_cast<size_t>(bh) * sp.nspan + sp.span();
  const size_t n_states = static_cast<size_t>(BH) * sp.nspan * D * D;
  const size_t n_vecs = static_cast<size_t>(BH) * sp.nspan * D;
  if (tid < D) sm[L::VEC + tid] = in.u[static_cast<size_t>(bh) * D + tid];
  for (int i = tid; i < C * L::LDA; i += THREADS) amat[i] = 0.f;
  load_state<D>(stash, scratch + at * D * D);
  load_state<D>(gs, scratch + n_states + n_vecs + at * D * D);
  const int c0 = sp.first(), nc = sp.last() - c0;

  // Forward walk: each chunk's start state into the stash.
  if (nc > 1)
    fetch_chunk<D, false, false>(raw, in, base_el, c0 * C, C);
  for (int i = 0; i + 1 < nc; ++i) {
    wait_chunk();
    unpack_chunk<D, false, false>(raw, sm);
    __syncthreads();
    if (tid < D) chunk_decays<D, false>(raw, sm, nullptr);
    __syncthreads();
    if (i + 2 < nc)
      fetch_chunk<D, false, false>(raw, in, base_el, (c0 + i + 1) * C, C);
    decay_update<D, false>(stash + (i + 1) * L::ST, stash + i * L::ST, tot,
                           arr + L::KD * L::CH, V);
  }

  // Backward walk, a chunk at a time, holding G.  Channel walkers (warps
  // below WALKERS: gr, gk, glogw) run beside the other warps (the tensor-
  // core products, A, gv), which meet at a barrier of their own.
  {
    const int t0 = (c0 + nc - 1) * C;
    if (nc > 1) __syncthreads();  // the staging area is consumed
    fetch_chunk<D, true, true>(raw, in, base_el, t0, min(C, sp.S - t0));
  }
  constexpr int OTHERS = THREADS - WALKERS * 32;
  const int other = tid - WALKERS * 32;
  float* t1s = sm + L::VEC + 3 * D;
  for (int i = nc - 1; i >= 0; --i) {
    const int t0 = (c0 + i) * C, n = min(C, sp.S - t0);
    const float* s0 = stash + i * L::ST;
    wait_chunk();
    unpack_chunk<D, true, true>(raw, sm);
    __syncthreads();
    if (warp < WALKERS) {
      chunk_decays<D, true>(raw, sm, nullptr);
    } else {
      // Bm = g v^T [16,16], P1 = g S0^T, P2 = v G^T [16,D].
      for (int tile = warp - WALKERS; tile < 2 + 2 * NT;
           tile += WARPS - WALKERS) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (tile < 2) {
          mma_tile<D, true, false>(acc, GG, L::LDR, 1, V + tile * 8 * L::LDR,
                                   1, L::LDR);
          store_tile(acc, bm + tile * 8, L::LDA);
        } else if (tile < 2 + NT) {
          const int n0 = (tile - 2) * 8;
          mma_tile<D, true, true>(acc, GG, L::LDR, 1, s0 + n0 * L::LDS, 1,
                                  L::LDS);
          store_tile(acc, P1 + n0, L::LDR);
        } else {
          const int n0 = (tile - 2 - NT) * 8;
          mma_tile<D, false, true>(acc, V, L::LDR, 1, gs + n0 * L::LDS, 1,
                                   L::LDS);
          store_tile(acc, P2 + n0, L::LDR);
        }
      }
      // T1's sum per channel, sum_e G_end S0 (times tot below).
      if (other < D) {
        const int d = other;
        float t1 = 0.f;
        for (int j = 0; j < D; ++j) {
          const int e = (j + d) & (D - 1);
          t1 += gs[d * L::LDS + e] * s0[d * L::LDS + e];
        }
        t1s[d] = t1;
      }
    }
    __syncthreads();
    if (i > 0) fetch_chunk<D, true, true>(raw, in, base_el, t0 - C, C);
    const size_t row0 = base_el + static_cast<size_t>(t0) * D;
    if (warp < WALKERS) {
      // One thread a channel d: gr, gk, glogw.
      const int d = tid;
      const float* PRE = arr + L::PRE * L::CH;
      const float* SUF = arr + L::SUF * L::CH;
      const float* W = arr + L::W * L::CH;
      const float t1 = t1s[d] * tot[d];
      const float ud = U[d];
      float kk[C], ga[C], ka[C], t4[C], ee[C];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int x = t * L::LDR + d;
        const float diag = bm[t * L::LDA + t];
        kk[t] = K[x];
        ga[t] = PRE[x] * P1[x] + ud * kk[t] * diag;
        ka[t] = SUF[x] * P2[x] + ud * R[x] * diag;
        t4[t] = 0.f;
        ee[t] = 0.f;
      }
      // E[t,s] = prod_{s<j<t} w_j, a row at a time.
#pragma unroll
      for (int t = 1; t < C; ++t) {
        const float wp = W[(t - 1) * L::LDR + d];
#pragma unroll
        for (int s = 0; s + 1 < t; ++s) ee[s] *= wp;
        ee[t - 1] = 1.f;
        const float rt = R[t * L::LDR + d];
        float run = 0.f;
#pragma unroll
        for (int s = 0; s < t; ++s) {
          const float x = bm[t * L::LDA + s] * ee[s];
          ga[t] += x * kk[s];
          ka[s] += x * rt;
          run += x * rt * kk[s];
          if (s + 1 < t) t4[s + 1] += run;
        }
      }
      float run = 0.f;  // T2, an exclusive running sum
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int x = t * L::LDR + d;
        t4[t] += run;
        run += kk[t] * SUF[x] * P2[x];
      }
      run = 0.f;        // T3, the same from the chunk's end
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        const int x = t * L::LDR + d;
        if (t < n) {
          const size_t o = row0 + static_cast<size_t>(t) * D + d;
          gr[o] = __float2bfloat16(ga[t]);
          gk[o] = __float2bfloat16(ka[t]);
          glogw[o] = t1 + t4[t] + run;
        }
        run += R[x] * PRE[x] * P1[x];
      }
    } else {
      intra_weights<D, OTHERS>(sm, other);
      asm volatile("bar.sync 1, %0;\n" ::"r"(OTHERS) : "memory");
      // gv = (k * suf) G + A^T g, two 16x8 tiles a warp at a time.
      for (int n0 = 16 * (warp - WALKERS); n0 < D;
           n0 += 16 * (WARPS - WALKERS)) {
        float acc[2][4] = {};
        mma_tiles<D, true, true, 2>(acc, arr + L::KD * L::CH, L::LDR, 1,
                                    gs + n0, L::LDS, 1);
        mma_tiles<C, true, true, 2>(acc, amat, 1, L::LDA, GG + n0, L::LDR,
                                    1);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = tile_row(2 * h);
            if (t < n)
              *reinterpret_cast<__nv_bfloat162*>(
                  gv + row0 + t * D + n0 + 8 * j + tile_col(0)) =
                  __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
          }
      }
    }
    __syncthreads();
    if (i > 0)  // G at the previous chunk's end
      decay_update<D, true>(gs, gs, tot, arr + L::RD * L::CH, GG);
  }
}

// ---- launches ---------------------------------------------------------------

template <typename K>
cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

#define RETURN_IF(err)                       \
  do {                                       \
    const cudaError_t e_ = (err);            \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)

cudaError_t scan(float* scratch, int BH, int nspan, int D, bool backward,
                 float* gu, cudaStream_t stream) {
  const size_t n_states = static_cast<size_t>(BH) * nspan * D * D;
  const size_t n_vecs = static_cast<size_t>(BH) * nspan * D;
  float* adj = scratch + n_states + n_vecs;
  const size_t blocks = (n_states / nspan + SCAN_THREADS - 1) / SCAN_THREADS;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (backward)
    scan_kernel<true><<<grid, SCAN_THREADS, 0, stream>>>(
        scratch, scratch + n_states, adj, adj + n_states, gu, BH, nspan, D);
  else
    scan_kernel<false><<<grid, SCAN_THREADS, 0, stream>>>(
        scratch, scratch + n_states, nullptr, nullptr, nullptr, BH, nspan,
        D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const Inputs& in, float* out, float* scratch, int BH,
                       int S, int span, cudaStream_t stream) {
  const Spans sp{S, (S + span - 1) / span, span / C};
  const unsigned blocks = static_cast<unsigned>(BH) * sp.nspan;
  constexpr int b0 = Smem<D>::bytes(0), b1 = Smem<D>::bytes(1);
  RETURN_IF(allow(span_kernel<D, false>, b0));
  span_kernel<D, false><<<blocks, THREADS, b0, stream>>>(in, scratch, sp, BH);
  RETURN_IF(cudaGetLastError());
  RETURN_IF(scan(scratch, BH, sp.nspan, D, false, nullptr, stream));
  RETURN_IF(allow(fwd_kernel<D>, b1));
  fwd_kernel<D><<<blocks, THREADS, b1, stream>>>(in, out, scratch, sp);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const Inputs& in, bf16* gr, bf16* gk, bf16* gv,
                       float* glogw, float* gu, float* scratch, int BH, int S,
                       int span, cudaStream_t stream) {
  const Spans sp{S, (S + span - 1) / span, span / C};
  const unsigned blocks = static_cast<unsigned>(BH) * sp.nspan;
  constexpr int b0 = Smem<D>::bytes(0);
  constexpr int b3 = Smem<D>::bytes(BWD_CHUNKS + 1);
  RETURN_IF(allow(span_kernel<D, true>, b0));
  span_kernel<D, true><<<blocks, THREADS, b0, stream>>>(in, scratch, sp, BH);
  RETURN_IF(cudaGetLastError());
  RETURN_IF(scan(scratch, BH, sp.nspan, D, true, gu, stream));
  RETURN_IF(allow(bwd_kernel<D>, b3));
  bwd_kernel<D><<<blocks, THREADS, b3, stream>>>(in, gr, gk, gv, glogw,
                                                 scratch, sp, BH);
  return cudaGetLastError();
}

bool valid(int BH, int S, int D, int span) {
  return BH > 0 && S > 0 && (D == 32 || D == 64) && span > 0 &&
         span % C == 0;
}

}  // namespace

extern "C" {

// r, k, v bf16, 16-byte-aligned; scratch: BH * ceil(S/span) * (D*D + D)
// f32.  Returns a cudaError_t: 0 on a successful launch.
int rwkv6_mma_fwd(const void* r, const void* k, const void* v,
                  const void* logw, const void* u, void* out, void* scratch,
                  int BH, int S, int D, int span, void* stream) {
  if (!valid(BH, S, D, span)) return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{static_cast<const bf16*>(r), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const float*>(logw),
                  nullptr, static_cast<const float*>(u)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  return static_cast<int>(D == 64 ? launch_fwd<64>(in, o, sc, BH, S, span, s)
                                  : launch_fwd<32>(in, o, sc, BH, S, span, s));
}

// g f32; gr, gk, gv bf16; glogw, gu f32; scratch: 2 * BH * ceil(S/span) *
// (D*D + D) f32; span at most 64.
int rwkv6_mma_bwd(const void* r, const void* k, const void* v,
                  const void* logw, const void* u, const void* g, void* gr,
                  void* gk, void* gv, void* glogw, void* gu, void* scratch,
                  int BH, int S, int D, int span, void* stream) {
  if (!valid(BH, S, D, span) || span > BWD_CHUNKS * C)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{static_cast<const bf16*>(r), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const float*>(logw),
                  static_cast<const float*>(g), static_cast<const float*>(u)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* r_ = static_cast<bf16*>(gr);
  bf16* k_ = static_cast<bf16*>(gk);
  bf16* v_ = static_cast<bf16*>(gv);
  float* w_ = static_cast<float*>(glogw);
  float* u_ = static_cast<float*>(gu);
  float* sc = static_cast<float*>(scratch);
  return static_cast<int>(
      D == 64 ? launch_bwd<64>(in, r_, k_, v_, w_, u_, sc, BH, S, span, s)
              : launch_bwd<32>(in, r_, k_, v_, w_, u_, sc, BH, S, span, s));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
