// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// No TPU kernel to replace: the JAX package differentiates its attention
// (`_sdpa` / `_sdpa_blocked`, src/repro/models/layers.py) through XLA, and
// its Pallas `flash_attention` has no backward.  This is the backward of the
// forward kernel in flash_attention.cu, for the same function (GQA, bottom-
// right causal mask, optional sliding window; no per-row kv_len):
//
//   q, o, dO [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (contiguous, f32 or bf16),
//   lse f32 [B, Hq, Sq] (the forward's row log-sum-exp)
//   -> dq [B, Hq, Sq, D], dk/dv [B, Hkv, Skv, D] in q's dtype.
//
//   D_i = rowsum(dO_i * O_i)
//   P   = exp(S - lse), S = Q K^T / sqrt(D) (hidden pairs: P = 0)
//   dV  = sum over the G query heads of a kv head of P^T dO
//   dS  = P * (dO V^T - D)
//   dQ  = dS K / sqrt(D),  dK = sum over the G heads of dS^T Q / sqrt(D)
//
// Soft cap (`softcap` c > 0, the forward's): S' = c tanh(S / c) takes the
// place of S in P = exp(S' - lse), and dS = P * (dP - D) * (1 - (S'/c)^2),
// the cap's derivative, before the dQ and dK products; nothing more is
// saved.  As in the forward the cap is a template flag set when c > 0 (the
// uncapped kernels are the code they were); `simt` takes tanhf, the bf16
// variants tanh.approx.f32.
//
// P is recomputed from the forward's own lse (the wgmma forward rounds P to
// bf16 only as the operand of P.V).  Every pass is deterministic: no
// atomics, and every output element is summed in a fixed order, so a repeat
// gives the same bits.
//
// What bounds it: five score-area products (S, dP, dV, dK, dQ), 2 * D FLOPs
// each per visible (query, key) pair and query head.  At qwen2's train
// shape, q [4, 14, 2048, 64] bf16 under a causal mask, that is 75.2 GFLOP,
// 0.076 ms at the bf16 tensor-core peak of 989 TFLOP/s, against 67.6 MB of
// inputs and outputs (0.020 ms at 3.35 TB/s): the tensor cores bound it.
// Three variants, chosen by the wrapper's plan:
//
// `wgmma` (bf16, D = 64, 128 or 256; 16-byte-aligned tensors, as TMA
// needs): four passes.  At D 64 each tile block is one warpgroup of 128
// threads whose thread 0 also issues the copies: no producer warp, so that
// its registers (the dK/dV block needs about 164 a thread) leave room for
// three blocks an SM (the dQ block, about 128, four); a producer warp held
// both at two.  At D 128 and 256 a tile block is two warpgroups (below,
// "two consumer warpgroups"); the passes are the same.
//   1. `rowstat`: eight threads per query row, D_i and lse * log2(e), into
//      f32 rows padded to whole 64-row tiles (rows past Sq hold 0), so a
//      tile's 64 values are one 256-byte bulk copy.
//   2. `dkdv`: one block per (b, q head, 64-key tile), the key tile on the
//      grid's slow axis so that tile 0, which sees the most queries under a
//      causal mask, starts first.  Splitting the G query heads of a kv head
//      over G blocks is the balance: at the train shape 1792 blocks of at
//      most 32 query steps, where `mma` ran 256 blocks of up to 448 (7
//      heads x 64 steps of 32) in one wave that lasted as long as its
//      heaviest block.  K and V stay in shared memory (TMA, once); thread
//      0 streams each 64-query tile of Q and dO (TMA) with its 64 lse and
//      D values (bulk copies) into a two-stage ring on mbarriers, refilling
//      a stage as soon as all 128 threads have released it, so the next
//      tile's loads fly while this tile's products run.  S^T =
//      K Q^T and dP^T = V dO^T are two m64n64k16 wgmma chains from shared
//      memory (both K-major); P^T = exp2(S^T scale log2(e) - lse log2(e))
//      is formed on the first accumulator while the second chain runs,
//      then dS^T = P^T (dP^T - D); both are rounded to bf16 in registers,
//      where the accumulator layout is already the A-fragment layout, for
//      dV += P^T dO and dK += dS^T Q, with dO and Q read again as MN-major
//      B operands from the same swizzled tiles.  The block writes its f32
//      partial dK and dV for one head.
//   3. `reduce`: dK = scale * sum over g = 0 .. G-1 of the partials, dV the
//      same unscaled, in that order, to bf16.  Partials in scratch, not a
//      cluster of G blocks reduced through distributed shared memory: a
//      cluster must be resident at once on one GPC and ties the grid to G
//      (7 for qwen2), while the scratch keeps every block independent for
//      2 x 29.4 MB written and read once at the train shape (about 35 us
//      at 3.35 TB/s).
//   4. `dq`: one block per (b, q head, 64-row tile), heaviest causal tiles
//      first; Q and dO stay in shared memory, K and V tiles stream through
//      the same kind of ring; S = Q K^T and dP = dO V^T as above, then dQ
//      += dS K with dS as the register A operand and K as the MN-major B.
//   Query tiles of a dK/dV block start at a multiple of 64 below the first
//   query that sees its keys, key tiles of a dQ block at a multiple of 64
//   below the first visible key (kernels/flash_attention.py,
//   `bwd_query_range` and `bwd_key_range`); TMA fills rows past Sq or Skv
//   with zeros, and the mask gives their P exactly 0.  Tiles every pair of
//   which is visible skip the mask.
//
// `mma` (bf16, D = 64, the previous design; reached only by a forced
// schedule): three passes, `delta`, then dK/dV blocks of 64 keys per (key
// tile, b, kv head) walking all G heads in 32-query steps, then dQ blocks
// of 64 rows stepping over 32 keys.  The products on mma.sync m16n8k16
// (bf16 operands, f32 sums); the block's own K and V (dQ: Q and dO) stay
// in registers as A fragments, the other side is staged by the threads in
// padded shared memory, row-major and transposed, with no overlap of the
// next tile's loads.
//
// `simt` (f32, and bf16 shapes the tensor-core variants do not take): the
// first design.  The same three passes on 32 x 32 tiles, 128 threads; S and
// dP as f32 FMAs over D read as 16-byte vectors from shared memory (K/V
// rows padded to D + 4 words), P and dS in shared memory, and each thread
// then accumulates a 4 x 4 (x D/64) block of dK and dV (or dQ).  P and dS
// stay f32.  Head dims are padded to DP = 64, 128 or 256 (gemma3's and
// recurrentgemma's D 256: 137 KiB of shared memory a block, so one block
// an SM, and 128 f32 dK/dV accumulators a thread).
//
// Not yet: warp specialisation with setmaxnreg, dQ fused into the dK/dV
// pass, overlap of one step's P^T / dS^T with the next step's S^T at D 128
// and 256 (the two warpgroups meet at one named barrier a step).  At DP
// 256 the dK/dV block takes 231,464 bytes of shared memory (Q and dO
// double-buffered, P^T and dS^T double-buffered), one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BT = 32;          // rows of a query tile, keys of a key tile
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// 16 bytes of T from global memory, widened to f32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& acc) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// Rows [0, n) of a row-major [*, D] matrix at `src` into shared memory rows
// of `ld` floats, DP columns; rows >= n and columns >= D are zero.
template <typename T, int DP>
__device__ void stage(const T* __restrict__ src, int n, int D, float* dst,
                      int ld) {
  constexpr int VEC = 16 / sizeof(T);
  for (int c = threadIdx.x; c < BT * DP / VEC; c += THREADS) {
    const int e = c * VEC;
    const int r = e / DP;
    const int d = e - r * DP;
    float f[VEC];
    if (r < n && d < D) {
      load16(src + static_cast<size_t>(r) * D + d, f);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) f[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) dst[r * ld + d + u] = f[u];
  }
}

// P and dS of one tile: query rows i0 + r (r < n_rows; query i sits at key
// position i + offs), keys j0 + c (c < n_keys).  q_s, do_s: [BT][DP];
// k_s, v_s: [BT][DP + 4].  Thread t owns rows t/16 + 8b and keys
// t%16 + 16a.
template <int DP, bool CAP>
__device__ void scores(const float* q_s, const float* do_s, const float* k_s,
                       const float* v_s, const float* lse_s,
                       const float* delta_s, int i0, int n_rows, int j0,
                       int n_keys, int offs, int causal, int window,
                       float scale, float cap, float* p_s, float* ds_s) {
  constexpr int KS = DP + 4;
  const int jl = threadIdx.x % 16;
  const int il = threadIdx.x / 16;
  float s[4][2], dp[4][2];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int a = 0; a < 2; ++a) { s[b][a] = 0.f; dp[b][a] = 0.f; }
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 kf[2], vf[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      kf[a] = *reinterpret_cast<const float4*>(k_s + (jl + 16 * a) * KS + d);
      vf[a] = *reinterpret_cast<const float4*>(v_s + (jl + 16 * a) * KS + d);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 qf =
          *reinterpret_cast<const float4*>(q_s + (il + 8 * b) * DP + d);
      const float4 of =
          *reinterpret_cast<const float4*>(do_s + (il + 8 * b) * DP + d);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        s[b][a] = dot4(qf, kf[a], s[b][a]);
        dp[b][a] = dot4(of, vf[a], dp[b][a]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int r = il + 8 * b;
    const int i = i0 + r;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int c = jl + 16 * a;
      const int j = j0 + c;
      bool vis = r < n_rows && c < n_keys;
      if (causal) {
        vis = vis && j <= i + offs;
        if (window > 0) vis = vis && i + offs - j < window;
      }
      float x = s[b][a] * scale;
      float dcap = 1.f;                   // d(capped logit) / d(logit)
      if constexpr (CAP) {
        const float t = tanhf(x / cap);
        x = cap * t;
        dcap = 1.f - t * t;
      }
      const float p = vis ? expf(x - lse_s[r]) : 0.f;
      p_s[r * BT + c] = p;
      ds_s[r * BT + c] = vis ? p * (dp[b][a] - delta_s[r]) * dcap : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int D) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o_row = o + row * D;
  const T* d_row = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(o_row[d]), to_f32(d_row[d]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
  if (lane == 0) delta[row] = acc;
}

struct BwdArgs {
  int Hq, Hkv, Sq, Skv, D, causal, window;
  float scale;
  float cap;                  // the soft cap, 0 for none
};

// Shared memory of both tile kernels, in floats.
template <int DP>
constexpr int smem_floats() {
  return 2 * BT * DP + 2 * BT * (DP + 4) + 2 * BT * BT + 2 * BT;
}

template <typename T, int DP, bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, const BwdArgs a) {
  constexpr int KS = DP + 4;
  constexpr int M = DP / 64;              // 4-column groups a thread owns
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + BT * DP;
  float* k_s = do_s + BT * DP;
  float* v_s = k_s + BT * KS;
  float* p_s = v_s + BT * KS;
  float* ds_s = p_s + BT * BT;
  float* lse_s = ds_s + BT * BT;
  float* delta_s = lse_s + BT;

  const int group = a.Hq / a.Hkv;
  const int bk = blockIdx.y;              // b * Hkv + kv head
  const int b = bk / a.Hkv;
  const int kvh = bk % a.Hkv;
  const int j0 = blockIdx.x * BT;         // the heaviest causal tiles first
  const int n_keys = min(BT, a.Skv - j0);
  const int offs = a.Skv - a.Sq;
  const size_t kv_row0 = static_cast<size_t>(bk) * a.Skv + j0;
  stage<T, DP>(k + kv_row0 * a.D, n_keys, a.D, k_s, KS);
  stage<T, DP>(v + kv_row0 * a.D, n_keys, a.D, v_s, KS);

  // Query rows that see any key of this tile (kernels/flash_attention.py,
  // bwd_query_range).
  int q_lo = 0;
  int q_hi = a.Sq;
  if (a.causal) {
    q_lo = max(0, j0 - offs);
    if (a.window > 0)
      q_hi = min(a.Sq, j0 + n_keys - 1 + a.window - offs);
  }

  const int jj = threadIdx.x / 16;        // keys jj + 8 u
  const int cc = threadIdx.x % 16;        // columns 4 cc + 64 m
  float4 acc_k[4][M], acc_v[4][M];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      acc_k[u][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_v[u][m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int g = 0; g < group; ++g) {
    const size_t row0 =
        (static_cast<size_t>(b) * a.Hq + kvh * group + g) * a.Sq;
    for (int i0 = q_lo; i0 < q_hi; i0 += BT) {
      const int n_rows = min(BT, q_hi - i0);
      __syncthreads();                    // the previous tile is consumed
      stage<T, DP>(q + (row0 + i0) * a.D, n_rows, a.D, q_s, DP);
      stage<T, DP>(dout + (row0 + i0) * a.D, n_rows, a.D, do_s, DP);
      if (threadIdx.x < BT) {
        const int r = threadIdx.x;
        lse_s[r] = r < n_rows ? lse[row0 + i0 + r] : 0.f;
        delta_s[r] = r < n_rows ? delta[row0 + i0 + r] : 0.f;
      }
      __syncthreads();
      scores<DP, CAP>(q_s, do_s, k_s, v_s, lse_s, delta_s, i0, n_rows, j0,
                      n_keys, offs, a.causal, a.window, a.scale, a.cap, p_s,
                      ds_s);
      __syncthreads();
      for (int r = 0; r < n_rows; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pv[u] = p_s[r * BT + jj + 8 * u];
          dsv[u] = ds_s[r * BT + jj + 8 * u];
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int col = 4 * cc + 64 * m;
          const float4 of =
              *reinterpret_cast<const float4*>(do_s + r * DP + col);
          const float4 qf =
              *reinterpret_cast<const float4*>(q_s + r * DP + col);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            axpy4(pv[u], of, acc_v[u][m]);
            axpy4(dsv[u], qf, acc_k[u][m]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = jj + 8 * u;
    if (c >= n_keys) continue;
    T* k_row = dk + (kv_row0 + c) * a.D;
    T* v_row = dv + (kv_row0 + c) * a.D;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int col = 4 * cc + 64 * m;
      if (col >= a.D) continue;
      const float4 gk = acc_k[u][m];
      const float4 gv = acc_v[u][m];
      store(gk.x * a.scale, k_row + col);
      store(gk.y * a.scale, k_row + col + 1);
      store(gk.z * a.scale, k_row + col + 2);
      store(gk.w * a.scale, k_row + col + 3);
      store(gv.x, v_row + col);
      store(gv.y, v_row + col + 1);
      store(gv.z, v_row + col + 2);
      store(gv.w, v_row + col + 3);
    }
  }
}

template <typename T, int DP, bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const BwdArgs a) {
  constexpr int KS = DP + 4;
  constexpr int M = DP / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + BT * DP;
  float* k_s = do_s + BT * DP;
  float* v_s = k_s + BT * KS;
  float* p_s = v_s + BT * KS;
  float* ds_s = p_s + BT * BT;
  float* lse_s = ds_s + BT * BT;
  float* delta_s = lse_s + BT;

  const int group = a.Hq / a.Hkv;
  const int bh = blockIdx.y;              // b * Hq + q head
  const int b = bh / a.Hq;
  const int bk = b * a.Hkv + (bh % a.Hq) / group;
  // Row tiles in reverse: under a causal mask the last see the most keys.
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int n_rows = min(BT, a.Sq - i0);
  const int offs = a.Skv - a.Sq;
  const size_t row0 = static_cast<size_t>(bh) * a.Sq + i0;
  stage<T, DP>(q + row0 * a.D, n_rows, a.D, q_s, DP);
  stage<T, DP>(dout + row0 * a.D, n_rows, a.D, do_s, DP);
  if (threadIdx.x < BT) {
    const int r = threadIdx.x;
    lse_s[r] = r < n_rows ? lse[row0 + r] : 0.f;
    delta_s[r] = r < n_rows ? delta[row0 + r] : 0.f;
  }

  // Keys any row of this tile sees (kernels/flash_attention.py,
  // bwd_key_range).
  int k_lo = 0;
  int k_hi = a.Skv;
  if (a.causal) {
    k_hi = min(a.Skv, i0 + n_rows + offs);
    if (a.window > 0) k_lo = max(0, i0 + offs - a.window + 1);
  }

  const int ii = threadIdx.x / 16;        // rows ii + 8 u
  const int cc = threadIdx.x % 16;        // columns 4 cc + 64 m
  float4 acc[4][M];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[u][m] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t kv_base = static_cast<size_t>(bk) * a.Skv;
  for (int j0 = k_lo; j0 < k_hi; j0 += BT) {
    const int n_keys = min(BT, k_hi - j0);
    __syncthreads();                      // the previous tile is consumed
    stage<T, DP>(k + (kv_base + j0) * a.D, n_keys, a.D, k_s, KS);
    stage<T, DP>(v + (kv_base + j0) * a.D, n_keys, a.D, v_s, KS);
    __syncthreads();
    scores<DP, CAP>(q_s, do_s, k_s, v_s, lse_s, delta_s, i0, n_rows, j0,
                    n_keys, offs, a.causal, a.window, a.scale, a.cap, p_s,
                    ds_s);
    __syncthreads();
    for (int c = 0; c < n_keys; ++c) {
      float dsv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) dsv[u] = ds_s[(ii + 8 * u) * BT + c];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 kf =
            *reinterpret_cast<const float4*>(k_s + c * KS + 4 * cc + 64 * m);
#pragma unroll
        for (int u = 0; u < 4; ++u) axpy4(dsv[u], kf, acc[u][m]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ii + 8 * u;
    if (r >= n_rows) continue;
    T* q_row = dq + (row0 + r) * a.D;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int col = 4 * cc + 64 * m;
      if (col >= a.D) continue;
      const float4 g = acc[u][m];
      store(g.x * a.scale, q_row + col);
      store(g.y * a.scale, q_row + col + 1);
      store(g.z * a.scale, q_row + col + 2);
      store(g.w * a.scale, q_row + col + 3);
    }
  }
}

// ---- the mma variant (bf16, D = 64) ----------------------------------------

constexpr int MD = 64;          // the head dim it takes
constexpr int RS = MD + 8;      // row stride (bf16) of a [rows][64] tile
constexpr int TS = 32 + 8;      // row stride of a [64][32] transposed tile
constexpr int MB = 64;          // keys of a dK/dV block; rows of a dQ block
constexpr int MT = 32;          // queries of a dK/dV step; keys of a dQ step

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b: a 16 x 16 (row-major fragment), b 16 x 8 (column fragment).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [0, 16), columns [16 kk, 16 kk + 16) of a
// row-major tile with row stride `ld` (lane: g = lane / 4, t = lane % 4).
__device__ __forceinline__ void load_a(uint32_t (&f)[4],
                                       const __nv_bfloat16* a, int ld,
                                       int kk, int g, int t) {
  const __nv_bfloat16* p = a + g * ld + 16 * kk + 2 * t;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * ld);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * ld + 8);
}

// c[nt] += a (16 x 16 k-step kk) times the B fragments of n-tile nt, for
// B[k][n] stored as m[n][k] with row stride `ld`.
template <int NT>
__device__ __forceinline__ void mma_row(float (&c)[NT][4],
                                        const uint32_t (&a)[4],
                                        const __nv_bfloat16* m, int ld,
                                        int kk, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const __nv_bfloat16* p = m + (8 * nt + g) * ld + 16 * kk + 2 * t;
    mma16816(c[nt], a, ld32(p), ld32(p + 8));
  }
}

// The A fragments of k-step kk taken from accumulators: n-tiles 2 kk and
// 2 kk + 1 of a 16 x 8 NT tile, rounded to bf16.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4],
                                         const float (&c)[NT][4], int kk) {
  f[0] = pack2(c[2 * kk][0], c[2 * kk][1]);
  f[1] = pack2(c[2 * kk][2], c[2 * kk][3]);
  f[2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  f[3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows [0, n) of a [*, 64] bf16 matrix into `dst` ([ROWS][RS]) and, with
// `dst_t`, transposed into [64][TS]; rows >= n are zero.
template <int ROWS>
__device__ void stage_bf16(const __nv_bfloat16* __restrict__ src, int n,
                           __nv_bfloat16* dst, __nv_bfloat16* dst_t) {
  for (int c = threadIdx.x; c < ROWS * MD / 8; c += THREADS) {
    const int r = c / (MD / 8);
    const int d = (c % (MD / 8)) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < n) u = *reinterpret_cast<const uint4*>(src + r * MD + d);
    *reinterpret_cast<uint4*>(dst + r * RS + d) = u;
    if (dst_t) {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst_t[(d + e) * TS + r] = h[e];
    }
  }
}

// P and dS (in place of S and dP) of a warp's 16 x 32 tile: rows
// r0 + g (+ 8) of the tile, columns c0 + 8 nt + 2 t (+ 1).  `key_rows`:
// rows are keys (dK/dV) or queries (dQ); lse/delta index the queries.
template <bool CAP>
__device__ __forceinline__ void mma_softmax_grad(
    float (&s)[4][4], float (&dp)[4][4], bool key_rows, int r0, int n_r,
    int c0, int n_c, int row_pos0, int col_pos0, int offs, int causal,
    int window, float scale, float cap, const float* lse_s,
    const float* delta_s, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1);
      const int c = c0 + 8 * nt + 2 * t + (e & 1);
      const int qi = key_rows ? c : r;          // index into lse_s/delta_s
      const int i = (key_rows ? col_pos0 + c : row_pos0 + r);  // query pos
      const int j = (key_rows ? row_pos0 + r : col_pos0 + c);  // key pos
      bool vis = r < n_r && c < n_c;
      if (causal) {
        vis = vis && j <= i + offs;
        if (window > 0) vis = vis && i + offs - j < window;
      }
      float x = s[nt][e] * scale;
      float dcap = 1.f;
      if constexpr (CAP) {
        const float th = hopper::tanh_approx(x / cap);
        x = cap * th;
        dcap = 1.f - th * th;
      }
      const float p = vis ? expf(x - lse_s[qi]) : 0.f;
      dp[nt][e] = vis ? p * (dp[nt][e] - delta_s[qi]) * dcap : 0.f;
      s[nt][e] = p;
    }
  }
}

template <bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, const BwdArgs a) {
  __shared__ __align__(16) __nv_bfloat16 k_s[MB * RS];
  __shared__ __align__(16) __nv_bfloat16 v_s[MB * RS];
  __shared__ __align__(16) __nv_bfloat16 q_s[MT * RS];
  __shared__ __align__(16) __nv_bfloat16 do_s[MT * RS];
  __shared__ __align__(16) __nv_bfloat16 qt_s[MD * TS];
  __shared__ __align__(16) __nv_bfloat16 dot_s[MD * TS];
  __shared__ float lse_s[MT];
  __shared__ float delta_s[MT];

  const int group = a.Hq / a.Hkv;
  const int bk = blockIdx.y;              // b * Hkv + kv head
  const int b = bk / a.Hkv;
  const int kvh = bk % a.Hkv;
  const int j0 = blockIdx.x * MB;         // the heaviest causal tiles first
  const int n_keys = min(MB, a.Skv - j0);
  const int offs = a.Skv - a.Sq;
  const size_t kv_row0 = static_cast<size_t>(bk) * a.Skv + j0;
  stage_bf16<MB>(k + kv_row0 * MD, n_keys, k_s, nullptr);
  stage_bf16<MB>(v + kv_row0 * MD, n_keys, v_s, nullptr);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  uint32_t kf[MD / 16][4], vf[MD / 16][4];
#pragma unroll
  for (int kk = 0; kk < MD / 16; ++kk) {
    load_a(kf[kk], k_s + warp * 16 * RS, RS, kk, g, t);
    load_a(vf[kk], v_s + warp * 16 * RS, RS, kk, g, t);
  }

  int q_lo = 0;                           // bwd_query_range
  int q_hi = a.Sq;
  if (a.causal) {
    q_lo = max(0, j0 - offs);
    if (a.window > 0)
      q_hi = min(a.Sq, j0 + n_keys - 1 + a.window - offs);
  }

  float acc_k[MD / 8][4], acc_v[MD / 8][4];
#pragma unroll
  for (int nt = 0; nt < MD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) { acc_k[nt][e] = 0.f; acc_v[nt][e] = 0.f; }

  for (int gh = 0; gh < group; ++gh) {
    const size_t row0 =
        (static_cast<size_t>(b) * a.Hq + kvh * group + gh) * a.Sq;
    for (int i0 = q_lo; i0 < q_hi; i0 += MT) {
      const int n_rows = min(MT, q_hi - i0);
      __syncthreads();                    // the previous tile is consumed
      stage_bf16<MT>(q + (row0 + i0) * MD, n_rows, q_s, qt_s);
      stage_bf16<MT>(dout + (row0 + i0) * MD, n_rows, do_s, dot_s);
      if (threadIdx.x < MT) {
        const int r = threadIdx.x;
        lse_s[r] = r < n_rows ? lse[row0 + i0 + r] : 0.f;
        delta_s[r] = r < n_rows ? delta[row0 + i0 + r] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 queries.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) { s[nt][e] = 0.f; dp[nt][e] = 0.f; }
#pragma unroll
      for (int kk = 0; kk < MD / 16; ++kk) {
        mma_row<4>(s, kf[kk], q_s, RS, kk, g, t);
        mma_row<4>(dp, vf[kk], do_s, RS, kk, g, t);
      }
      mma_softmax_grad<CAP>(s, dp, true, warp * 16, n_keys, 0, n_rows, j0,
                            i0, offs, a.causal, a.window, a.scale, a.cap,
                            lse_s, delta_s, g, t);
      // dV += P^T dO, dK += dS^T Q over the 32 queries.
#pragma unroll
      for (int kk = 0; kk < MT / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a<4>(pa, s, kk);
        acc_to_a<4>(da, dp, kk);
        mma_row<MD / 8>(acc_v, pa, dot_s, TS, kk, g, t);
        mma_row<MD / 8>(acc_k, da, qt_s, TS, kk, g, t);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kl = warp * 16 + g + 8 * h;
    if (kl >= n_keys) continue;
    __nv_bfloat16* k_row = dk + (kv_row0 + kl) * MD;
    __nv_bfloat16* v_row = dv + (kv_row0 + kl) * MD;
#pragma unroll
    for (int nt = 0; nt < MD / 8; ++nt) {
      const int col = 8 * nt + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(k_row + col) = __floats2bfloat162_rn(
          acc_k[nt][2 * h] * a.scale, acc_k[nt][2 * h + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(v_row + col) =
          __floats2bfloat162_rn(acc_v[nt][2 * h], acc_v[nt][2 * h + 1]);
    }
  }
}

template <bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, const BwdArgs a) {
  __shared__ __align__(16) __nv_bfloat16 q_s[MB * RS];
  __shared__ __align__(16) __nv_bfloat16 do_s[MB * RS];
  __shared__ __align__(16) __nv_bfloat16 k_s[MT * RS];
  __shared__ __align__(16) __nv_bfloat16 v_s[MT * RS];
  __shared__ __align__(16) __nv_bfloat16 kt_s[MD * TS];
  __shared__ float lse_s[MB];
  __shared__ float delta_s[MB];

  const int group = a.Hq / a.Hkv;
  const int bh = blockIdx.y;              // b * Hq + q head
  const int b = bh / a.Hq;
  const int bk = b * a.Hkv + (bh % a.Hq) / group;
  // Row tiles in reverse: under a causal mask the last see the most keys.
  const int i0 = (gridDim.x - 1 - blockIdx.x) * MB;
  const int n_rows = min(MB, a.Sq - i0);
  const int offs = a.Skv - a.Sq;
  const size_t row0 = static_cast<size_t>(bh) * a.Sq + i0;
  stage_bf16<MB>(q + row0 * MD, n_rows, q_s, nullptr);
  stage_bf16<MB>(dout + row0 * MD, n_rows, do_s, nullptr);
  if (threadIdx.x < MB) {
    const int r = threadIdx.x;
    lse_s[r] = r < n_rows ? lse[row0 + r] : 0.f;
    delta_s[r] = r < n_rows ? delta[row0 + r] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  uint32_t qf[MD / 16][4], of[MD / 16][4];
#pragma unroll
  for (int kk = 0; kk < MD / 16; ++kk) {
    load_a(qf[kk], q_s + warp * 16 * RS, RS, kk, g, t);
    load_a(of[kk], do_s + warp * 16 * RS, RS, kk, g, t);
  }

  int k_lo = 0;                           // bwd_key_range
  int k_hi = a.Skv;
  if (a.causal) {
    k_hi = min(a.Skv, i0 + n_rows + offs);
    if (a.window > 0) k_lo = max(0, i0 + offs - a.window + 1);
  }

  float acc[MD / 8][4];
#pragma unroll
  for (int nt = 0; nt < MD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const size_t kv_base = static_cast<size_t>(bk) * a.Skv;
  for (int j0 = k_lo; j0 < k_hi; j0 += MT) {
    const int n_keys = min(MT, k_hi - j0);
    __syncthreads();                      // the previous tile is consumed
    stage_bf16<MT>(k + (kv_base + j0) * MD, n_keys, k_s, kt_s);
    stage_bf16<MT>(v + (kv_base + j0) * MD, n_keys, v_s, nullptr);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: the warp's 16 rows x 32 keys.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) { s[nt][e] = 0.f; dp[nt][e] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < MD / 16; ++kk) {
      mma_row<4>(s, qf[kk], k_s, RS, kk, g, t);
      mma_row<4>(dp, of[kk], v_s, RS, kk, g, t);
    }
    mma_softmax_grad<CAP>(s, dp, false, warp * 16, n_rows, 0, n_keys, i0,
                          j0, offs, a.causal, a.window, a.scale, a.cap,
                          lse_s, delta_s, g, t);
    // dQ += dS K over the 32 keys.
#pragma unroll
    for (int kk = 0; kk < MT / 16; ++kk) {
      uint32_t da[4];
      acc_to_a<4>(da, dp, kk);
      mma_row<MD / 8>(acc, da, kt_s, TS, kk, g, t);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r >= n_rows) continue;
    __nv_bfloat16* q_row = dq + (row0 + r) * MD;
#pragma unroll
    for (int nt = 0; nt < MD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(q_row + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * h] * a.scale,
                                acc[nt][2 * h + 1] * a.scale);
  }
}

template <bool CAP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       const BwdArgs& a, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const long long rows = static_cast<long long>(B) * a.Hq * a.Sq;
  const long long warps_per_block = THREADS / 32;
  flash_bwd_delta_kernel<bf><<<static_cast<unsigned>(
                                   (rows + warps_per_block - 1) /
                                   warps_per_block),
                               THREADS, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), delta, rows,
      a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Skv + MB - 1) / MB, B * a.Hkv);
  flash_bwd_dkdv_mma_kernel<CAP><<<grid_kv, THREADS, 0, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dk), static_cast<bf*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Sq + MB - 1) / MB, B * a.Hq);
  flash_bwd_dq_mma_kernel<CAP><<<grid_q, THREADS, 0, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), a);
  return cudaGetLastError();
}

template <typename T, int DP, bool CAP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, int B,
                   const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * a.Hq * a.Sq;
  const long long warps_per_block = THREADS / 32;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(
                                  (rows + warps_per_block - 1) /
                                  warps_per_block),
                              THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
      a.D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.Skv + BT - 1) / BT, B * a.Hkv);
  flash_bwd_dkdv_kernel<T, DP, CAP><<<grid_kv, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Sq + BT - 1) / BT, B * a.Hq);
  flash_bwd_dq_kernel<T, DP, CAP><<<grid_q, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T, bool CAP>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dout,
                     void* dq, void* dk, void* dv, float* delta, int B,
                     const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 64)
    return launch<T, 64, CAP>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                              a, stream);
  if (a.D <= 128)
    return launch<T, 128, CAP>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                               a, stream);
  return launch<T, 256, CAP>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, a,
                             stream);
}


// ---- the wgmma variant (bf16, D = 64) --------------------------------------

constexpr int WB = 64;          // keys of a dK/dV block; rows of a dQ block
constexpr int WT = 64;          // queries of a dK/dV step; keys of a dQ step
constexpr int W_STAGES = 2;
constexpr int W_TILE = 64 * hopper::ROW_BYTES;  // 64 rows x 64 bf16, swizzled
constexpr int W_THREADS = 128;     // one warpgroup; thread 0 also copies
constexpr int W_STATS = 2 * WT;      // floats of a stage's lse and D rows
constexpr int W_BARS = 1 + 2 * W_STAGES;
// Shared memory of each tile kernel: two resident tiles, a ring of two
// tiles a stage, the dK/dV ring's row statistics, the barriers, and the
// slack that aligns the base to 1024 bytes.
constexpr int W_SMEM = 2 * W_TILE + 2 * W_STAGES * W_TILE +
                       W_STAGES * W_STATS * 4 + W_BARS * 8 + 1024;
constexpr double LOG2E = 1.4426950408889634;

struct WgArgs {
  const float* lse2;          // [B * Hq, sq_pad]: lse * log2(e)
  const float* delta;         // [B * Hq, sq_pad]: rowsum(dO * O)
  float* part_k;              // [B * Hq, Skv, DP]: each head's dK / scale
  float* part_v;              // [B * Hq, Skv, DP]: each head's dV
  __nv_bfloat16* dq;
  int Hq, Hkv, Sq, Skv, sq_pad, causal, window, q_tiles;
  float scale;                // 1/sqrt(D)
  float scale_log2;           // 1/sqrt(D) * log2(e)
  float cap_in;               // soft cap c: 1/sqrt(D) / c
  float cap_log2;             // c * log2(e)
};

// The base-2 logit of a product s, s / sqrt(D) * log2(e), less the row's
// lse2; with the soft cap c, c tanh(s / sqrt(D) / c) * log2(e) - lse2, and
// `dcap` gets the cap's derivative 1 - tanh^2.
template <bool CAP>
__device__ __forceinline__ float logit2(float s, float lse2,
                                        const WgArgs& a, float& dcap) {
  if constexpr (CAP) {
    const float th = hopper::tanh_approx(s * a.cap_in);
    dcap = 1.f - th * th;
    return th * a.cap_log2 - lse2;
  }
  return s * a.scale_log2 - lse2;
}

// The scratch (floats) the wgmma variant needs: the padded lse and D rows,
// then the partial dK and dV of every query head, DP columns a row.
long long wgmma_scratch_floats(int B, int Hq, int Sq, int Skv, int DP) {
  const long long sq_pad = (Sq + WT - 1) / WT * WT;
  return 2ll * B * Hq * sq_pad + 2ll * B * Hq * Skv * DP;
}

// D and lse * log2(e) of each padded row: eight threads a row, each 16
// bytes of O and of dO at a time, D / 64 times.  rows_pad is a multiple
// of THREADS / 8.
__global__ void __launch_bounds__(THREADS)
flash_bwd_rowstat_kernel(const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ lse2, float* __restrict__ delta,
                         long long rows_pad, int Sq, int sq_pad, int D) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  if (row >= rows_pad) return;
  const long long bh = row / sq_pad;
  const int i = static_cast<int>(row - bh * sq_pad);
  float acc = 0.f;
  if (i < Sq) {
    for (int c = 8 * part; c < D; c += 64) {
      const size_t at = (static_cast<size_t>(bh) * Sq + i) * D + c;
      uint4 ou = *reinterpret_cast<const uint4*>(o + at);
      uint4 du = *reinterpret_cast<const uint4*>(dout + at);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ou);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 a = __bfloat1622float2(o2[u]);
        const float2 b = __bfloat1622float2(d2[u]);
        acc = fmaf(a.y, b.y, fmaf(a.x, b.x, acc));
      }
    }
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
  if (part == 0) {
    delta[row] = acc;
    lse2[row] = i < Sq ? lse[bh * Sq + i] * static_cast<float>(LOG2E) : 0.f;
  }
}

// Is the pair (query i, key j) visible?  Query i sits at key i + offs.
__device__ __forceinline__ bool visible(int i, int j, int Sq, int Skv,
                                        int offs, int causal, int window) {
  bool vis = i < Sq && j < Skv;
  if (causal) {
    vis = vis && j <= i + offs;
    if (window > 0) vis = vis && i + offs - j < window;
  }
  return vis;
}

// Is every pair of queries [i0, i0 + 64) and keys [j0, j0 + 64) visible?
__device__ __forceinline__ bool whole_tile(int i0, int j0, int Sq, int Skv,
                                           int offs, int causal,
                                           int window) {
  return i0 + 63 < Sq && j0 + 63 < Skv &&
         (!causal || (j0 + 63 <= i0 + offs &&
                      (window == 0 || i0 + 63 + offs - j0 < window)));
}

// The 64 x 64 product of two K-major tiles (64 rows of 64 bf16 each),
// d = a b^T, overwriting d: four k-steps of 16 along the rows.
__device__ __forceinline__ void wg_nt(float (&d)[32], const uint8_t* a,
                                      const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::Wgmma<64>::ss<0, 0>(d, hopper::smem_desc(a + kk * 32, 16, 1024),
                                hopper::smem_desc(b + kk * 32, 16, 1024),
                                kk > 0);
}

// A 64 x 64 accumulator tile rounded to bf16 as the A fragments of four
// k-steps: in the accumulator layout, keys (or queries) 16 kt .. 16 kt + 15
// of a thread's rows are f[8 kt .. 8 kt + 7].
__device__ __forceinline__ void to_a(uint32_t (&fa)[4][4],
                                     const float (&f)[32]) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      fa[kt][u] = hopper::pack_bf16(f[8 * kt + 2 * u], f[8 * kt + 2 * u + 1]);
}

// d += A b, A from registers (to_a), b an MN-major tile (64 rows of the
// contraction, 64 bf16 columns each).
__device__ __forceinline__ void wg_acc(float (&d)[32],
                                       const uint32_t (&fa)[4][4],
                                       const uint8_t* b) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
    hopper::Wgmma<64>::rs<1>(
        d, fa[kt],
        hopper::smem_desc(b + kt * 16 * hopper::ROW_BYTES, W_TILE, 1024), 1);
}

template <bool CAP>
__global__ void __launch_bounds__(W_THREADS)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap domap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const WgArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = hopper::align_1024(smem_raw);
  uint8_t* v_s = k_s + W_TILE;
  uint8_t* q_ring = v_s + W_TILE;
  uint8_t* do_ring = q_ring + W_STAGES * W_TILE;
  float* stats = reinterpret_cast<float*>(do_ring + W_STAGES * W_TILE);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + W_STAGES * W_STATS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + W_STAGES;

  const int group = a.Hq / a.Hkv;
  const int bh = blockIdx.x;              // b * Hq + q head
  const int bkv = bh / group;             // b * Hkv + its kv head
  const int j0 = blockIdx.y * WB;         // tile 0, the heaviest, first
  const int n_keys = min(WB, a.Skv - j0);
  const int offs = a.Skv - a.Sq;
  int q_lo = 0;                           // bwd_query_range
  int q_hi = a.Sq;
  if (a.causal) {
    q_lo = max(0, j0 - offs);
    if (a.window > 0)
      q_hi = min(a.Sq, j0 + n_keys - 1 + a.window - offs);
  }
  const int i_first = q_lo / WT * WT;
  const int steps = q_hi > q_lo ? (q_hi - i_first + WT - 1) / WT : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every copy: K and V once, then query tile n into stage
  // n % W_STAGES as soon as all 128 threads have released it.
  int ps = 0;
  uint32_t pphase = 0;
  auto issue = [&](int n) {
    const int i0 = i_first + n * WT;
    hopper::mbar_wait(&empty[ps], pphase ^ 1);
    hopper::mbar_expect_tx(&full[ps], 2 * W_TILE + W_STATS * 4);
    hopper::tma_load_3d(q_ring + ps * W_TILE, &qmap, &full[ps], 0, i0, bh);
    hopper::tma_load_3d(do_ring + ps * W_TILE, &domap, &full[ps], 0, i0, bh);
    const size_t row = static_cast<size_t>(bh) * a.sq_pad + i0;
    hopper::bulk_load(stats + ps * W_STATS, a.lse2 + row, WT * 4, &full[ps]);
    hopper::bulk_load(stats + ps * W_STATS + WT, a.delta + row, WT * 4,
                      &full[ps]);
    if (++ps == W_STAGES) { ps = 0; pphase ^= 1; }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(kv_full, 2 * W_TILE);
    hopper::tma_load_3d(k_s, &kmap, kv_full, 0, j0, bkv);
    hopper::tma_load_3d(v_s, &vmap, kv_full, 0, j0, bkv);
    for (int n = 0; n < min(W_STAGES, steps); ++n) issue(n);
  }
  __syncwarp();  // warp 0 converges before the warpgroup's wgmma

  // Thread tid holds key rows r and r + 8 of the tile (r = 16 warp +
  // lane / 4) and query columns 8 jj + 2 quad + {0, 1}.
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r_own = 16 * (tid / 32) + lane / 4;
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) { acc_k[i] = 0.f; acc_v[i] = 0.f; }

  hopper::mbar_wait(kv_full, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int n = 0; n < steps; ++n) {
    const int i0 = i_first + n * WT;
    hopper::mbar_wait(&full[s], phase);
    const uint8_t* q_s = q_ring + s * W_TILE;
    const uint8_t* do_s = do_ring + s * W_TILE;
    const float* lse_s = stats + s * W_STATS;
    const float* delta_s = lse_s + WT;

    // S^T = K Q^T and dP^T = V dO^T, two groups; P^T forms on the first
    // while the second runs.
    float st[32], dpt[32];
    hopper::wgmma_fence();
    wg_nt(st, k_s, q_s);
    hopper::wgmma_commit();
    wg_nt(dpt, v_s, do_s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(st);
    const bool whole = whole_tile(i0, j0, a.Sq, a.Skv, offs, a.causal,
                                  a.window);
    float dcap[CAP ? 32 : 1];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = logit2<CAP>(st[4 * jj + e], (e & 1) ? l2.y : l2.x,
                                    a, dcap[CAP ? 4 * jj + e : 0]);
        const bool vis = whole || visible(i0 + c + (e & 1),
                                          j0 + r_own + 8 * (e >> 1), a.Sq,
                                          a.Skv, offs, a.causal, a.window);
        st[4 * jj + e] = vis ? exp2f(x) : 0.f;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpt);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_s + 8 * jj + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[4 * jj + e] =
            st[4 * jj + e] * (dpt[4 * jj + e] - ((e & 1) ? dl.y : dl.x));
        if constexpr (CAP) dpt[4 * jj + e] *= dcap[4 * jj + e];
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries; both A
    // operands are packed before either product is issued.
    uint32_t pa[4][4], da[4][4];
    to_a(pa, st);
    to_a(da, dpt);
    hopper::wgmma_fence();
    wg_acc(acc_v, pa, do_s);
    wg_acc(acc_k, da, q_s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    hopper::mbar_arrive(&empty[s]);
    if (tid == 0 && n + W_STAGES < steps) issue(n + W_STAGES);
    __syncwarp();
    if (++s == W_STAGES) { s = 0; phase ^= 1; }
  }

  // This head's f32 partials; `reduce` sums the G heads of a kv head.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + r_own + 8 * h;
    if (j >= a.Skv) continue;
    const size_t at = (static_cast<size_t>(bh) * a.Skv + j) * 64;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * quad;
      *reinterpret_cast<float2*>(a.part_k + at + col) =
          make_float2(acc_k[4 * jj + 2 * h], acc_k[4 * jj + 2 * h + 1]);
      *reinterpret_cast<float2*>(a.part_v + at + col) =
          make_float2(acc_v[4 * jj + 2 * h], acc_v[4 * jj + 2 * h + 1]);
    }
  }
}

// dK and dV of each kv head: the G heads' partials summed in head order,
// four columns a thread (DP columns a row, DP = D).
__global__ void __launch_bounds__(THREADS)
flash_bwd_reduce_kernel(const float* __restrict__ part_k,
                        const float* __restrict__ part_v,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, long long n4,
                        int group, int Skv, int DP, float scale) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= n4) return;
  const long long per_head = static_cast<long long>(Skv) * (DP / 4);
  const long long bkv = idx / per_head;
  const long long rem = idx - bkv * per_head;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sv = sk;
  for (int g = 0; g < group; ++g) {
    const long long at = (bkv * group + g) * per_head + rem;
    const float4 pk = reinterpret_cast<const float4*>(part_k)[at];
    const float4 pv = reinterpret_cast<const float4*>(part_v)[at];
    sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
    sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + 4 * idx);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + 4 * idx);
  k2[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  k2[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
  v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
  v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

template <bool CAP>
__global__ void __launch_bounds__(W_THREADS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const WgArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align_1024(smem_raw);
  uint8_t* do_s = q_s + W_TILE;
  uint8_t* k_ring = do_s + W_TILE;
  uint8_t* v_ring = k_ring + W_STAGES * W_TILE;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(v_ring + W_STAGES * W_TILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + W_STAGES;

  const int group = a.Hq / a.Hkv;
  const int bh = blockIdx.x;              // b * Hq + q head
  const int bkv = bh / group;
  // Row tiles in reverse: under a causal mask the last see the most keys,
  // and they start first.
  const int i0 = (a.q_tiles - 1 - static_cast<int>(blockIdx.y)) * WB;
  const int n_rows = min(WB, a.Sq - i0);
  const int offs = a.Skv - a.Sq;
  int k_lo = 0;                           // bwd_key_range
  int k_hi = a.Skv;
  if (a.causal) {
    k_hi = min(a.Skv, i0 + n_rows + offs);
    if (a.window > 0) k_lo = max(0, i0 + offs - a.window + 1);
  }
  const int t_first = k_lo / WT * WT;
  const int steps = k_hi > k_lo ? (k_hi - t_first + WT - 1) / WT : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every copy: Q and dO once, then key tile n into stage
  // n % W_STAGES as soon as all 128 threads have released it.
  int ps = 0;
  uint32_t pphase = 0;
  auto issue = [&](int n) {
    const int t0 = t_first + n * WT;
    hopper::mbar_wait(&empty[ps], pphase ^ 1);
    hopper::mbar_expect_tx(&full[ps], 2 * W_TILE);
    hopper::tma_load_3d(k_ring + ps * W_TILE, &kmap, &full[ps], 0, t0, bkv);
    hopper::tma_load_3d(v_ring + ps * W_TILE, &vmap, &full[ps], 0, t0, bkv);
    if (++ps == W_STAGES) { ps = 0; pphase ^= 1; }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(q_full, 2 * W_TILE);
    hopper::tma_load_3d(q_s, &qmap, q_full, 0, i0, bh);
    hopper::tma_load_3d(do_s, &domap, q_full, 0, i0, bh);
    for (int n = 0; n < min(W_STAGES, steps); ++n) issue(n);
  }
  __syncwarp();  // warp 0 converges before the warpgroup's wgmma

  // Thread tid holds rows r and r + 8 (r = 16 warp + lane / 4), key
  // columns 8 jj + 2 quad + {0, 1}.
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r_own = 16 * (tid / 32) + lane / 4;
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // rows past Sq read the padding's zeros
    const size_t row = static_cast<size_t>(bh) * a.sq_pad + i0 + r_own +
                       8 * h;
    l2[h] = a.lse2[row];
    dl[h] = a.delta[row];
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  hopper::mbar_wait(q_full, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int n = 0; n < steps; ++n) {
    const int t0 = t_first + n * WT;
    hopper::mbar_wait(&full[s], phase);
    const uint8_t* k_s = k_ring + s * W_TILE;
    const uint8_t* v_s = v_ring + s * W_TILE;

    float sc[32], dp[32];
    hopper::wgmma_fence();
    wg_nt(sc, q_s, k_s);
    hopper::wgmma_commit();
    wg_nt(dp, do_s, v_s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    const bool whole = whole_tile(i0, t0, a.Sq, a.Skv, offs, a.causal,
                                  a.window);
    float dcap[CAP ? 32 : 1];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = logit2<CAP>(sc[4 * jj + e], l2[h], a,
                                    dcap[CAP ? 4 * jj + e : 0]);
        const bool vis = whole || visible(i0 + r_own + 8 * h,
                                          t0 + 8 * jj + 2 * quad + (e & 1),
                                          a.Sq, a.Skv, offs, a.causal,
                                          a.window);
        sc[4 * jj + e] = vis ? exp2f(x) : 0.f;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
      if constexpr (CAP) dp[i] *= dcap[i];
    }

    // dQ += dS K over the tile's 64 keys.
    uint32_t da[4][4];
    to_a(da, dp);
    hopper::wgmma_fence();
    wg_acc(acc, da, k_s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
    if (tid == 0 && n + W_STAGES < steps) issue(n + W_STAGES);
    __syncwarp();
    if (++s == W_STAGES) { s = 0; phase ^= 1; }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + r_own + 8 * h;
    if (i >= a.Sq) continue;
    __nv_bfloat16* q_row = a.dq + (static_cast<size_t>(bh) * a.Sq + i) * 64;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(q_row + 8 * jj + 2 * quad) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * h] * a.scale,
                                acc[4 * jj + 2 * h + 1] * a.scale);
  }
}

// ---- two consumer warpgroups at D = 128 and 256 ----------------------------
//
// One warpgroup cannot hold dK and dV for 64 keys at these widths (DP / 2
// f32 accumulators a thread each: 256 registers at DP 256), so a block has
// two, which split every product so that none is computed twice and no sum
// crosses them: S^T and dP^T (dK/dV block) or S and dP (dQ block) by
// the 64 query (key) columns, 32 each (m64n32k16 chains over DP); P^T and
// dS^T (dS) go to shared memory in bf16, and each warpgroup then
// accumulates its own DP / 2 head columns of dV and dK (dQ), reading them
// there as the A operand (m64n(DP/2)k16).  The tiles in shared memory are
// DP / 64 swizzled 64-column chunks; P^T and dS^T are double-buffered by
// step, so one named barrier a step (after both warpgroups have written
// them) orders the writes against the other warpgroup's reads, which
// completed before it reached that barrier in the step before.

constexpr int W2_THREADS = 256;     // two warpgroups; thread 0 also copies
constexpr int W2_BAR = 1;           // the named barrier of both warpgroups

template <int DP>
struct W2Tile {
  static constexpr int CHUNKS = DP / 64;
  static constexpr int TILE = CHUNKS * W_TILE;  // 64 rows x DP, swizzled
  static constexpr int HALF = DP / 2;           // a warpgroup's head columns
  // dK/dV: K and V, the Q and dO ring, P^T and dS^T twice, the ring's row
  // statistics, the barriers, the alignment slack (231,464 bytes at DP
  // 256, of the 232,448 a block may have).
  static constexpr int SMEM_DKDV = 2 * TILE + 2 * W_STAGES * TILE +
                                   4 * W_TILE + W_STAGES * W_STATS * 4 +
                                   W_BARS * 8 + 1024;
  // dQ: Q and dO, the K and V ring, dS twice, the barriers, the slack.
  static constexpr int SMEM_DQ = 2 * TILE + 2 * W_STAGES * TILE +
                                 2 * W_TILE + W_BARS * 8 + 1024;
};

// d = a b^T over DP columns, overwriting d: a, b K-major DP-wide tiles, b
// from its 32 rows at `b_row` on (m64n32k16, DP / 16 k-steps).
template <int DP>
__device__ __forceinline__ void wg2_nt(float (&d)[16], const uint8_t* a,
                                       const uint8_t* b, int b_row) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * W_TILE + (kk % 4) * 32;
    hopper::Wgmma<32>::ss<0, 0>(
        d, hopper::smem_desc(a + off, 16, 1024),
        hopper::smem_desc(b + off + b_row * hopper::ROW_BYTES, 16, 1024),
        kk > 0);
  }
}

// d += A b[:, cols]: A a 64 x 64 bf16 K-major tile in shared memory, b an
// MN-major DP-wide tile (64 rows of the contraction), cols the HALF
// columns from chunk `chunk` on.
template <int DP>
__device__ __forceinline__ void wg2_acc(float (&d)[DP / 4],
                                        const uint8_t* a, const uint8_t* b,
                                        int chunk) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
    hopper::Wgmma<DP / 2>::template ss<0, 1>(
        d, hopper::smem_desc(a + kt * 32, 16, 1024),
        hopper::smem_desc(b + chunk * W_TILE + kt * 16 * hopper::ROW_BYTES,
                          W_TILE, 1024),
        1);
}

// Two values of an accumulator's row as bf16 into a 64 x 64 K-major
// swizzled tile at (row, col), col even.
__device__ __forceinline__ void put_bf16x2(uint8_t* tile, int row, int col,
                                           float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + row * hopper::ROW_BYTES +
                               (((col / 8) ^ (row % 8)) * 16) +
                               (col % 8) * 2) = hopper::pack_bf16(lo, hi);
}

template <int DP, bool CAP>
__global__ void __launch_bounds__(W2_THREADS, 1)
flash_bwd_dkdv_wg2_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const WgArgs a) {
  using T = W2Tile<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = hopper::align_1024(smem_raw);
  uint8_t* v_s = k_s + T::TILE;
  uint8_t* q_ring = v_s + T::TILE;
  uint8_t* do_ring = q_ring + W_STAGES * T::TILE;
  uint8_t* pds = do_ring + W_STAGES * T::TILE;  // [2 steps][P^T, dS^T]
  float* stats = reinterpret_cast<float*>(pds + 4 * W_TILE);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + W_STAGES * W_STATS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + W_STAGES;

  const int group = a.Hq / a.Hkv;
  const int bh = blockIdx.x;              // b * Hq + q head
  const int bkv = bh / group;             // b * Hkv + its kv head
  const int j0 = blockIdx.y * WB;         // tile 0, the heaviest, first
  const int n_keys = min(WB, a.Skv - j0);
  const int offs = a.Skv - a.Sq;
  int q_lo = 0;                           // bwd_query_range
  int q_hi = a.Sq;
  if (a.causal) {
    q_lo = max(0, j0 - offs);
    if (a.window > 0)
      q_hi = min(a.Sq, j0 + n_keys - 1 + a.window - offs);
  }
  const int i_first = q_lo / WT * WT;
  const int steps = q_hi > q_lo ? (q_hi - i_first + WT - 1) / WT : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W2_THREADS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every copy: K and V once, then query tile n into stage
  // n % W_STAGES as soon as all 256 threads have released it.
  int ps = 0;
  uint32_t pphase = 0;
  auto issue = [&](int n) {
    const int i0 = i_first + n * WT;
    hopper::mbar_wait(&empty[ps], pphase ^ 1);
    hopper::mbar_expect_tx(&full[ps], 2 * T::TILE + W_STATS * 4);
    for (int c = 0; c < T::CHUNKS; ++c) {
      hopper::tma_load_3d(q_ring + ps * T::TILE + c * W_TILE, &qmap,
                          &full[ps], 64 * c, i0, bh);
      hopper::tma_load_3d(do_ring + ps * T::TILE + c * W_TILE, &domap,
                          &full[ps], 64 * c, i0, bh);
    }
    const size_t row = static_cast<size_t>(bh) * a.sq_pad + i0;
    hopper::bulk_load(stats + ps * W_STATS, a.lse2 + row, WT * 4, &full[ps]);
    hopper::bulk_load(stats + ps * W_STATS + WT, a.delta + row, WT * 4,
                      &full[ps]);
    if (++ps == W_STAGES) { ps = 0; pphase ^= 1; }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(kv_full, 2 * T::TILE);
    for (int c = 0; c < T::CHUNKS; ++c) {
      hopper::tma_load_3d(k_s + c * W_TILE, &kmap, kv_full, 64 * c, j0, bkv);
      hopper::tma_load_3d(v_s + c * W_TILE, &vmap, kv_full, 64 * c, j0, bkv);
    }
    for (int n = 0; n < min(W_STAGES, steps); ++n) issue(n);
  }
  __syncwarp();  // warp 0 converges before the warpgroup's wgmma

  // Warpgroup wg: query columns 32 wg .. 32 wg + 31 of S^T and dP^T, head
  // columns wg * HALF .. + HALF - 1 of dK and dV.  Thread tid holds key
  // rows r and r + 8 of the tile (r = 16 warp + lane / 4); in S^T the
  // query columns 32 wg + 8 jj + 2 quad + {0, 1}.
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r_own = 16 * (tid / 32) + lane / 4;
  float acc_k[DP / 4], acc_v[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) { acc_k[i] = 0.f; acc_v[i] = 0.f; }

  hopper::mbar_wait(kv_full, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int n = 0; n < steps; ++n) {
    const int i0 = i_first + n * WT;
    hopper::mbar_wait(&full[s], phase);
    const uint8_t* q_s = q_ring + s * T::TILE;
    const uint8_t* do_s = do_ring + s * T::TILE;
    const float* lse_s = stats + s * W_STATS;
    const float* delta_s = lse_s + WT;
    uint8_t* pt_s = pds + (n & 1) * 2 * W_TILE;
    uint8_t* dst_s = pt_s + W_TILE;

    float st[16], dpt[16];
    hopper::wgmma_fence();
    wg2_nt<DP>(st, k_s, q_s, 32 * wg);
    hopper::wgmma_commit();
    wg2_nt<DP>(dpt, v_s, do_s, 32 * wg);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(st);
    const bool whole = whole_tile(i0, j0, a.Sq, a.Skv, offs, a.causal,
                                  a.window);
    float dcap[CAP ? 16 : 1];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = 32 * wg + 8 * jj + 2 * quad;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = logit2<CAP>(st[4 * jj + e], (e & 1) ? l2.y : l2.x,
                                    a, dcap[CAP ? 4 * jj + e : 0]);
        const bool vis = whole || visible(i0 + c + (e & 1),
                                          j0 + r_own + 8 * (e >> 1), a.Sq,
                                          a.Skv, offs, a.causal, a.window);
        st[4 * jj + e] = vis ? exp2f(x) : 0.f;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpt);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = 32 * wg + 8 * jj + 2 * quad;
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h;
        float d0 = st[4 * jj + e] * (dpt[4 * jj + e] - dl.x);
        float d1 = st[4 * jj + e + 1] * (dpt[4 * jj + e + 1] - dl.y);
        if constexpr (CAP) {
          d0 *= dcap[4 * jj + e];
          d1 *= dcap[4 * jj + e + 1];
        }
        put_bf16x2(pt_s, r_own + 8 * h, c, st[4 * jj + e],
                   st[4 * jj + e + 1]);
        put_bf16x2(dst_s, r_own + 8 * h, c, d0, d1);
      }
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(W2_BAR, W2_THREADS);

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries, on this
    // warpgroup's head columns.
    hopper::wgmma_fence();
    wg2_acc<DP>(acc_v, pt_s, do_s, wg * T::CHUNKS / 2);
    wg2_acc<DP>(acc_k, dst_s, q_s, wg * T::CHUNKS / 2);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    hopper::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && n + W_STAGES < steps) issue(n + W_STAGES);
    __syncwarp();
    if (++s == W_STAGES) { s = 0; phase ^= 1; }
  }

  // This head's f32 partials; `reduce` sums the G heads of a kv head.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + r_own + 8 * h;
    if (j >= a.Skv) continue;
    const size_t at = (static_cast<size_t>(bh) * a.Skv + j) * DP +
                      wg * T::HALF;
#pragma unroll
    for (int jj = 0; jj < T::HALF / 8; ++jj) {
      const int col = 8 * jj + 2 * quad;
      *reinterpret_cast<float2*>(a.part_k + at + col) =
          make_float2(acc_k[4 * jj + 2 * h], acc_k[4 * jj + 2 * h + 1]);
      *reinterpret_cast<float2*>(a.part_v + at + col) =
          make_float2(acc_v[4 * jj + 2 * h], acc_v[4 * jj + 2 * h + 1]);
    }
  }
}

template <int DP, bool CAP>
__global__ void __launch_bounds__(W2_THREADS, 1)
flash_bwd_dq_wg2_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const WgArgs a) {
  using T = W2Tile<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align_1024(smem_raw);
  uint8_t* do_s = q_s + T::TILE;
  uint8_t* k_ring = do_s + T::TILE;
  uint8_t* v_ring = k_ring + W_STAGES * T::TILE;
  uint8_t* ds_buf = v_ring + W_STAGES * T::TILE;  // [2 steps] dS
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ds_buf + 2 * W_TILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + W_STAGES;

  const int group = a.Hq / a.Hkv;
  const int bh = blockIdx.x;              // b * Hq + q head
  const int bkv = bh / group;
  // Row tiles in reverse: under a causal mask the last see the most keys,
  // and they start first.
  const int i0 = (a.q_tiles - 1 - static_cast<int>(blockIdx.y)) * WB;
  const int n_rows = min(WB, a.Sq - i0);
  const int offs = a.Skv - a.Sq;
  int k_lo = 0;                           // bwd_key_range
  int k_hi = a.Skv;
  if (a.causal) {
    k_hi = min(a.Skv, i0 + n_rows + offs);
    if (a.window > 0) k_lo = max(0, i0 + offs - a.window + 1);
  }
  const int t_first = k_lo / WT * WT;
  const int steps = k_hi > k_lo ? (k_hi - t_first + WT - 1) / WT : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W2_THREADS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every copy: Q and dO once, then key tile n into stage
  // n % W_STAGES as soon as all 256 threads have released it.
  int ps = 0;
  uint32_t pphase = 0;
  auto issue = [&](int n) {
    const int t0 = t_first + n * WT;
    hopper::mbar_wait(&empty[ps], pphase ^ 1);
    hopper::mbar_expect_tx(&full[ps], 2 * T::TILE);
    for (int c = 0; c < T::CHUNKS; ++c) {
      hopper::tma_load_3d(k_ring + ps * T::TILE + c * W_TILE, &kmap,
                          &full[ps], 64 * c, t0, bkv);
      hopper::tma_load_3d(v_ring + ps * T::TILE + c * W_TILE, &vmap,
                          &full[ps], 64 * c, t0, bkv);
    }
    if (++ps == W_STAGES) { ps = 0; pphase ^= 1; }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(q_full, 2 * T::TILE);
    for (int c = 0; c < T::CHUNKS; ++c) {
      hopper::tma_load_3d(q_s + c * W_TILE, &qmap, q_full, 64 * c, i0, bh);
      hopper::tma_load_3d(do_s + c * W_TILE, &domap, q_full, 64 * c, i0,
                          bh);
    }
    for (int n = 0; n < min(W_STAGES, steps); ++n) issue(n);
  }
  __syncwarp();  // warp 0 converges before the warpgroup's wgmma

  // Warpgroup wg: key columns 32 wg .. 32 wg + 31 of S and dP, head
  // columns wg * HALF .. + HALF - 1 of dQ.  Thread tid holds rows r and
  // r + 8 (r = 16 warp + lane / 4), key columns 32 wg + 8 jj + 2 quad +
  // {0, 1}.
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r_own = 16 * (tid / 32) + lane / 4;
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // rows past Sq read the padding's zeros
    const size_t row = static_cast<size_t>(bh) * a.sq_pad + i0 + r_own +
                       8 * h;
    l2[h] = a.lse2[row];
    dl[h] = a.delta[row];
  }
  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;

  hopper::mbar_wait(q_full, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int n = 0; n < steps; ++n) {
    const int t0 = t_first + n * WT;
    hopper::mbar_wait(&full[s], phase);
    const uint8_t* k_s = k_ring + s * T::TILE;
    const uint8_t* v_s = v_ring + s * T::TILE;
    uint8_t* ds_s = ds_buf + (n & 1) * W_TILE;

    float sc[16], dp[16];
    hopper::wgmma_fence();
    wg2_nt<DP>(sc, q_s, k_s, 32 * wg);
    hopper::wgmma_commit();
    wg2_nt<DP>(dp, do_s, v_s, 32 * wg);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    const bool whole = whole_tile(i0, t0, a.Sq, a.Skv, offs, a.causal,
                                  a.window);
    float dcap[CAP ? 16 : 1];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = logit2<CAP>(sc[4 * jj + e], l2[h], a,
                                    dcap[CAP ? 4 * jj + e : 0]);
        const bool vis = whole || visible(
            i0 + r_own + 8 * h, t0 + 32 * wg + 8 * jj + 2 * quad + (e & 1),
            a.Sq, a.Skv, offs, a.causal, a.window);
        sc[4 * jj + e] = vis ? exp2f(x) : 0.f;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h;
        float d0 = sc[4 * jj + e] * (dp[4 * jj + e] - dl[h]);
        float d1 = sc[4 * jj + e + 1] * (dp[4 * jj + e + 1] - dl[h]);
        if constexpr (CAP) {
          d0 *= dcap[4 * jj + e];
          d1 *= dcap[4 * jj + e + 1];
        }
        put_bf16x2(ds_s, r_own + 8 * h, 32 * wg + 8 * jj + 2 * quad, d0, d1);
      }
    hopper::fence_proxy_async();
    hopper::bar_sync(W2_BAR, W2_THREADS);

    // dQ += dS K over the tile's 64 keys, on this warpgroup's columns.
    hopper::wgmma_fence();
    wg2_acc<DP>(acc, ds_s, k_s, wg * T::CHUNKS / 2);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && n + W_STAGES < steps) issue(n + W_STAGES);
    __syncwarp();
    if (++s == W_STAGES) { s = 0; phase ^= 1; }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + r_own + 8 * h;
    if (i >= a.Sq) continue;
    __nv_bfloat16* q_row =
        a.dq + (static_cast<size_t>(bh) * a.Sq + i) * DP + wg * T::HALF;
#pragma unroll
    for (int jj = 0; jj < T::HALF / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(q_row + 8 * jj + 2 * quad) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * h] * a.scale,
                                acc[4 * jj + 2 * h + 1] * a.scale);
  }
}

template <int DP, bool CAP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* o, const float* lse, const void* dout,
                         void* dq, void* dk, void* dv, float* scratch, int B,
                         const BwdArgs& a, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  // One warpgroup a tile block at DP 64, two at 128 and 256.
  constexpr bool ONE = DP == 64;
  constexpr int BLOCK_THREADS = ONE ? W_THREADS : W2_THREADS;
  constexpr int SMEM_DKDV = ONE ? W_SMEM : W2Tile<DP>::SMEM_DKDV;
  constexpr int SMEM_DQ = ONE ? W_SMEM : W2Tile<DP>::SMEM_DQ;
  const void* dkdv_fn;
  const void* dq_fn;
  if constexpr (ONE) {
    dkdv_fn =
        reinterpret_cast<const void*>(flash_bwd_dkdv_wgmma_kernel<CAP>);
    dq_fn = reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<CAP>);
  } else {
    dkdv_fn =
        reinterpret_cast<const void*>(flash_bwd_dkdv_wg2_kernel<DP, CAP>);
    dq_fn = reinterpret_cast<const void*>(flash_bwd_dq_wg2_kernel<DP, CAP>);
  }
  const int sq_pad = (a.Sq + WT - 1) / WT * WT;
  const long long rows_pad = static_cast<long long>(B) * a.Hq * sq_pad;
  float* lse2 = scratch;
  float* delta = lse2 + rows_pad;
  float* part_k = delta + rows_pad;
  float* part_v = part_k + static_cast<long long>(B) * a.Hq * a.Skv * DP;
  // q/dO [B * Hq, Sq, DP] and k/v [B * Hkv, Skv, DP], boxes of 64 columns
  // x 64 rows.
  constexpr uint64_t ROW = DP * 2;
  CUtensorMap qmap, domap, kmap, vmap;
  const uint64_t bhq = static_cast<uint64_t>(B) * a.Hq;
  const uint64_t bhkv = static_cast<uint64_t>(B) * a.Hkv;
  cudaError_t err = hopper::tensor_map_3d(&qmap, q, DP, a.Sq, bhq, ROW,
                                          ROW * a.Sq, WT);
  if (err == cudaSuccess)
    err = hopper::tensor_map_3d(&domap, dout, DP, a.Sq, bhq, ROW,
                                ROW * a.Sq, WT);
  if (err == cudaSuccess)
    err = hopper::tensor_map_3d(&kmap, k, DP, a.Skv, bhkv, ROW,
                                ROW * a.Skv, WT);
  if (err == cudaSuccess)
    err = hopper::tensor_map_3d(&vmap, v, DP, a.Skv, bhkv, ROW,
                                ROW * a.Skv, WT);
  if (err != cudaSuccess) return err;
  static bool dkdv_smem[hopper::MAX_DEVICES] = {};
  static bool dq_smem[hopper::MAX_DEVICES] = {};
  err = hopper::allow_smem(dkdv_fn, SMEM_DKDV, dkdv_smem);
  if (err != cudaSuccess) return err;
  err = hopper::allow_smem(dq_fn, SMEM_DQ, dq_smem);
  if (err != cudaSuccess) return err;

  flash_bwd_rowstat_kernel<<<static_cast<unsigned>(rows_pad / (THREADS / 8)),
                             THREADS, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, lse2,
      delta, rows_pad, a.Sq, sq_pad, DP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const WgArgs w{lse2, delta, part_k, part_v, static_cast<bf*>(dq),
                 a.Hq, a.Hkv, a.Sq, a.Skv, sq_pad, a.causal, a.window,
                 sq_pad / WB, a.scale,
                 static_cast<float>(LOG2E * static_cast<double>(a.scale)),
                 a.cap > 0.f ? a.scale / a.cap : 0.f,
                 static_cast<float>(a.cap * LOG2E)};
  const dim3 grid_kv(static_cast<unsigned>(bhq), (a.Skv + WB - 1) / WB);
  if constexpr (ONE)
    flash_bwd_dkdv_wgmma_kernel<CAP><<<grid_kv, BLOCK_THREADS, SMEM_DKDV,
                                       stream>>>(qmap, domap, kmap, vmap, w);
  else
    flash_bwd_dkdv_wg2_kernel<DP, CAP><<<grid_kv, BLOCK_THREADS, SMEM_DKDV,
                                         stream>>>(qmap, domap, kmap, vmap,
                                                   w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(bhkv) * a.Skv * (DP / 4);
  flash_bwd_reduce_kernel<<<static_cast<unsigned>((n4 + THREADS - 1) /
                                                  THREADS),
                            THREADS, 0, stream>>>(
      part_k, part_v, static_cast<bf*>(dk), static_cast<bf*>(dv), n4,
      a.Hq / a.Hkv, a.Skv, DP, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>(bhq), sq_pad / WB);
  if constexpr (ONE)
    flash_bwd_dq_wgmma_kernel<CAP><<<grid_q, BLOCK_THREADS, SMEM_DQ,
                                     stream>>>(qmap, domap, kmap, vmap, w);
  else
    flash_bwd_dq_wg2_kernel<DP, CAP><<<grid_q, BLOCK_THREADS, SMEM_DQ,
                                       stream>>>(qmap, domap, kmap, vmap, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; q, k, v, o, dout, dq, dk, dv contiguous
// and 16-byte aligned, D a multiple of 8 up to 256.  lse: the forward's f32
// [B*Hq*Sq].  scratch: f32, `scratch_floats` of them, 16-byte aligned: D
// (B*Hq*Sq floats) for simt and mma; for wgmma the padded lse and D rows
// and each query head's partial dK and dV (wgmma_scratch_floats).  variant:
// 0 = simt, 1 = mma (bf16, D = 64), 2 = wgmma (bf16, D = 64, 128 or 256).
// block, step, dp: the wrapper's schedule (keys of a dK/dV block and rows
// of a dQ block; queries of a dK/dV step and keys of a dQ step; the padded
// head dim), which must be the variant's own: simt BT, BT and 64, 128 or
// 256, mma MB, MT and 64, wgmma WB, WT and D.  Three kernels on `stream`
// (wgmma: four).
// softcap > 0: the forward capped its logits at softcap * tanh(s /
// softcap).
// Returns a cudaError_t: 0 on a successful launch, cudaErrorInvalidValue
// for a shape, variant, schedule, scratch or alignment the kernels do not
// take.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* scratch,
                        long long scratch_floats, int B, int Hq, int Hkv,
                        int Sq, int Skv, int D, int dtype, int causal,
                        int window, int variant, int block, int step, int dp,
                        float softcap, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hkv ||
      D <= 0 || D % 8 || D > MAX_D || window < 0 || B * Hq > 65535 ||
      (causal && Sq > Skv) || !lse || !scratch || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{Hq, Hkv, Sq, Skv, D, causal, window,
                  static_cast<float>(1.0 / sqrt(static_cast<double>(D))),
                  softcap};
  const bool cap = softcap > 0.f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
      reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(scratch);
  if (any % 16 || reinterpret_cast<uintptr_t>(lse) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 2) {
    // TMA reads q, dO, k and v as [rows, D] bf16 in boxes of 64 columns
    // from 16-byte-aligned bases; the grid's y axis holds the tiles.
    if (dtype != 1 || (D != 64 && D != 128 && D != 256) || block != WB ||
        step != WT || dp != D ||
        scratch_floats < wgmma_scratch_floats(B, Hq, Sq, Skv, D) ||
        (Sq + WB - 1) / WB > 65535 || (Skv + WB - 1) / WB > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t (*launch)(const void*, const void*, const void*, const void*,
                          const float*, const void*, void*, void*, void*,
                          float*, int, const BwdArgs&, cudaStream_t) =
        cap ? (D == 64 ? launch_wgmma<64, true>
                       : D == 128 ? launch_wgmma<128, true>
                                  : launch_wgmma<256, true>)
            : (D == 64 ? launch_wgmma<64, false>
                       : D == 128 ? launch_wgmma<128, false>
                                  : launch_wgmma<256, false>);
    return static_cast<int>(launch(q, k, v, o, lse, dout, dq, dk, dv,
                                   scratch, B, a, s));
  }
  if (scratch_floats < static_cast<long long>(B) * Hq * Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    if (dtype != 1 || D != MD || block != MB || step != MT || dp != MD)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>((cap ? launch_mma<true> : launch_mma<false>)(
        q, k, v, o, lse, dout, dq, dk, dv, scratch, B, a, s));
  }
  if (variant != 0 || block != BT || step != BT ||
      dp != (D <= 64 ? 64 : D <= 128 ? 128 : 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto simt = dtype == 0
      ? (cap ? launch_d<float, true> : launch_d<float, false>)
      : (cap ? launch_d<__nv_bfloat16, true>
             : launch_d<__nv_bfloat16, false>);
  return static_cast<int>(simt(q, k, v, o, lse, dout, dq, dk, dv, scratch,
                               B, a, s));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
