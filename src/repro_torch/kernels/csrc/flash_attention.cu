// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`): the same
// function, not its block schedule.
//
//   q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (contiguous, f32 or bf16)
//   -> out [B, Hq, Sq, D] in q's dtype.
//
// Online softmax with the running max, sum and output accumulator in f32.
// GQA maps query head h to kv head h / (Hq / Hkv).  Logits are
// 1/sqrt(D) q.k in f32.  Causal masking is bottom-right aligned (query i
// sits at key position i + L - Sq), with an optional sliding window; keys
// past the sequence length are masked and their V rows zeroed; the sum is
// clamped at 1e-20.  One argument is added to the TPU kernel's: an optional
// `kv_len` int32 [B].  Row b then attends over its first kv_len[b] keys with
// causal offset kv_len[b] - Sq, exactly as if k and v were cut to that
// length; this is the TPU kernel's padding mask made per row, which
// per-slot decode needs.  A query row with no visible key writes zeros.
// When the caller passes `lse` (f32 [B, Hq, Sq]), each row also writes the
// natural log-sum-exp of its scaled logits, m + log(l), which the backward
// kernels (flash_attention_bwd.cu) recompute the probabilities from; such a
// call never splits the key range.
// The rows that share one (batch, kv head) are ordered (query position,
// head within the group), so a decode step (Sq = 1) puts a whole GQA group
// in one block and reads its K/V once, not once per query head.  Tiles that
// every row of a block masks out (above the causal diagonal, before the
// window, past the length) are never loaded.  Two variants, chosen by the
// wrapper's plan before the launch; the C entry point refuses a variant it
// cannot take, and nothing falls back.
//
// `wgmma` (bf16, D in {32, 64, 128, 256}, 16-byte-aligned bases).  What
// bounds it: decode reads a few hundred KB of K/V (microseconds at 3.35
// TB/s) and is bound by latency on a grid of B * Hkv blocks; prefill and
// training are bound by the tensor cores.  The design: a block is one
// consumer warpgroup that owns 64 query rows and one producer warp; the
// heaviest causal row tiles start first.  At D 256 a block of more than 64
// rows' work (gemma3-1b's and recurrentgemma-2b's train and prefill calls)
// is two consumer warpgroups of 64 rows each, 128 a block, as FA3 has it:
// they share every K/V tile (Q 64 KiB, a stage of K and V 64 KiB, two
// stages: 193 KiB of shared memory), each holds its 64 x 256 f32 output in
// registers (128 a thread, 237 in all, no spill), thread 0 issues the
// copies, a consumer skips the tiles its own rows cannot see, and the ring
// refills a stage once both have released it; decode at D 256 (4 or 10
// rows) keeps the one-warpgroup block and the split keys.  Q is staged once, zero-padded, in 128-byte-swizzled shared
// memory; one producer thread streams 64-key K and V tiles by TMA into a
// two-stage ring guarded by mbarriers (TMA fills keys past Skv, and head
// dims past D = 32, with zeros).  S = Q K^T is one m64n64 wgmma chain from
// shared memory; the scale is applied to S in f32; the mask and the online
// softmax run on the accumulator's registers (each row's max is reduced
// over the four threads that hold it; tiles that every row sees whole skip
// the mask); P is rounded to bf16, as the Pallas kernel rounds it to v's
// dtype before P.V, and O += P V is a wgmma with P as the register A
// operand and V (D-contiguous) as the MN-major B operand (m64n256k16 at D
// 256).  V rows between
// kv_len and Skv are zeroed in shared memory, since 0 x junk is NaN.  When
// B * Hkv * (row tiles) is far below the 132 SMs, the plan splits the key
// range over blocks (flash-decoding): each block writes f32 partials (row
// max, sum, unnormalised output) to scratch the wrapper allocates, and the
// last block of each (b, kv head, row tile) to take an atomic ticket
// combines them in the same launch and resets the ticket.
//
// `simt` (f32, and bf16 head dims the wgmma variant does not take): the
// first design.  One warp per query row, blocks of 8 rows; 32-key K/V tiles
// staged in shared memory as f32 with 16-byte loads; for q.k each lane owns
// one key of the tile (K rows padded to an odd word stride, so the lanes
// hit 32 different banks), and for P.V each lane owns the columns d = lane
// + 32c of the output row.  All arithmetic is f32 FMAs on the CUDA cores
// (no TF32, which would change the f32 function); P stays f32.
//
// Soft cap (`softcap` c > 0, Gemma 2's attention-logit soft-capping, the
// JAX model's `logit_softcap`): every scaled logit s becomes c tanh(s / c)
// before the mask and the softmax, and the saved LSE is that of the capped
// logits.  The cap is a template flag that the entry point sets when c > 0,
// so the uncapped kernels are the code they were.  `simt` takes tanhf (its
// f32 results are held to 2e-5); `wgmma` takes tanh.approx.f32 (2^-11
// relative), between the scale and the base-2 factor it folds into one
// multiply without a cap.
//
// Not yet: a persistent schedule, warp specialisation with setmaxnreg,
// overlap of one tile's softmax with the next tile's wgmma (at D 256 the
// two consumers overlap only as the scheduler interleaves them; no
// ping-pong barriers), strided K/V reads (the model layout still needs
// three copies before the call).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;        // query rows per block
constexpr int TK = 32;          // keys per tile: one per lane in q.k
constexpr int MAX_D = 256;
constexpr int MAX_C = MAX_D / 32;  // output columns per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename T, bool CAP>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ out, float* __restrict__ lse, int Hq,
                 int Hkv, int Sq, int Skv, int D, int causal, int window,
                 float scale, float cap) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int kstride = D + 1;            // odd word stride: conflict-free q.k
  float* k_s = smem;                    // [TK][D + 1]
  float* v_s = k_s + TK * kstride;      // [TK][D]
  float* q_s = v_s + TK * D;            // [WARPS][D], pre-scaled

  const int group = Hq / Hkv;
  const int rows = group * Sq;          // query rows of this (b, kv head)
  const int bk = blockIdx.y;            // b * Hkv + kv head
  const int b = bk / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * WARPS;
  const int row = row0 + warp;
  const bool live = row < rows;
  const int i = (live ? row : row0) / group;                 // query position
  const int h = (bk % Hkv) * group + (live ? row : row0) % group;

  const int L = kv_len ? min(max(kv_len[b], 0), Skv) : Skv;
  const int offs = L - Sq;              // query i sits at key i + offs
  const int qpos = i + offs;

  // Key range any row of this block can see; tiles outside it are skipped.
  const int i_lo = row0 / group;
  const int i_hi = (min(row0 + WARPS, rows) - 1) / group;
  int kv_end = L;
  int kv_begin = 0;
  if (causal) {
    kv_end = max(0, min(L, i_hi + offs + 1));
    if (window > 0) kv_begin = max(0, i_lo + offs - window + 1);
  }

  float* qw = q_s + warp * D;
  if (live) {
    const T* q_row = q + ((static_cast<size_t>(b) * Hq + h) * Sq + i) * D;
    for (int d = lane; d < D; d += 32) qw[d] = to_f32(q_row[d]) * scale;
  }

  const T* k_base = k + static_cast<size_t>(bk) * Skv * D;
  const T* v_base = v + static_cast<size_t>(bk) * Skv * D;
  float m = -INFINITY;
  float l = 0.f;
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.f;

  for (int t0 = (kv_begin / TK) * TK; t0 < kv_end; t0 += TK) {
    const int n = min(TK, L - t0);      // keys of this tile below the length
    __syncthreads();                    // the previous tile is consumed
    for (int c = threadIdx.x; c < TK * D / VEC; c += blockDim.x) {
      const int e = c * VEC;
      const int j = e / D;
      const int d = e - j * D;
      float kf[VEC], vf[VEC];
      if (j < n) {
        load16(k_base + static_cast<size_t>(t0 + j) * D + d, kf);
        load16(v_base + static_cast<size_t>(t0 + j) * D + d, vf);
      } else {                          // padded rows: zero, never junk
#pragma unroll
        for (int u = 0; u < VEC; ++u) { kf[u] = 0.f; vf[u] = 0.f; }
      }
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        k_s[j * kstride + d + u] = kf[u];
        v_s[j * D + d + u] = vf[u];
      }
    }
    __syncthreads();
    if (!live) continue;

    const int key = t0 + lane;
    bool vis = lane < n;
    if (causal) {
      vis = vis && key <= qpos;
      if (window > 0) vis = vis && qpos - key < window;
    }
    float s = -INFINITY;
    if (vis) {
      float dot = 0.f;
      const float* kr = k_s + lane * kstride;
      for (int d = 0; d < D; ++d) dot = fmaf(qw[d], kr[d], dot);
      s = dot;
      if constexpr (CAP) s = cap * tanhf(s / cap);
    }
    const float m_new = fmaxf(m, warp_max(s));
    if (m_new == -INFINITY) continue;   // nothing visible yet (warp-uniform)
    const float alpha = expf(m - m_new);
    const float p = vis ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) acc[c] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
      const float* vr = v_s + j * D;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(pj, vr[d], acc[c]);
      }
    }
    m = m_new;
  }

  if (live) {
    T* o_row = out + ((static_cast<size_t>(b) * Hq + h) * Sq + i) * D;
    const float denom = fmaxf(l, 1e-20f);
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      const int d = lane + 32 * c;
      if (d < D) from_f32(acc[c] / denom, o_row + d);
    }
    if (lse && lane == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + i] = m + logf(denom);
  }
}

template <typename T, bool CAP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* out, float* lse, int B, int Hq,
                   int Hkv,
                   int Sq, int Skv, int D, int causal, int window, float cap,
                   cudaStream_t stream) {
  const int rows = (Hq / Hkv) * Sq;
  const dim3 grid((rows + WARPS - 1) / WARPS, B * Hkv);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(TK) * (D + 1) + static_cast<size_t>(TK) * D +
       static_cast<size_t>(WARPS) * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  flash_fwd_kernel<T, CAP><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), lse, Hq, Hkv,
      Sq, Skv, D, causal, window, scale, cap);
  return cudaGetLastError();
}


// ---- the wgmma variant ----------------------------------------------------

constexpr int FW_BQ = 64;      // query rows per consumer warpgroup
constexpr int FW_BKV = 64;     // keys per tile
constexpr int FW_STAGES = 2;
constexpr int FW_CHUNK = FW_BKV * hopper::ROW_BYTES;  // 64 rows x 64 columns
constexpr double LOG2E = 1.4426950408889634;
constexpr double LN2 = 0.6931471805599453;

// DP: the head dim padded to whole 64-column chunks.  NC: the consumer
// warpgroups of a block, each owning 64 query rows.  One consumer has a
// producer warp beside it; with two, thread 0 issues the copies, as a
// producer warp would make the block 288 threads and ptxas then caps a
// thread at 168 registers, below the 64 x 256 f32 output's 128 and S's 32.
template <int DP, int NC>
struct FlashTile {
  static constexpr int CHUNKS = DP / 64;
  static constexpr int TILE = CHUNKS * FW_CHUNK;     // 64 rows of Q, K or V
  static constexpr int STAGE = 2 * TILE;             // K, then V
  static constexpr int ROWS = NC * FW_BQ;            // query rows a block
  static constexpr int CONSUMERS = NC * 128;
  static constexpr bool PRODUCER_WARP = NC == 1;
  static constexpr int THREADS = CONSUMERS + (PRODUCER_WARP ? 32 : 0);
  static constexpr int SMEM = NC * TILE + FW_STAGES * STAGE +
                              2 * FW_STAGES * 8 + 16 + 1024;
  // Named barriers (0 is __syncthreads'): 1 + w holds consumer warpgroup w
  // alone, BAR_ALL every consumer.  Every id is a constant, so ptxas
  // reserves only these (an id computed from the thread index reserves all
  // 16, and one consumer's block then held fewer blocks an SM).
  static constexpr int BAR_ALL = NC == 1 ? 1 : 3;
};

// Consumer warpgroup wg alone.
template <int NC>
__device__ __forceinline__ void bar_consumer(int wg) {
  if (NC == 1 || wg == 0) {
    hopper::bar_sync(1, 128);
  } else {
    hopper::bar_sync(2, 128);
  }
}

struct FlashArgs {
  const __nv_bfloat16* q;
  const int* kv_len;          // may be null
  __nv_bfloat16* out;
  float* lse;                 // [B, Hq, Sq] (splits == 1), may be null
  float* part_o;              // split partials (splits > 1), else null
  float* part_ml;
  int* tickets;
  int Hq, Hkv, Sq, Skv, D, causal, window, splits, row_tiles;
  float scale_log2;           // 1/sqrt(D) * log2(e): softmax in base 2
  float cap_in;               // soft cap c: 1/sqrt(D) / c
  float cap_log2;             // c * log2(e)
};

// A scaled logit in base 2: s / sqrt(D) * log2(e), or with the soft cap
// c tanh(s / sqrt(D) / c) * log2(e).
template <bool CAP>
__device__ __forceinline__ float logit2(float s, const FlashArgs& a) {
  if constexpr (CAP) return a.cap_log2 * hopper::tanh_approx(s * a.cap_in);
  return s * a.scale_log2;
}

template <int DP, int NC, bool CAP>
__global__ void __launch_bounds__(FlashTile<DP, NC>::THREADS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const FlashArgs a) {
  using Tile = FlashTile<DP, NC>;
  constexpr int BQ = Tile::ROWS;
  constexpr int CONSUMERS = Tile::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_all = hopper::align_1024(smem_raw);
  uint8_t* ring = q_all + NC * Tile::TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + FW_STAGES * Tile::STAGE);
  uint64_t* empty = full + FW_STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + FW_STAGES);

  const int group = a.Hq / a.Hkv;
  const int rows = group * a.Sq;       // query rows of this (b, kv head)
  // Row tiles in reverse: under a causal mask the last see the most keys,
  // and they start first.
  const int rt = a.row_tiles - 1 - static_cast<int>(blockIdx.y);
  const int bk = blockIdx.x;           // b * Hkv + kv head
  const int b = bk / a.Hkv;
  const int row0 = rt * BQ;
  const int L = a.kv_len ? min(max(a.kv_len[b], 0), a.Skv) : a.Skv;
  const int offs = L - a.Sq;           // query i sits at key i + offs

  // Key tiles any row of the block can see; then this split's share.
  const int i_lo = row0 / group;
  const int i_hi = (min(row0 + BQ, rows) - 1) / group;
  int kv_end = L;
  int kv_begin = 0;
  if (a.causal) {
    kv_end = max(0, min(L, i_hi + offs + 1));
    if (a.window > 0) kv_begin = max(0, i_lo + offs - a.window + 1);
  }
  const int t_first = kv_begin / FW_BKV;
  const int t_last = kv_end > kv_begin ? (kv_end + FW_BKV - 1) / FW_BKV
                                       : t_first;
  const int per = (t_last - t_first + a.splits - 1) / a.splits;
  const int t_begin = min(t_last, t_first + static_cast<int>(blockIdx.z) *
                                                per);
  const int t_end = min(t_last, t_begin + per);

  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NC);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // K and V tile t into stage (t - t_begin) % FW_STAGES, once every
  // consumer has released that stage's previous tile.
  auto issue = [&](int t) {
    const int n = t - t_begin;
    const int st = n % FW_STAGES;
    hopper::mbar_wait(&empty[st], ((n / FW_STAGES) & 1) ^ 1);
    uint8_t* dst = ring + st * Tile::STAGE;
    hopper::mbar_expect_tx(&full[st], Tile::STAGE);
    for (int c = 0; c < Tile::CHUNKS; ++c) {
      hopper::tma_load_3d(dst + c * FW_CHUNK, &kmap, &full[st], 64 * c,
                          t * FW_BKV, bk);
      hopper::tma_load_3d(dst + Tile::TILE + c * FW_CHUNK, &vmap, &full[st],
                          64 * c, t * FW_BKV, bk);
    }
  };
  if constexpr (Tile::PRODUCER_WARP) {
    if (threadIdx.x >= CONSUMERS) {  // one thread streams every tile
      if (threadIdx.x == CONSUMERS)
        for (int t = t_begin; t < t_end; ++t) issue(t);
      return;
    }
  } else {
    if (threadIdx.x == 0)            // the first stages; the rest below
      for (int t = t_begin; t < min(t_end, t_begin + FW_STAGES); ++t)
        issue(t);
    __syncwarp();
  }

  // Consumer warpgroup wg owns the block's rows crow0 .. crow0 + 63.
  // Thread tid holds rows r and r + 8 of them (r = 16 warp + lane / 4),
  // columns 8j + 2 (lane % 4) + {0, 1}.
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int kvh = bk % a.Hkv;
  const int crow0 = row0 + wg * FW_BQ;
  uint8_t* q_s = q_all + wg * Tile::TILE;
  // Q rows, zero past the live rows and past D, 128-byte swizzled.
  for (int idx = tid; idx < FW_BQ * DP / 8; idx += 128) {
    const int r = idx / (DP / 8);
    const int c = idx % (DP / 8);      // 16-byte chunk of the row
    const int row = crow0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < rows && c * 8 < a.D) {
      const int h = kvh * group + row % group;
      val = *reinterpret_cast<const uint4*>(
          a.q + ((static_cast<size_t>(b) * a.Hq + h) * a.Sq + row / group) *
                    a.D + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + (c / 8) * FW_CHUNK + r * hopper::ROW_BYTES +
                              (((c % 8) ^ (r % 8)) * 16)) = val;
  }
  hopper::fence_proxy_async();
  bar_consumer<NC>(wg);

  // Keys this warpgroup's rows can see: the block's tiles outside them
  // give P = 0 in every row, so the warpgroup skips their products (the
  // same bits: alpha is 1 and O, l do not change).
  const bool live = crow0 < rows;
  const int c_lo = crow0 / group;
  const int c_hi = (min(crow0 + FW_BQ, rows) - 1) / group;
  int c_end = live ? L : 0;
  int c_begin = 0;
  if (a.causal && live) {
    c_end = max(0, min(L, c_hi + offs + 1));
    if (a.window > 0) c_begin = max(0, c_lo + offs - a.window + 1);
  }

  int qpos[2];
  const int r_own = 16 * (tid / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = (crow0 + r_own + 8 * h) / group + offs;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // this thread's share of the row sum
  int s = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    hopper::mbar_wait(&full[s], phase);
    uint8_t* k_s = ring + s * Tile::STAGE;
    uint8_t* v_s = k_s + Tile::TILE;

    // V rows between kv_len and Skv hold data the mask hides; P is 0 there,
    // and 0 x junk would be NaN, so every consumer zeroes its share of them
    // before any reads V (past Skv TMA did it).
    const int first_dead = L - t * FW_BKV;
    if (first_dead < FW_BKV && L < a.Skv) {
      const int r_lo = max(first_dead, 0);
      for (int idx = threadIdx.x; idx < (FW_BKV - r_lo) * Tile::CHUNKS * 8;
           idx += CONSUMERS) {
        const int r = r_lo + idx / (Tile::CHUNKS * 8);
        const int c = idx % (Tile::CHUNKS * 8);
        *reinterpret_cast<uint4*>(v_s + (c / 8) * FW_CHUNK +
                                  r * hopper::ROW_BYTES + (c % 8) * 16) =
            make_uint4(0, 0, 0, 0);
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(Tile::BAR_ALL, CONSUMERS);
    }

    // (One consumer's range is the block's: nothing to skip.)
    if (NC == 1 || (t * FW_BKV < c_end && (t + 1) * FW_BKV > c_begin)) {
      // S = Q K^T: both operands K-major, 16 head-dim columns a step.
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk / 4) * FW_CHUNK + (kk % 4) * 32;
        hopper::Wgmma<64>::template ss<0, 0>(
            sc, hopper::smem_desc(q_s + off, 16, 1024),
            hopper::smem_desc(k_s + off, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Mask (only where some key of the tile is hidden from some row),
      // scale (and cap) in f32, online softmax in base 2.
      const int key0 = t * FW_BKV + 2 * quad;
      const int k_hi = t * FW_BKV + FW_BKV - 1;
      const bool whole = k_hi < L &&
          (!a.causal || (k_hi <= c_lo + offs &&
                         (a.window == 0 ||
                          c_hi + offs - t * FW_BKV < a.window)));
      float mx[2] = {-INFINITY, -INFINITY};
      if (whole) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = logit2<CAP>(sc[i], a);
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int key = key0 + 8 * j + (e & 1);
            bool vis = key < L;
            if (a.causal) {
              vis = vis && key <= qpos[h];
              if (a.window > 0) vis = vis && qpos[h] - key < a.window;
            }
            sc[4 * j + e] = vis ? logit2<CAP>(sc[4 * j + e], a) : -INFINITY;
            mx[h] = fmaxf(mx[h], sc[4 * j + e]);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // m_new = -inf: nothing visible yet, and p = 0 (never NaN).
        alpha[h] = m_new == -INFINITY ? 1.f : exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      float row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float p = m[h] == -INFINITY ? 0.f : exp2f(sc[i] - m[h]);
        sc[i] = p;
        row_sum[h] += p;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + row_sum[h];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P in bf16 as the A operand: keys 16 kt .. + 15 are sc[8 kt .. + 7].
      uint32_t pa[FW_BKV / 16][4];
#pragma unroll
      for (int kt = 0; kt < FW_BKV / 16; ++kt)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          pa[kt][u] = hopper::pack_bf16(sc[8 * kt + 2 * u],
                                        sc[8 * kt + 2 * u + 1]);

      // O += P V: V is MN-major (D-contiguous), 16 keys a step.
      hopper::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < FW_BKV / 16; ++kt)
        hopper::Wgmma<DP>::template rs<1>(
            o, pa[kt],
            hopper::smem_desc(v_s + kt * 16 * hopper::ROW_BYTES, FW_CHUNK,
                              1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
    }
    if (tid == 0) hopper::mbar_arrive(&empty[s]);
    if constexpr (!Tile::PRODUCER_WARP) {
      if (threadIdx.x == 0 && t + FW_STAGES < t_end) issue(t + FW_STAGES);
      __syncwarp();
    }
    if (++s == FW_STAGES) { s = 0; phase ^= 1; }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
  }

  if (a.splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = crow0 + r_own + 8 * h;
      if (row >= rows) continue;
      __nv_bfloat16* o_row =
          a.out + ((static_cast<size_t>(b) * a.Hq + kvh * group +
                    row % group) * a.Sq + row / group) * a.D;
      const float inv = 1.f / fmaxf(l[h], 1e-20f);
      if (a.lse && quad == 0)
        a.lse[(static_cast<size_t>(b) * a.Hq + kvh * group + row % group) *
                  a.Sq + row / group] =
            m[h] * static_cast<float>(LN2) + logf(fmaxf(l[h], 1e-20f));
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        if (col < a.D)
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                    o[4 * j + 2 * h + 1] * inv);
      }
    }
    return;
  }

  // Split: f32 partials (row max in base 2, row sum, unnormalised output).
  const int tile_slot = (bk * a.row_tiles + rt) * a.splits;
  const int slot = (tile_slot + blockIdx.z) * BQ + wg * FW_BQ;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_own + 8 * h;
    if (crow0 + r >= rows) continue;
    float* po = a.part_o + static_cast<size_t>(slot + r) * DP;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (col < a.D)
        *reinterpret_cast<float2*>(po + col) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
    if (quad == 0)
      *reinterpret_cast<float2*>(a.part_ml + 2 * static_cast<size_t>(
                                     slot + r)) = make_float2(m[h], l[h]);
  }
  __threadfence();
  hopper::bar_sync(Tile::BAR_ALL, CONSUMERS);
  int* ticket = a.tickets + bk * a.row_tiles + rt;
  if (threadIdx.x == 0) *last_flag = atomicAdd(ticket, 1) == a.splits - 1;
  hopper::bar_sync(Tile::BAR_ALL, CONSUMERS);
  if (!*last_flag) return;

  // The last block of this row tile to finish combines every split.
  __threadfence();
  const int live_rows = min(BQ, rows - row0);
  for (int idx = threadIdx.x; idx < live_rows * a.D; idx += CONSUMERS) {
    const int r = idx / a.D;
    const int col = idx % a.D;
    float mm = -INFINITY;
    for (int sp = 0; sp < a.splits; ++sp)
      mm = fmaxf(mm, __ldcg(a.part_ml + 2 * static_cast<size_t>(
                                (tile_slot + sp) * BQ + r)));
    float num = 0.f;
    float den = 0.f;
    if (mm != -INFINITY) {  // a split that saw no key has m = -inf: weight 0
      for (int sp = 0; sp < a.splits; ++sp) {
        const size_t at = static_cast<size_t>(tile_slot + sp) * BQ + r;
        const float wsp = exp2f(__ldcg(a.part_ml + 2 * at) - mm);
        num += wsp * __ldcg(a.part_o + at * DP + col);
        den += wsp * __ldcg(a.part_ml + 2 * at + 1);
      }
    }
    const int row = row0 + r;
    a.out[((static_cast<size_t>(b) * a.Hq + kvh * group + row % group) *
               a.Sq + row / group) * a.D + col] =
        __float2bfloat16(num / fmaxf(den, 1e-20f));
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next launch
}

template <int DP, int NC, bool CAP>
cudaError_t launch_wgmma(const FlashArgs& args, const void* k, const void* v,
                         int B, cudaStream_t stream) {
  using Tile = FlashTile<DP, NC>;
  CUtensorMap kmap, vmap;
  // k/v [B * Hkv, Skv, D]: boxes of 64 head-dim columns x 64 keys (a D of
  // 32 loads zeros in columns 32-63).
  const uint64_t row = static_cast<uint64_t>(args.D) * 2;
  cudaError_t err = hopper::tensor_map_3d(
      &kmap, k, args.D, args.Skv, static_cast<uint64_t>(B) * args.Hkv, row,
      row * args.Skv, FW_BKV);
  if (err != cudaSuccess) return err;
  err = hopper::tensor_map_3d(&vmap, v, args.D, args.Skv,
                              static_cast<uint64_t>(B) * args.Hkv, row,
                              row * args.Skv, FW_BKV);
  if (err != cudaSuccess) return err;
  static bool smem_set[hopper::MAX_DEVICES] = {};
  err = hopper::allow_smem(
      reinterpret_cast<const void*>(flash_wgmma_kernel<DP, NC, CAP>),
      Tile::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * args.Hkv, args.row_tiles, args.splits);
  flash_wgmma_kernel<DP, NC, CAP><<<grid, Tile::THREADS, Tile::SMEM,
                                     stream>>>(
      kmap, vmap, args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  kv_len and lse (f32 [B*Hq*Sq], the
// rows' log-sum-exp, only with splits = 1) may be NULL.  variant: 0 =
// simt; 1 = wgmma (bf16, D in {32, 64, 128, 256}, 16-byte-aligned
// q/k/v/out) with `block_q` query rows a block (64; at D 256 also 128, two
// consumer warpgroups; row_tiles = ceil(Hq / Hkv * Sq / block_q)) and the
// key range split over `splits` blocks; splits > 1 needs f32 scratch
// part_o [B*Hkv*row_tiles*splits*block_q*DP] (DP: D rounded up to 64),
// part_ml [B*Hkv*row_tiles*splits*block_q*2] and zeroed int32 tickets
// [B*Hkv*row_tiles].  `block_q` is read by the wgmma variant only.
// softcap > 0 caps every scaled logit s at softcap * tanh(s / softcap).
// Returns a cudaError_t: 0 on a successful launch (the kernel itself runs
// async), cudaErrorInvalidValue for a variant the shape does not allow.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* kv_len, void* out, float* lse, int B,
                        int Hq, int Hkv,
                        int Sq, int Skv, int D, int dtype, int causal,
                        int window, int variant, int splits,
                        int block_q, float softcap, float* part_o,
                        float* part_ml, int* tickets, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hkv ||
      D <= 0 || D % 8 || D > MAX_D || window < 0 || B * Hkv > 65535 ||
      (lse && splits != 1) || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const bool aligned = (reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    if (dtype != 1 || !aligned ||
        (D != 32 && D != 64 && D != 128 && D != 256) ||
        (block_q != FW_BQ && !(D == 256 && block_q == 2 * FW_BQ)) ||
        splits < 1 || splits > 65535 ||
        (splits > 1 && (!part_o || !part_ml || !tickets)))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = static_cast<long long>(Hq / Hkv) * Sq;
    const long long row_tiles = (rows + block_q - 1) / block_q;
    if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const double scale = 1.0 / sqrt(static_cast<double>(D));
    FlashArgs args{static_cast<const __nv_bfloat16*>(q), kv_len,
                   static_cast<__nv_bfloat16*>(out), lse, part_o, part_ml,
                   tickets, Hq, Hkv, Sq, Skv, D, causal, window, splits,
                   static_cast<int>(row_tiles),
                   static_cast<float>(LOG2E * scale),
                   softcap > 0.f ? static_cast<float>(scale / softcap) : 0.f,
                   static_cast<float>(softcap * LOG2E)};
    if (softcap > 0.f) {
      if (D == 256)
        return static_cast<int>(
            block_q == FW_BQ ? launch_wgmma<256, 1, true>(args, k, v, B, s)
                             : launch_wgmma<256, 2, true>(args, k, v, B, s));
      return static_cast<int>(
          D == 128 ? launch_wgmma<128, 1, true>(args, k, v, B, s)
                   : launch_wgmma<64, 1, true>(args, k, v, B, s));
    }
    if (D == 256)
      return static_cast<int>(
          block_q == FW_BQ ? launch_wgmma<256, 1, false>(args, k, v, B, s)
                           : launch_wgmma<256, 2, false>(args, k, v, B, s));
    return static_cast<int>(
        D == 128 ? launch_wgmma<128, 1, false>(args, k, v, B, s)
                 : launch_wgmma<64, 1, false>(args, k, v, B, s));
  }
  if (variant != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto simt = dtype == 0
      ? (softcap > 0.f ? launch<float, true> : launch<float, false>)
      : (softcap > 0.f ? launch<__nv_bfloat16, true>
                       : launch<__nv_bfloat16, false>);
  return static_cast<int>(simt(q, k, v, kv_len, out, lse, B, Hq, Hkv, Sq,
                               Skv, D, causal, window, softcap, s));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
