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
// (q * 1/sqrt(D)) . k.  Causal masking is bottom-right aligned (query i sits
// at key position i + L - Sq), with an optional sliding window; keys past the
// sequence length are masked and their V rows zeroed; the sum is clamped at
// 1e-20.  One argument is added to the TPU kernel's: an optional `kv_len`
// int32 [B].  Row b then attends over its first kv_len[b] keys with causal
// offset kv_len[b] - Sq, exactly as if k and v were cut to that length; this
// is the TPU kernel's padding mask made per row, which per-slot decode needs.
// A query row with no visible key (causal with Sq > length) writes zeros.
//
// Design.  One warp per query row.  The rows that share one (batch, kv head)
// are ordered (query position, head within the group) and cut into blocks
// of WARPS rows, so a decode step (Sq = 1) puts a whole GQA group in one
// block and reads its K/V once, not once per query head.  K/V tiles of
// TK = 32 keys are staged in shared memory as f32 with 16-byte loads; for
// q.k each lane owns one key of the tile (K rows padded to an odd word
// stride, so the lanes hit 32 different banks), and for P.V each lane owns
// the columns d = lane + 32c of the output row.  The tile max and sum are
// warp shuffles.  Tiles that every row of the block masks out (above the
// causal diagonal, before the window, past the length) are never loaded.
// All arithmetic is f32 FMAs on the CUDA cores: no tensor cores, so no TF32.
//
// What bounds it.  Decode is bound by the bytes of K/V it must read (a few
// hundred KB at qwen2-0.5b's shape, microseconds at 3.35 TB/s); with only
// B * Hkv blocks in flight the kernel is bound by latency well before that.
// Prefill is bound by FLOPs, and here by scalar FMAs at a fraction of the
// tensor cores' rate.  Where the design stops short: no wgmma, no TMA, no
// split of the kv axis across blocks for small batches, and K/V tiles are
// re-read from L2 by every block of a long prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ out, int Hq, int Hkv, int Sq, int Skv, int D,
                 int causal, int window, float scale) {
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
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* out, int B, int Hq, int Hkv,
                   int Sq, int Skv, int D, int causal, int window,
                   cudaStream_t stream) {
  const int rows = (Hq / Hkv) * Sq;
  const dim3 grid((rows + WARPS - 1) / WARPS, B * Hkv);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(TK) * (D + 1) + static_cast<size_t>(TK) * D +
       static_cast<size_t>(WARPS) * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  flash_fwd_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), Hq, Hkv, Sq,
      Skv, D, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  kv_len may be NULL.  Returns a
// cudaError_t: 0 on a successful launch (the kernel itself runs async).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* kv_len, void* out, int B, int Hq, int Hkv,
                        int Sq, int Skv, int D, int dtype, int causal,
                        int window, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hkv ||
      D <= 0 || D % 8 || D > MAX_D || window < 0 || B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, kv_len, out, B, Hq, Hkv,
                                          Sq, Skv, D, causal, window, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k, v, kv_len, out, B, Hq, Hkv, Sq, Skv, D, causal, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
