// RWKV6 WKV recurrence, forward and backward, Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `rwkv6_chunk`
// (src/repro/kernels/rwkv6_chunk.py, body `_rwkv_kernel`): the same
// function, not its chunked factorisation.  Per b*h, with S_0 = 0 and
// w_t = exp(logw_t):
//
//   out_t[e] = sum_d r_t[d] * (S_{t-1}[d,e] + u[d] * k_t[d] * v_t[e])
//   S_t      = diag(w_t) * S_{t-1} + k_t v_t^T
//
// r, k, v: [BH, S, D] (f32 or bf16, widened on load); logw: [BH, S, D] f32;
// u: [BH, D] f32; out: [BH, S, D] f32.  All arithmetic is IEEE f32.  The
// Pallas kernel factors the intra-chunk decay as exp(cum_prev) * exp(-cum),
// which overflows f32 once a channel's log-decay sums past about -88 inside
// one chunk; the model's clipped decay reaches -e^4 = -54.6 per step.  This
// kernel never forms exp(-cum): it multiplies the state by w_t each step, so
// it is finite for every logw the model makes.  Any S >= 1; D = 32 or 64.
//
// Forward design: upstream RWKV's per-thread serial scan.  One block per b*h,
// one thread per value column e, which holds the state column S[:, e] in
// registers.  r, k and w are staged through shared memory a tile of steps at
// a time and read back as 16-byte broadcasts; v_t[e] and out_t[e] are the
// thread's own, coalesced across the block.
//
// Backward (given g = dL/dout, f32): with G_t = dL/dS_t, G_{S-1} = 0 and
// G_{t-1} = r_t g_t^T + diag(w_t) G_t,
//
//   q_t = S_{t-1} g_t,  vg_t = v_t . g_t,  p_t = G_t v_t
//   gr_t = q_t + u * k_t * vg_t,    gu = sum_t r_t * k_t * vg_t
//   gk_t = p_t + u * r_t * vg_t
//   gv_t = G_t^T k_t + (sum_d r_t u k_t) g_t
//   glogw_t[d] = w_t[d] * sum_e G_t[d,e] S_{t-1}[d,e]
//
// glogw is taken in that direct form, not as the reverse cumulative sum of
// (r q - k p) differences: at steep decay those differences cancel to
// ~w_t, and their rounding error would swamp a gradient of that size.  The
// direct form needs S_{t-1} and G_t at the same step while they run in
// opposite directions, so the kernel checkpoints the state.  One block per
// b*h with 2*D threads:
//   phase A (forward in time): thread d < D holds row d of S; it writes gr,
//     accumulates gu and stores S at the start of every chunk of BWD_T steps
//     to a scratch buffer (the caller's `ckpt`).
//   phase B (chunks in reverse): thread d < D rebuilds the chunk's BWD_T
//     states from the checkpoint into shared memory (its own rows), then
//     walks the chunk backwards holding row d of G: gk and glogw.  Threads
//     D..2D-1 hold column e of G in the same walk: gv, a column reduction.
//
// What bounds it.  At the train shape (BH 128, S 1024, D 64, r/k/v bf16) the
// forward moves 117 MB (0.035 ms at 3.35 TB/s) and the backward 201 MB; the
// backward's 12*D^2 f32 operations per step (6.4 GFLOP) take 0.096 ms at the
// 67 TFLOP/s f32 rate.  This design is bound by neither: each step is a
// serial chain per thread, and 128 blocks of 64 (forward) or 128 (backward)
// threads leave most of each SM idle.  The `mma` variant (rwkv6_chunked.cu)
// is the chunked tensor-core form with more blocks than b*h; this kernel
// stays for f32 and for inputs that variant does not take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FWD_T = 32;  // steps per staged tile, forward
constexpr int BWD_T = 8;   // steps per chunk (checkpoint interval), backward

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, float* __restrict__ out, int S) {
  __shared__ __align__(16) float rs[FWD_T][D];
  __shared__ __align__(16) float ks[FWD_T][D];
  __shared__ __align__(16) float ws[FWD_T][D];
  __shared__ __align__(16) float us[D];

  const int e = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  us[e] = u[static_cast<size_t>(blockIdx.x) * D + e];

  float state[D];
#pragma unroll
  for (int d = 0; d < D; ++d) state[d] = 0.f;

  for (int t0 = 0; t0 < S; t0 += FWD_T) {
    const int n = min(FWD_T, S - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = 0; j < n; ++j) {
      const size_t i = base + static_cast<size_t>(t0 + j) * D + e;
      rs[j][e] = widen(r[i]);
      ks[j][e] = widen(k[i]);
      ws[j][e] = expf(logw[i]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const size_t i = base + static_cast<size_t>(t0 + j) * D + e;
      const float ve = widen(v[i]);
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 r4 = ld4(&rs[j][d]);
        const float4 k4 = ld4(&ks[j][d]);
        const float4 w4 = ld4(&ws[j][d]);
        const float4 u4 = ld4(&us[d]);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = kv[c] * ve;
          y[c] += rv[c] * (state[d + c] + uv[c] * x);
          state[d + c] = state[d + c] * wv[c] + x;
        }
      }
      out[i] = (y[0] + y[1]) + (y[2] + y[3]);
    }
  }
}

// Shared memory of the backward kernel, in floats.
template <int D>
constexpr int bwd_smem_floats() {
  return 5 * BWD_T * D + D + 2 * BWD_T + BWD_T * D * (D + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(2 * D)
rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ g,
                 T* __restrict__ gr, T* __restrict__ gk, T* __restrict__ gv,
                 float* __restrict__ glogw, float* __restrict__ gu,
                 float* __restrict__ ckpt, int S) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;               // [BWD_T][D] each, f32
  float* ks = rs + BWD_T * D;
  float* vs = ks + BWD_T * D;
  float* ws = vs + BWD_T * D;     // w = exp(logw)
  float* gs = ws + BWD_T * D;
  float* us = gs + BWD_T * D;     // [D]
  float* vg = us + D;             // [BWD_T]: v_t . g_t
  float* ruk = vg + BWD_T;        // [BWD_T]: sum_d r_t u k_t
  float* sbuf = ruk + BWD_T;      // [BWD_T][D][D + 1]: S_{t-1} rows

  const int tid = threadIdx.x;
  const bool row = tid < D;       // row d of S and G, else column e of G
  const int i0 = row ? tid : tid - D;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int nchunks = (S + BWD_T - 1) / BWD_T;
  float* ck_base = ckpt + static_cast<size_t>(blockIdx.x) * nchunks * D * D;
  if (row) us[i0] = u[static_cast<size_t>(blockIdx.x) * D + i0];

  // Stage steps [t0, t0 + n) and their two per-step dot products.
  auto stage = [&](int t0, int n) {
    __syncthreads();  // the previous chunk is consumed
    for (int c = tid; c < n * D; c += 2 * D) {
      const size_t i = base + static_cast<size_t>(t0) * D + c;
      rs[c] = widen(r[i]);
      ks[c] = widen(k[i]);
      vs[c] = widen(v[i]);
      ws[c] = expf(logw[i]);
      gs[c] = g[i];
    }
    __syncthreads();
    // 2 * BWD_T sums of D terms, P = D / BWD_T lanes each.
    constexpr int P = D / BWD_T;
    const int j = (tid / P) % BWD_T;
    const int part = tid % P;
    float acc = 0.f;
    if (j < n) {
      for (int c = part; c < D; c += P) {
        acc += row ? vs[j * D + c] * gs[j * D + c]
                   : rs[j * D + c] * us[c] * ks[j * D + c];
      }
    }
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off, P);
    if (part == 0 && j < n) (row ? vg : ruk)[j] = acc;
    __syncthreads();
  };

  // State row d (phase A), then G row d or G column e (phase B).
  float m[D];
#pragma unroll
  for (int c = 0; c < D; ++c) m[c] = 0.f;

  // -- phase A: forward in time; gr, gu, checkpoints ------------------------
  float gu_acc = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * BWD_T;
    const int n = min(BWD_T, S - t0);
    stage(t0, n);
    if (!row) continue;
    const int d = i0;
    float* ck = ck_base + static_cast<size_t>(ch) * D * D;
#pragma unroll
    for (int e = 0; e < D; ++e) ck[e * D + d] = m[e];  // coalesced over d
    const float ud = us[d];
    for (int j = 0; j < n; ++j) {
      const float rd = rs[j * D + d];
      const float kd = ks[j * D + d];
      const float wd = ws[j * D + d];
      float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < D; e += 4) {
        const float4 g4 = ld4(&gs[j * D + e]);
        const float4 v4 = ld4(&vs[j * D + e]);
        const float gv4[4] = {g4.x, g4.y, g4.z, g4.w};
        const float vv4[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          q[c] += m[e + c] * gv4[c];
          m[e + c] = wd * m[e + c] + kd * vv4[c];
        }
      }
      const size_t i = base + static_cast<size_t>(t0 + j) * D + d;
      store((q[0] + q[1]) + (q[2] + q[3]) + ud * kd * vg[j], gr + i);
      gu_acc += rd * kd * vg[j];
    }
  }
  if (row) gu[static_cast<size_t>(blockIdx.x) * D + i0] = gu_acc;

  // -- phase B: chunks in reverse; gk, glogw (rows) and gv (columns) -------
#pragma unroll
  for (int c = 0; c < D; ++c) m[c] = 0.f;  // G_{S-1} = 0
  for (int ch = nchunks - 1; ch >= 0; --ch) {
    const int t0 = ch * BWD_T;
    const int n = min(BWD_T, S - t0);
    stage(t0, n);
    if (row) {
      const int d = i0;
      // Rebuild S_{t0-1+j}, j < n, into this thread's rows of sbuf.
      const float* ck = ck_base + static_cast<size_t>(ch) * D * D;
      float* sb = sbuf + d * (D + 1);
      for (int e = 0; e < D; ++e) sb[e] = ck[e * D + d];
      for (int j = 1; j < n; ++j) {
        const float wd = ws[(j - 1) * D + d];
        const float kd = ks[(j - 1) * D + d];
        const float* prev = sbuf + (j - 1) * D * (D + 1) + d * (D + 1);
        float* cur = sbuf + j * D * (D + 1) + d * (D + 1);
        for (int e = 0; e < D; ++e)
          cur[e] = wd * prev[e] + kd * vs[(j - 1) * D + e];
      }
      const float ud = us[d];
      for (int j = n - 1; j >= 0; --j) {
        const float rd = rs[j * D + d];
        const float wd = ws[j * D + d];
        const float* sj = sbuf + j * D * (D + 1) + d * (D + 1);
        float p[2] = {0.f, 0.f};
        float x[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < D; e += 4) {
          const float4 v4 = ld4(&vs[j * D + e]);
          const float4 g4 = ld4(&gs[j * D + e]);
          const float vv4[4] = {v4.x, v4.y, v4.z, v4.w};
          const float gv4[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p[c & 1] += m[e + c] * vv4[c];
            x[c & 1] += m[e + c] * sj[e + c];
            m[e + c] = rd * gv4[c] + wd * m[e + c];
          }
        }
        const size_t i = base + static_cast<size_t>(t0 + j) * D + d;
        store(p[0] + p[1] + ud * rd * vg[j], gk + i);
        glogw[i] = wd * (x[0] + x[1]);
      }
    } else {
      const int e = i0;
      for (int j = n - 1; j >= 0; --j) {
        const float ge = gs[j * D + e];
        float a[2] = {0.f, 0.f};
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 k4 = ld4(&ks[j * D + d]);
          const float4 r4 = ld4(&rs[j * D + d]);
          const float4 w4 = ld4(&ws[j * D + d]);
          const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
          const float rv4[4] = {r4.x, r4.y, r4.z, r4.w};
          const float wv4[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            a[c & 1] += m[d + c] * kv4[c];
            m[d + c] = rv4[c] * ge + wv4[c] * m[d + c];
          }
        }
        const size_t i = base + static_cast<size_t>(t0 + j) * D + e;
        store(a[0] + a[1] + ruk[j] * ge, gv + i);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, float* out, int BH,
                       int S, cudaStream_t stream) {
  rwkv6_fwd_kernel<T, D><<<BH, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, out, S);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* g,
                       void* gr, void* gk, void* gv, float* glogw, float* gu,
                       float* ckpt, int BH, int S, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * bwd_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rwkv6_bwd_kernel<T, D><<<BH, 2 * D, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, g, static_cast<T*>(gr),
      static_cast<T*>(gk), static_cast<T*>(gv), glogw, gu, ckpt, S);
  return cudaGetLastError();
}

bool valid(int BH, int S, int D, int dtype) {
  return BH > 0 && S > 0 && (D == 32 || D == 64) &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// dtype of r, k, v (and gr, gk, gv): 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t: 0 on a successful launch (the kernel itself runs async).
int rwkv6_fwd(const void* r, const void* k, const void* v, const void* logw,
              const void* u, void* out, int BH, int S, int D, int dtype,
              void* stream) {
  if (!valid(BH, S, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (dtype == 0)
    err = D == 64 ? launch_fwd<float, 64>(r, k, v, lw, uu, o, BH, S, s)
                  : launch_fwd<float, 32>(r, k, v, lw, uu, o, BH, S, s);
  else
    err = D == 64
              ? launch_fwd<__nv_bfloat16, 64>(r, k, v, lw, uu, o, BH, S, s)
              : launch_fwd<__nv_bfloat16, 32>(r, k, v, lw, uu, o, BH, S, s);
  return static_cast<int>(err);
}

// ckpt: f32 scratch of rwkv6_bwd_ckpt_floats(BH, S, D) floats.
int rwkv6_bwd(const void* r, const void* k, const void* v, const void* logw,
              const void* u, const void* g, void* gr, void* gk, void* gv,
              void* glogw, void* gu, void* ckpt, int BH, int S, int D,
              int dtype, void* stream) {
  if (!valid(BH, S, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* gg = static_cast<const float*>(g);
  float* gw = static_cast<float*>(glogw);
  float* gu_ = static_cast<float*>(gu);
  float* ck = static_cast<float*>(ckpt);
  cudaError_t err;
  if (dtype == 0)
    err = D == 64 ? launch_bwd<float, 64>(r, k, v, lw, uu, gg, gr, gk, gv,
                                          gw, gu_, ck, BH, S, s)
                  : launch_bwd<float, 32>(r, k, v, lw, uu, gg, gr, gk, gv,
                                          gw, gu_, ck, BH, S, s);
  else
    err = D == 64 ? launch_bwd<__nv_bfloat16, 64>(r, k, v, lw, uu, gg, gr,
                                                  gk, gv, gw, gu_, ck, BH, S,
                                                  s)
                  : launch_bwd<__nv_bfloat16, 32>(r, k, v, lw, uu, gg, gr,
                                                  gk, gv, gw, gu_, ck, BH, S,
                                                  s);
  return static_cast<int>(err);
}

// Size of the backward's `ckpt` scratch, in floats.
long long rwkv6_bwd_ckpt_floats(int BH, int S, int D) {
  return static_cast<long long>(BH) * ((S + BWD_T - 1) / BWD_T) * D * D;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
