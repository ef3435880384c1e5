// Grouped (per-expert) GEMM for MoE expert buffers, Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel `moe_grouped_gemm`
// (src/repro/kernels/moe_gemm.py, body `_moe_gemm_kernel`): the same
// function, not its block schedule.
//
//   x [E, C, d] @ w [E, d, F] -> out [E, C, F]   (contiguous, f32 or bf16)
//
// Both inputs are widened to f32, products and the accumulator are f32 and
// the result is written in x's dtype, as the TPU kernel does.  Unlike the
// Pallas version (whose blocks must divide the dims) any positive E, C, d and
// F are taken: every tile is bounds-checked and padded with zeros, since the
// model's C = slots x capacity need not divide a tile.
//
// Design.  Grid (F tiles, C tiles, E).  A block owns a BM x 64 output tile
// (BM = 32 when C <= 32, as at decode, else 64) and walks d in steps of 32,
// staging an x tile (transposed) and a w tile in shared memory as f32.  Each
// thread keeps a 4 x 4 register micro-tile in f32, fed by one 16-byte
// shared load of x and one of w per step of d.  Global loads are 16 bytes a
// thread where d and F allow it (d and F multiples of 16 bytes' worth of
// elements, 16-byte aligned bases), else one element a thread.  All
// arithmetic is IEEE f32 FMAs on the CUDA cores: no tensor cores, no TF32.
//
// What bounds it.  At mixtral-8x7b's decode shape (4 slots x capacity 8:
// C = 32, d = 4096, F = 14336, 8 experts) one C tile covers every row, so
// each weight element is read from device memory once per GEMM: 948.9 MB of
// bf16 weights, x and output, 0.283 ms at 3.35 TB/s.  It is bound by those
// bytes on paper, but the 30 GFLOP it does on f32 CUDA cores (67 TFLOP/s)
// take 0.45 ms at best.  3 of every 4 buffer rows are zeros at decode (2
// assignments per slot in 8 capacity slots per expert); the kernel computes
// them, as the TPU kernel does.  The prefill shape (C = 640) is bound by
// FLOPs (601 GFLOP, 0.608 ms at the bf16 tensor-core rate), and this kernel
// runs it at the CUDA cores' f32 rate.  Where the design stops short:
// no wgmma, no TMA, no bf16 tensor cores, no skipping of empty capacity
// rows, no double-buffered tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;      // output columns per block
constexpr int BK = 32;      // step of the contraction
constexpr int TM = 4;       // output rows per thread
constexpr int TN = 4;       // output columns per thread
constexpr int TX = BN / TN; // threads across a tile's columns
constexpr int PAD = 4;      // x tile row padding: keeps 16-byte alignment

__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// V consecutive elements from global memory, widened to f32.
template <typename T, int V>
__device__ __forceinline__ void load(const T* src, float* dst);

template <>
__device__ __forceinline__ void load<float, 1>(const float* src, float* dst) {
  dst[0] = *src;
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 1>(
    const __nv_bfloat16* src, float* dst) {
  dst[0] = __bfloat162float(*src);
}
template <>
__device__ __forceinline__ void load<float, 4>(const float* src, float* dst) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 8>(
    const __nv_bfloat16* src, float* dst) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// V: elements per global load (16 bytes' worth, or 1 for ragged shapes).
template <typename T, int BM, int V>
__global__ void __launch_bounds__((BM / TM) * TX)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int C, int D, int F) {
  constexpr int THREADS = (BM / TM) * TX;
  __shared__ __align__(16) float xs[BK][BM + PAD];  // x tile, transposed
  __shared__ __align__(16) float ws[BK][BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* xe = x + static_cast<size_t>(e) * C * D;
  const T* we = w + static_cast<size_t>(e) * D * F;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // x tile: BM rows by BK columns of the contraction, stored transposed.
    for (int c = tid; c < BM * BK / V; c += THREADS) {
      const int m = c / (BK / V);
      const int k = (c % (BK / V)) * V;
      const int gm = m0 + m;
      const int gk = k0 + k;
      // With V > 1, D % V == 0: a load lies wholly inside or wholly out.
      float v[V];
      if (gm < C && gk + V <= D) {
        load<T, V>(xe + static_cast<size_t>(gm) * D + gk, v);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < V; ++u) xs[k + u][m] = v[u];
    }
    // w tile: BK rows of the contraction by BN output columns.
    for (int c = tid; c < BK * BN / V; c += THREADS) {
      const int k = c / (BN / V);
      const int n = (c % (BN / V)) * V;
      const int gk = k0 + k;
      const int gn = n0 + n;
      float v[V];
      if (gk < D && gn + V <= F) {
        load<T, V>(we + static_cast<size_t>(gk) * F + gn, v);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < V; ++u) ws[k][n + u] = v[u];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* oe = out + static_cast<size_t>(e) * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < F) store(acc[i][j], oe + static_cast<size_t>(gm) * F + gn);
    }
  }
}

template <typename T, int BM, int V>
cudaError_t launch_tiles(const void* x, const void* w, void* out, int E,
                         int C, int D, int F, cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  moe_gemm_kernel<T, BM, V><<<grid, (BM / TM) * TX, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, D, F);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_rows(const void* x, const void* w, void* out, int E, int C,
                        int D, int F, cudaStream_t stream) {
  if (C <= 32) return launch_tiles<T, 32, V>(x, w, out, E, C, D, F, stream);
  return launch_tiles<T, 64, V>(x, w, out, E, C, D, F, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (aligned && D % V == 0 && F % V == 0)
    return launch_rows<T, V>(x, w, out, E, C, D, F, stream);
  return launch_rows<T, 1>(x, w, out, E, C, D, F, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t: 0 on a
// successful launch (the kernel itself runs async).
int moe_gemm_fwd(const void* x, const void* w, void* out, int E, int C, int D,
                 int F, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, w, out, E, C, D, F, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, w, out, E, C, D, F, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
