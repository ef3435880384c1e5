// Grouped (per-expert) GEMM for MoE expert buffers, Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel `moe_grouped_gemm`
// (src/repro/kernels/moe_gemm.py, body `_moe_gemm_kernel`): the same
// function, not its block schedule.
//
//   x [E, C, d] @ w [E, d, F] -> out [E, C, F]   (contiguous, f32 or bf16)
//
// Products and the accumulator are f32 and the result is written in x's
// dtype, as the TPU kernel does.  Two variants, chosen by the wrapper's
// plan before the launch (the C entry point refuses a variant it cannot
// take; nothing falls back):
//
// `wgmma` (bf16, d and F multiples of 8, 16-byte-aligned bases).  What
// bounds it: at mixtral-8x7b's decode shape (4 slots x capacity 8: C = 32,
// d = 4096, F = 14336, 8 experts) every weight is read once, 948.9 MB,
// 0.283 ms at 3.35 TB/s; 30 GFLOP are nothing to the tensor cores.  The
// prefill shape (C = 640) is bound by its 601 GFLOP, 0.608 ms at the bf16
// tensor-core rate.  The design: the operands are swapped so the wide side
// fills wgmma's 64-row M, out_e^T [F, C] = w_e^T [F, d] x_e^T [d, C].  A
// block owns 128 F rows (two consumer warpgroups of 64) by BN = 32, 64 or
// 128 C columns (the plan's choice) of one expert.  One producer thread
// streams TMA boxes of w (64 d-rows x 64 F, F-contiguous: the MN-major A
// operand) and x (BN rows x 64 d, d-contiguous: the K-major B operand),
// 128-byte swizzled, into a ring of 3-5 stages guarded by mbarriers; the
// consumers run m64nBNk16 wgmmas on each stage as it lands and release it
// when they complete (keeping one stage's group in flight while the next is
// issued gave wrong sums at BN = 128 on the H100 and was not faster at
// decode, so each stage's group is waited for).
// TMA fills the ragged edges of C, d and F with zeros.  Products of two
// bf16 values are exact in f32, so this is the Pallas kernel's function up
// to summation order.  The epilogue rounds to bf16 through a padded shared
// tile and writes out[C, F] rows with 16-byte stores.  Grid (F / 128,
// C / BN, E): 896 blocks for wi/wg and 256 for wo at decode, two per SM.
// Not yet: a persistent schedule, setmaxnreg, skipping the capacity rows
// that are empty at decode (3 of 4 at 4 slots).
//
// `simt` (f32, and bf16 shapes the TMA rules refuse): the first design.
// Grid (F tiles, C tiles, E).  A block owns a BM x 64 output tile (BM = 32
// when C <= 32, else 64) and walks d in steps of 32, staging an x tile
// (transposed) and a w tile in shared memory as f32; each thread keeps a
// 4 x 4 register micro-tile, and every product is an IEEE f32 FMA on the
// CUDA cores (no TF32, which would change the f32 function).  Any positive
// E, C, d and F: every tile is bounds-checked and padded with zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ---- the wgmma variant ----------------------------------------------------

constexpr int WG_BM = 128;                  // F rows per block
constexpr int WG_BK = hopper::ROW_ELEMS;    // d per stage: one swizzled row
constexpr int W_BOX = WG_BK * hopper::ROW_BYTES;  // 64 d x 64 F: 8 KB
constexpr int WG_THREADS = 2 * 128 + 32;    // two consumer warpgroups + one
                                            // producer warp
constexpr int OUT_PAD = 8;                  // epilogue row padding (bf16)

template <int BN>
struct WgmmaTile {
  static constexpr int STAGE = 2 * W_BOX + BN * hopper::ROW_BYTES;
  // About 100 KB of ring, so two blocks share an SM.
  static constexpr int STAGES = BN == 32 ? 5 : BN == 64 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(BN * (WG_BM + OUT_PAD) * 2 <= STAGES * STAGE,
                "the epilogue tile reuses the ring");
};

template <int BN>
__global__ void __launch_bounds__(WG_THREADS)
moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap,
                      __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  using Tile = WgmmaTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tile::STAGES *
                                               Tile::STAGE);
  uint64_t* empty = full + Tile::STAGES;

  const int e = blockIdx.z;
  const int f0 = blockIdx.x * WG_BM;
  const int c0 = blockIdx.y * BN;
  const int k_tiles = (D + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer group
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 2 * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        hopper::mbar_wait(&empty[s], phase ^ 1);
        uint8_t* st = ring + s * Tile::STAGE;
        hopper::mbar_expect_tx(&full[s], Tile::STAGE);
        hopper::tma_load_3d(st, &wmap, &full[s], f0, kt * WG_BK, e);
        hopper::tma_load_3d(st + W_BOX, &wmap, &full[s], f0 + 64,
                            kt * WG_BK, e);
        hopper::tma_load_3d(st + 2 * W_BOX, &xmap, &full[s], kt * WG_BK, c0,
                            e);
        if (++s == Tile::STAGES) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns F rows f0 + 64 wg .. + 63 of out^T.
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int s = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    hopper::mbar_wait(&full[s], phase);
    const uint8_t* a = ring + s * Tile::STAGE + wg * W_BOX;
    const uint8_t* b = ring + s * Tile::STAGE + 2 * W_BOX;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A (w^T, MN-major): 16 d-rows further on; B (x, K-major): 32 bytes.
      const uint64_t da = hopper::smem_desc(a + kk * 16 * hopper::ROW_BYTES,
                                            W_BOX, 1024);
      const uint64_t db = hopper::smem_desc(b + kk * 32, 16, 1024);
      hopper::Wgmma<BN>::template ss<1, 0>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[s]);
    if (++s == Tile::STAGES) { s = 0; phase ^= 1; }
  }

  // Epilogue: out^T fragments -> a [BN][128 + pad] bf16 tile over the ring
  // (both groups done with it first) -> rows of out with 16-byte stores.
  hopper::bar_sync(1, 256);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
  constexpr int TS = WG_BM + OUT_PAD;
  const int lane = threadIdx.x % 32;
  const int fr = 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    tile[c * TS + fr] = __float2bfloat16(acc[4 * j + 0]);
    tile[(c + 1) * TS + fr] = __float2bfloat16(acc[4 * j + 1]);
    tile[c * TS + fr + 8] = __float2bfloat16(acc[4 * j + 2]);
    tile[(c + 1) * TS + fr + 8] = __float2bfloat16(acc[4 * j + 3]);
  }
  hopper::bar_sync(1, 256);
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * C * F;
  for (int i = threadIdx.x; i < BN * (WG_BM / 8); i += 256) {
    const int c = i / (WG_BM / 8);
    const int f = (i % (WG_BM / 8)) * 8;
    if (c0 + c < C && f0 + f < F)   // F % 8 == 0: a chunk is all in or out
      *reinterpret_cast<uint4*>(oe + static_cast<size_t>(c0 + c) * F + f0 +
                                f) =
          *reinterpret_cast<const uint4*>(tile + c * TS + f);
  }
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int E,
                         int C, int D, int F, cudaStream_t stream) {
  using Tile = WgmmaTile<BN>;
  CUtensorMap wmap, xmap;
  // w [E, d, F]: boxes of 64 F x 64 d; x [E, C, d]: boxes of 64 d x BN C.
  cudaError_t err = hopper::tensor_map_3d(
      &wmap, w, F, D, E, static_cast<uint64_t>(F) * 2,
      static_cast<uint64_t>(D) * F * 2, WG_BK);
  if (err != cudaSuccess) return err;
  err = hopper::tensor_map_3d(&xmap, x, D, C, E,
                              static_cast<uint64_t>(D) * 2,
                              static_cast<uint64_t>(C) * D * 2, BN);
  if (err != cudaSuccess) return err;
  static bool smem_set[hopper::MAX_DEVICES] = {};
  err = hopper::allow_smem(
      reinterpret_cast<const void*>(moe_gemm_wgmma_kernel<BN>), Tile::SMEM,
      smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + WG_BM - 1) / WG_BM, (C + BN - 1) / BN, E);
  moe_gemm_wgmma_kernel<BN><<<grid, WG_THREADS, Tile::SMEM, stream>>>(
      wmap, xmap, static_cast<__nv_bfloat16*>(out), C, D, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = simt, 1 = wgmma with
// block_c C columns a block (32, 64 or 128; bf16, D and F multiples of 8,
// 16-byte-aligned x, w and out).  Returns a cudaError_t: 0 on a successful
// launch (the kernel itself runs async), cudaErrorInvalidValue for a
// variant the shape does not allow.
int moe_gemm_fwd(const void* x, const void* w, void* out, int E, int C, int D,
                 int F, int dtype, int variant, int block_c, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    if (dtype != 1 || !aligned || D % 8 || F % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    if (block_c == 32) return static_cast<int>(
        launch_wgmma<32>(x, w, out, E, C, D, F, s));
    if (block_c == 64) return static_cast<int>(
        launch_wgmma<64>(x, w, out, E, C, D, F, s));
    if (block_c == 128) return static_cast<int>(
        launch_wgmma<128>(x, w, out, E, C, D, F, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
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
