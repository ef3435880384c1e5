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
// The backward (`moe_gemm_bwd`, no TPU counterpart: the JAX package
// differentiates its expert einsums through XLA) is the same kernel in two
// more layouts: dX = dY w^T reads w K-major (d rows of F) and dY K-major;
// dW = x^T dY reads dY MN-major and x MN-major (64-column boxes of d), so
// no operand is transposed in memory.  What bounds it: at mixtral's train
// shape (C = 1280) its 2.4 TFLOP, 2.43 ms at the bf16 rate; at deepseek's
// (E = 256, C = 80) reading w and writing dW, 15 GB, 4.5 ms.
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
//
// One kernel serves the forward and both products of the backward.  Each
// computes, per expert, out^T [M, N] = A [M, K] B [K, N] and writes out
// [N, M] row by row; the layout L says where A and B come from and which
// way each lies in memory, so that no operand is transposed in memory
// first (TMA reads each in its own layout, and wgmma's transpose bits take
// a 16-bit operand either K-major or MN-major):
//
//   FWD  out = x w      M = F, K = d, N = C   A = w  [d, F]  MN-major
//                                             B = x  [C, d]  K-major
//   DX   dX = dY w^T    M = d, K = F, N = C   A = w  [d, F]  K-major
//                                             B = dY [C, F]  K-major
//   DW   dW = x^T dY    M = F, K = C, N = d   A = dY [C, F]  MN-major
//                                             B = x  [C, d]  MN-major
enum Layout { FWD = 0, DX = 1, DW = 2 };

constexpr int WG_BM = 128;                  // M rows per block
constexpr int WG_BK = hopper::ROW_ELEMS;    // K per stage: one swizzled row
constexpr int W_BOX = WG_BK * hopper::ROW_BYTES;  // 64 x 64 bf16: 8 KB
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

template <int BN, int L>
__global__ void __launch_bounds__(WG_THREADS)
moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      __nv_bfloat16* __restrict__ out, int N, int K, int M) {
  using Tile = WgmmaTile<BN>;
  static_assert(L != DW || BN % 64 == 0,
                "an MN-major B is loaded in boxes of 64 columns");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tile::STAGES *
                                               Tile::STAGE);
  uint64_t* empty = full + Tile::STAGES;

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * WG_BM;
  const int n0 = blockIdx.y * BN;
  const int k_tiles = (K + WG_BK - 1) / WG_BK;
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
        // A: two boxes of 64 M rows (one per consumer group) by 64 K.
        for (int h = 0; h < 2; ++h) {
          if (L == DX)   // K-major: K along the box's 128-byte rows
            hopper::tma_load_3d(st + h * W_BOX, &amap, &full[s],
                                kt * WG_BK, m0 + 64 * h, e);
          else           // MN-major: M along the rows, K down them
            hopper::tma_load_3d(st + h * W_BOX, &amap, &full[s],
                                m0 + 64 * h, kt * WG_BK, e);
        }
        uint8_t* b = st + 2 * W_BOX;
        if (L == DW) {   // MN-major: BN / 64 boxes of 64 N by 64 K
          for (int c = 0; c < BN / 64; ++c)
            hopper::tma_load_3d(b + c * W_BOX, &bmap, &full[s], n0 + 64 * c,
                                kt * WG_BK, e);
        } else {         // K-major: BN rows of 64 K
          hopper::tma_load_3d(b, &bmap, &full[s], kt * WG_BK, n0, e);
        }
        if (++s == Tile::STAGES) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns M rows m0 + 64 wg .. + 63 of out^T.
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
      // K-major: 16 K further on is 32 bytes along the row; MN-major: 16
      // rows further on, and 64-column blocks one box (W_BOX) apart.
      const uint64_t da =
          L == DX ? hopper::smem_desc(a + kk * 32, 16, 1024)
                  : hopper::smem_desc(a + kk * 16 * hopper::ROW_BYTES,
                                      W_BOX, 1024);
      const uint64_t db =
          L == DW ? hopper::smem_desc(b + kk * 16 * hopper::ROW_BYTES,
                                      W_BOX, 1024)
                  : hopper::smem_desc(b + kk * 32, 16, 1024);
      hopper::Wgmma<BN>::template ss<L == DX ? 0 : 1, L == DW ? 1 : 0>(
          acc, da, db, 1);
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
  const int mr = 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    tile[c * TS + mr] = __float2bfloat16(acc[4 * j + 0]);
    tile[(c + 1) * TS + mr] = __float2bfloat16(acc[4 * j + 1]);
    tile[c * TS + mr + 8] = __float2bfloat16(acc[4 * j + 2]);
    tile[(c + 1) * TS + mr + 8] = __float2bfloat16(acc[4 * j + 3]);
  }
  hopper::bar_sync(1, 256);
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * N * M;
  for (int i = threadIdx.x; i < BN * (WG_BM / 8); i += 256) {
    const int c = i / (WG_BM / 8);
    const int m = (i % (WG_BM / 8)) * 8;
    if (n0 + c < N && m0 + m < M)   // M % 8 == 0: a chunk is all in or out
      *reinterpret_cast<uint4*>(oe + static_cast<size_t>(n0 + c) * M + m0 +
                                m) =
          *reinterpret_cast<const uint4*>(tile + c * TS + m);
  }
}

// A [rows, cols] bf16 matrix per expert (cols contiguous) as a tensor map
// of boxes of 64 cols by `box_rows` rows.
inline cudaError_t matrix_map(CUtensorMap* map, const void* p, int E,
                              int rows, int cols, int box_rows) {
  return hopper::tensor_map_3d(map, p, cols, rows, E,
                               static_cast<uint64_t>(cols) * 2,
                               static_cast<uint64_t>(rows) * cols * 2,
                               box_rows);
}

// Launch layout L on a and b (the A and B sources of the table above), each
// given as its [rows, cols] per expert.
template <int BN, int L>
cudaError_t launch_wgmma(const void* a, int a_rows, int a_cols, const void* b,
                         int b_rows, int b_cols, void* out, int E, int N,
                         int K, int M, cudaStream_t stream) {
  using Tile = WgmmaTile<BN>;
  CUtensorMap amap, bmap;
  // A comes in 64 x 64 boxes; a K-major B in BN rows of 64 K, an MN-major
  // B in 64 x 64 boxes.
  cudaError_t err = matrix_map(&amap, a, E, a_rows, a_cols, WG_BK);
  if (err != cudaSuccess) return err;
  err = matrix_map(&bmap, b, E, b_rows, b_cols, L == DW ? WG_BK : BN);
  if (err != cudaSuccess) return err;
  static bool smem_set[hopper::MAX_DEVICES] = {};
  err = hopper::allow_smem(
      reinterpret_cast<const void*>(moe_gemm_wgmma_kernel<BN, L>), Tile::SMEM,
      smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + BN - 1) / BN, E);
  moe_gemm_wgmma_kernel<BN, L><<<grid, WG_THREADS, Tile::SMEM, stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(out), N, K, M);
  return cudaGetLastError();
}

// x [E, C, d] @ w [E, d, F] -> out [E, C, F].
template <int BN>
cudaError_t launch_fwd(const void* x, const void* w, void* out, int E, int C,
                       int D, int F, cudaStream_t stream) {
  return launch_wgmma<BN, FWD>(w, D, F, x, C, D, out, E, C, D, F, stream);
}

// dX [E, C, d] = dY [E, C, F] @ w^T.
template <int BN>
cudaError_t launch_dx(const void* dy, const void* w, void* dx, int E, int C,
                      int D, int F, cudaStream_t stream) {
  return launch_wgmma<BN, DX>(w, D, F, dy, C, F, dx, E, C, F, D, stream);
}

// dW [E, d, F] = x^T @ dY: N = d, K = C, M = F.
template <int BN>
cudaError_t launch_dw(const void* x, const void* dy, void* dw, int E, int C,
                      int D, int F, cudaStream_t stream) {
  return launch_wgmma<BN, DW>(dy, C, F, x, C, D, dw, E, D, C, F, stream);
}

bool wgmma_takes(const void* const* ps, int n, int D, int F) {
  uintptr_t bits = 0;
  for (int i = 0; i < n; ++i) bits |= reinterpret_cast<uintptr_t>(ps[i]);
  return bits % 16 == 0 && D % 8 == 0 && F % 8 == 0;
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
    const void* ps[3] = {x, w, out};
    if (dtype != 1 || !wgmma_takes(ps, 3, D, F))
      return static_cast<int>(cudaErrorInvalidValue);
    if (block_c == 32) return static_cast<int>(
        launch_fwd<32>(x, w, out, E, C, D, F, s));
    if (block_c == 64) return static_cast<int>(
        launch_fwd<64>(x, w, out, E, C, D, F, s));
    if (block_c == 128) return static_cast<int>(
        launch_fwd<128>(x, w, out, E, C, D, F, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, w, out, E, C, D, F, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, w, out, E, C, D, F, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of x [E, C, d] @ w [E, d, F] against dy [E, C, F], bf16 on
// wgmma only, each operand read in place: dx = dy w^T (block_c C columns a
// block: 32, 64 or 128) and dw = x^T dy (block_d d columns a block: 64 or
// 128); a null dx or dw is not computed.  Two launches on `stream`;
// returns the first cudaError_t that is not 0.
int moe_gemm_bwd(const void* x, const void* w, const void* dy, void* dx,
                 void* dw, int E, int C, int D, int F, int block_c,
                 int block_d, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + 31) / 32 > 65535 || (D + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ps[5] = {x, w, dy, dx ? dx : x, dw ? dw : x};
  if (!wgmma_takes(ps, 5, D, F))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) {
    err = block_c == 32 ? launch_dx<32>(dy, w, dx, E, C, D, F, s)
        : block_c == 64 ? launch_dx<64>(dy, w, dx, E, C, D, F, s)
        : block_c == 128 ? launch_dx<128>(dy, w, dx, E, C, D, F, s)
        : cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dw != nullptr) {
    err = block_d == 64 ? launch_dw<64>(x, dy, dw, E, C, D, F, s)
        : block_d == 128 ? launch_dw<128>(x, dy, dw, E, C, D, F, s)
        : cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
