// Gradient clipping and AdamW over every leaf of a parameter tree, in place,
// in two launches a step, Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package leaves clip_by_global_norm, the
// AdamW update and its application to XLA.  The port's per-leaf path
// (optim/optimizers.py) runs about fourteen elementwise kernels a leaf,
// writes a clipped copy of every gradient and an `updates` tree, and moves
// about 176 bytes of device memory a parameter.  Here:
//
//   fused_adamw_norm    sum of g*g over every gradient; its last block
//                       writes out[0] = norm = sqrt(sum) and out[1] =
//                       scale = min(1, (1 / (norm + 1e-9)) * max_norm)
//   fused_adamw_update  for each element: g <- g*scale, then AdamW's m, v
//                       and p, each read once and written once, in place
//
// What bounds it: bytes, 32 a parameter (the norm reads g, 4; the update
// reads p, g, m, v, 16, and writes p, m, v, 12); nothing is written but the
// state.  At mixtral-8x7b-2l's 3.165 B f32 parameters that is 101 GB, 30 ms
// at 3.35 TB/s.  The design is about bytes in flight: a persistent grid of
// as many blocks as fit on the SMs walks a table of the leaves in chunks of
// CHUNK elements; a thread keeps UNROLL 16-byte loads of each of p, g, m and
// v in flight before it computes (streaming loads and stores: nothing is
// read again).  A leaf whose four bases are not all 16-byte aligned, and the
// last n % 4 elements of any leaf, go one element at a time.
//
// Rounding: each op is rounded in f32 as the per-leaf path's PyTorch kernels
// round it, one kernel an op, with no contraction (the _rn intrinsics are
// never fused into an FMA).  PyTorch divides a CUDA tensor by a CPU scalar
// as a product with the scalar's f32 reciprocal, and `s / t` for a Python
// scalar s as reciprocal(t) * s; the wrapper passes 1/bc1 and 1/bc2 as that
// reciprocal, and the norm's last block takes its scale in that order.  So
// given one scale, p, m and v come out bit for bit as the per-leaf path's.
// The norm's squares are f32, as the per-leaf path's; their sum is taken in
// f64, in this kernel's order, so the norm differs from the per-leaf path's
// f32 sums by rounding only.  The sum of the blocks' partials is taken in
// block order, so one grid gives the same norm every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;            // 16-byte loads in flight a thread, a tensor
constexpr long long CHUNK = 1 << 16; // elements a block takes at a time (the
                                     // wrapper's CHUNK; a multiple of 4)
constexpr int WARPS = THREADS / 32;

// One row of the wrapper's table: six 64-bit words.
struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;       // elements
  long long chunk0;  // the leaf's first chunk, counted over all leaves
};

// The step's scalars, each as the per-leaf path's kernels take it (f32).
struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd,
      neg_lr;
};

// One element of the per-leaf path (optim/optimizers.py, adamw's `upd`
// after clip_by_global_norm, then apply_updates), op by op.
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      float scale, const Hyper& h) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(m, h.inv_bc1), den),
                            __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, u));
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// The leaf that holds chunk c, from the one that held the block's previous
// chunk: a block walks its chunks in increasing order.
__device__ __forceinline__ int leaf_of(const Leaf* tab, int n_leaves,
                                       int leaf, long long c) {
  while (leaf + 1 < n_leaves && tab[leaf + 1].chunk0 <= c) ++leaf;
  return leaf;
}

// Chunk c of leaf L: elements [lo, hi), the first `nv` float4s of it loaded
// as vectors when `vec`.
struct Span {
  long long lo, hi;
  int nv;
};

__device__ __forceinline__ Span span_of(const Leaf& L, long long c,
                                        bool vec) {
  Span s;
  s.lo = (c - L.chunk0) * CHUNK;
  s.hi = s.lo + CHUNK < L.n ? s.lo + CHUNK : L.n;
  s.nv = vec ? static_cast<int>((s.hi - s.lo) >> 2) : 0;
  return s;
}

__global__ void __launch_bounds__(THREADS)
    update_kernel(const Leaf* __restrict__ tab, int n_leaves,
                  long long n_chunks, const float* __restrict__ scale_ptr,
                  Hyper h) {
  const float scale = *scale_ptr;
  int leaf = 0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    leaf = leaf_of(tab, n_leaves, leaf, c);
    const Leaf L = tab[leaf];
    const bool vec = aligned16(L.p) && aligned16(L.g) && aligned16(L.m) &&
                     aligned16(L.v);
    const Span s = span_of(L, c, vec);
    float4* p4 = reinterpret_cast<float4*>(L.p + s.lo);
    const float4* g4 = reinterpret_cast<const float4*>(L.g + s.lo);
    float4* m4 = reinterpret_cast<float4*>(L.m + s.lo);
    float4* v4 = reinterpret_cast<float4*>(L.v + s.lo);
    for (int base = threadIdx.x; base < s.nv; base += THREADS * UNROLL) {
      float4 P[UNROLL], G[UNROLL], M[UNROLL], V[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < s.nv) {
          P[u] = __ldcs(p4 + i);
          G[u] = __ldcs(g4 + i);
          M[u] = __ldcs(m4 + i);
          V[u] = __ldcs(v4 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < s.nv) {
          adamw(P[u].x, G[u].x, M[u].x, V[u].x, scale, h);
          adamw(P[u].y, G[u].y, M[u].y, V[u].y, scale, h);
          adamw(P[u].z, G[u].z, M[u].z, V[u].z, scale, h);
          adamw(P[u].w, G[u].w, M[u].w, V[u].w, scale, h);
          __stcs(p4 + i, P[u]);
          __stcs(m4 + i, M[u]);
          __stcs(v4 + i, V[u]);
        }
      }
    }
    for (long long i = s.lo + 4LL * s.nv + threadIdx.x; i < s.hi;
         i += THREADS) {
      float p = L.p[i], m = L.m[i], v = L.v[i];
      adamw(p, L.g[i], m, v, scale, h);
      L.p[i] = p;
      L.m[i] = m;
      L.v[i] = v;
    }
  }
}

__device__ __forceinline__ double square(float x) {
  return static_cast<double>(__fmul_rn(x, x));
}

// The block's sum of `x`, in thread 0 (a fixed order: warps, then lanes).
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[WARPS];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

// partial: gridDim.x doubles; done: a counter that is 0 before the launch,
// and that the last block sets back to 0.
__global__ void __launch_bounds__(THREADS)
    norm_kernel(const Leaf* __restrict__ tab, int n_leaves,
                long long n_chunks, double* partial, unsigned* done,
                float max_norm, float* __restrict__ out) {
  double acc = 0.0;
  int leaf = 0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    leaf = leaf_of(tab, n_leaves, leaf, c);
    const Leaf L = tab[leaf];
    const Span s = span_of(L, c, aligned16(L.g));
    const float4* g4 = reinterpret_cast<const float4*>(L.g + s.lo);
    for (int base = threadIdx.x; base < s.nv; base += THREADS * UNROLL) {
      float4 G[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < s.nv) G[u] = __ldcs(g4 + i);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (base + u * THREADS < s.nv)
          acc += square(G[u].x) + square(G[u].y) + square(G[u].z) +
                 square(G[u].w);
    }
    for (long long i = s.lo + 4LL * s.nv + threadIdx.x; i < s.hi;
         i += THREADS)
      acc += square(L.g[i]);
  }
  const double block = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = block;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double sum = 0.0;
  for (int b = threadIdx.x; b < gridDim.x; b += THREADS)
    sum += __ldcg(partial + b);
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(static_cast<float>(sum));
    const float s = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-9f)), max_norm);
    out[0] = norm;
    out[1] = s > 1.0f ? 1.0f : s;  // torch.clamp(max=1): NaN stays NaN
    *done = 0;
  }
}

// A persistent grid: as many blocks as fit on the SMs at once, at most one
// a chunk and at most `max_blocks`.
template <typename K>
cudaError_t grid_for(K kernel, long long n_chunks, int max_blocks,
                     int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  long long g = static_cast<long long>(sms) * per_sm;
  g = g < n_chunks ? g : n_chunks;
  g = g < max_blocks ? g : max_blocks;
  *grid = g > 1 ? static_cast<int>(g) : 1;
  return err;
}

}  // namespace

extern "C" {

// table: n_leaves rows of `Leaf`, on the card; workspace: max_blocks doubles
// then a 0 counter; out: 2 floats (norm, scale).  Returns a cudaError_t.
int fused_adamw_norm(const void* table, int n_leaves, long long n_chunks,
                     void* workspace, float max_norm, void* out,
                     int max_blocks, void* stream) {
  if (n_leaves < 1 || n_chunks < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 1;
  cudaError_t err = grid_for(norm_kernel, n_chunks, max_blocks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  double* partial = static_cast<double*>(workspace);
  norm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), n_leaves, n_chunks, partial,
      reinterpret_cast<unsigned*>(partial + max_blocks), max_norm,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// scale: the norm launch's out + 1 (a float on the card).
int fused_adamw_update(const void* table, int n_leaves, long long n_chunks,
                       const void* scale, float b1, float one_minus_b1,
                       float b2, float one_minus_b2, float inv_bc1,
                       float inv_bc2, float eps, float wd, float neg_lr,
                       void* stream) {
  if (n_leaves < 1 || n_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 1;
  cudaError_t err = grid_for(update_kernel, n_chunks, 1 << 30, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps,
                wd, neg_lr};
  update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), n_leaves, n_chunks,
      static_cast<const float*>(scale), h);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
