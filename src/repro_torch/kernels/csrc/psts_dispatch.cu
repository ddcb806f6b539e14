// FIFO dispatch prefix in float64 on Hopper (sm_90a): for each token j of
// row r whose destination e = expert_idx[r, j] lies in [0, E), prefix[r, j]
// is the weight of the EARLIER tokens of row r routed to e (the backlog the
// slot's own dispatch wave builds in front of j), and fill[r, e] is the total
// weight routed to e. A token whose destination lies outside [0, E) (-1 =
// none) gets prefix 0 and adds nothing.
//
// Replaces: src/repro/kernels/psts_dispatch.py::dispatch_work_prefix_pallas.
// The TPU kernel builds a (block, 128) one-hot in VMEM and scans it down the
// token axis, which caps E at one 128-lane tile. At full width E is the node
// count, 12,500, and a one-hot would be 12,500 values per token. Here each
// row keeps ONE float64 accumulator per destination instead: in shared
// memory while E * 8 B fits beside the tile buffers (E up to ~23,000 on an
// H100), else in the row of the `fill` output itself.
//
// Bound: bytes. Every token's destination is read (4 B) and its prefix
// written (8 B); a token with a destination also has its weight read (8 B);
// fill is written once. On the main path only ~1/T of a row's tokens have a
// destination in a given slot, so the pass over the row dominates and the
// walk over the valid tokens is short.
//
// Design: block r owns row r. For each tile of 2048 tokens the block reads
// the destinations in parallel (coalesced), writes prefix 0 for the tokens
// without one, and compacts the valid tokens, in index order, into shared
// memory with a block-wide scan of per-thread counts. Thread 0 then walks the
// compacted tokens serially, which is the order FIFO semantics need and makes
// every prefix and fill the exact left-to-right sum of the numpy loop in
// runtime/vector_backend.py::simulate_scalar: the result is bit-reproducible.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ int warp_inclusive_count(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
work_prefix_rows(const int32_t* __restrict__ expert_idx,
                 const double* __restrict__ weights,
                 double* __restrict__ prefix, double* __restrict__ fill,
                 int64_t n_tokens, int n_experts, bool acc_in_shared) {
  extern __shared__ double acc_smem[];
  __shared__ int dest[kTile + kTile / 32];
  __shared__ int list_j[kTile];
  __shared__ int list_e[kTile];
  __shared__ double list_w[kTile];
  __shared__ int warp_incl[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const int32_t* er = expert_idx + row * n_tokens;
  const double* wr = weights + row * n_tokens;
  double* pr = prefix + row * n_tokens;
  double* fr = fill + row * static_cast<int64_t>(n_experts);
  double* acc = acc_in_shared ? acc_smem : fr;

  for (int e = tid; e < n_experts; e += kThreads) acc[e] = 0.0;
  __syncthreads();

  for (int64_t start = 0; start < n_tokens; start += kTile) {
    // coalesced read of the destinations; tokens without one get prefix 0
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + tid;
      const int64_t j = start + i;
      int e = -1;
      if (j < n_tokens) {
        e = er[j];
        if (e < 0 || e >= n_experts) {
          e = -1;
          pr[j] = 0.0;
        }
      }
      dest[padded(i)] = e;
    }
    __syncthreads();

    // compact the valid tokens in index order: thread t owns the kItems
    // consecutive tokens t*kItems.., so (thread, item) order is index order
    int mine[kItems];
    int count = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      mine[k] = dest[padded(tid * kItems + k)];
      count += mine[k] >= 0;
    }
    const int incl = warp_inclusive_count(count, lane);
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int s = lane < kWarps ? warp_incl[lane] : 0;
      const int si = warp_inclusive_count(s, lane);
      if (lane < kWarps) warp_incl[lane] = si;
    }
    __syncthreads();
    int slot = (warp > 0 ? warp_incl[warp - 1] : 0) + incl - count;
    const int n_valid = warp_incl[kWarps - 1];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (mine[k] >= 0) {
        const int i = tid * kItems + k;
        list_j[slot] = i;
        list_e[slot] = mine[k];
        list_w[slot] = wr[start + i];
        ++slot;
      }
    }
    __syncthreads();

    // serial FIFO walk over this tile's valid tokens
    if (tid == 0) {
      for (int v = 0; v < n_valid; ++v) {
        const int e = list_e[v];
        const double before = acc[e];
        pr[start + list_j[v]] = before;
        acc[e] = before + list_w[v];
      }
    }
    __syncthreads();  // the next tile overwrites dest[] and the lists
  }

  if (acc_in_shared) {
    for (int e = tid; e < n_experts; e += kThreads) fr[e] = acc_smem[e];
  }
}

}  // namespace

// prefix (rows, n_tokens) and fill (rows, n_experts), row-major float64, from
// expert_idx (rows, n_tokens) int32 and weights (rows, n_tokens) float64 on
// `device`, launched on `stream`. Returns a cudaError_t (0 = ok).
extern "C" int dispatch_work_prefix_f64(const int32_t* expert_idx,
                                        const double* weights, double* prefix,
                                        double* fill, int64_t rows,
                                        int64_t n_tokens, int64_t n_experts,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (rows > 0x7fffffff || n_experts <= 0 || n_experts > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, work_prefix_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t acc_bytes = n_experts * static_cast<int64_t>(sizeof(double));
  const bool acc_in_shared =
      static_cast<int64_t>(attr.sharedSizeBytes) + acc_bytes <= optin;
  const int dyn = acc_in_shared ? static_cast<int>(acc_bytes) : 0;
  err = cudaFuncSetAttribute(work_prefix_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);

  work_prefix_rows<<<static_cast<unsigned>(rows), kThreads, dyn,
                     static_cast<cudaStream_t>(stream)>>>(
      expert_idx, weights, prefix, fill, n_tokens,
      static_cast<int>(n_experts), acc_in_shared);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* psts_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
