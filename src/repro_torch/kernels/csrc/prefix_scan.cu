// Row-wise exclusive prefix sum in float64: the paper's scan operator
// (Definition 3.1) on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/prefix_scan.py::prefix_scan_pallas. The TPU
// kernel walks a row's column blocks in grid order and carries the running
// row total in VMEM scratch from one grid step to the next. Hopper blocks run
// in no order, so here the carry lives inside one block: block r owns row r,
// loops over the row's column tiles and keeps the running total in a register.
//
// Bound: bytes. Each element is read once and written once (16 B in float64)
// for one add, so the card's memory rate bounds it: a (128, 1.38M) call moves
// 2.8 GB, >= 0.84 ms at 3.35 TB/s. Each tile is loaded and stored coalesced
// through shared memory; the in-tile scan is serial over a thread's
// consecutive items, then warp shuffles, then the carry. One block per row
// means a call with fewer rows than SMs leaves SMs idle; the main path has
// 128 rows (one per scenario), which is close to the card's 132 SMs.
//
// Determinism: the association order is fixed by the tile shape, so a run
// is bit-reproducible (torch.cumsum on CUDA floats is not).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// one padding word per 32 doubles keeps a thread's consecutive items off
// the banks of its neighbours
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ double warp_inclusive_sum(double v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
exclusive_scan_rows(const double* __restrict__ x, double* __restrict__ out,
                    int64_t n) {
  __shared__ double tile[kTile + kTile / 32];
  __shared__ double warp_incl[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double* xr = x + static_cast<int64_t>(blockIdx.x) * n;
  double* outr = out + static_cast<int64_t>(blockIdx.x) * n;

  double carry = 0.0;
  for (int64_t start = 0; start < n; start += kTile) {
    // coalesced load; past the ragged edge the tile holds zeros
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + tid;
      const int64_t j = start + i;
      tile[padded(i)] = j < n ? xr[j] : 0.0;
    }
    __syncthreads();

    // serial exclusive scan over this thread's consecutive items
    double v[kItems];
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const double xv = tile[padded(tid * kItems + k)];
      v[k] = run;
      run += xv;
    }
    // exclusive scan of the thread totals: within the warp, then across warps
    const double incl = warp_inclusive_sum(run, lane);
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const double s = lane < kWarps ? warp_incl[lane] : 0.0;
      const double si = warp_inclusive_sum(s, lane);
      if (lane < kWarps) warp_incl[lane] = si;
    }
    __syncthreads();
    const double offset = (warp > 0 ? warp_incl[warp - 1] : 0.0) + excl;
    const double tile_total = warp_incl[kWarps - 1];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      tile[padded(tid * kItems + k)] = carry + (offset + v[k]);
    }
    __syncthreads();

    // coalesced store
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + tid;
      const int64_t j = start + i;
      if (j < n) outr[j] = tile[padded(i)];
    }
    carry += tile_total;
    __syncthreads();  // the next tile overwrites tile[] and warp_incl[]
  }
}

}  // namespace

// out[r, j] = x[r, 0] + ... + x[r, j-1] for a row-major (rows, n) float64
// array on `device`, launched on `stream`. Returns a cudaError_t (0 = ok).
extern "C" int prefix_scan_f64(const double* x, double* out, int64_t rows,
                               int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  exclusive_scan_rows<<<static_cast<unsigned>(rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prefix_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
