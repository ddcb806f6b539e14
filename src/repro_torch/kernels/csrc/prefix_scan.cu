// Row-wise exclusive prefix sum in float64: the paper's scan operator
// (Definition 3.1) on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/prefix_scan.py::prefix_scan_pallas. The TPU
// kernel walks a row's column blocks in grid order and carries the running
// row total in VMEM scratch from one grid step to the next. Hopper blocks run
// in no order, so here the carry lives inside one block: block r owns row r.
//
// Bits: out[j] = fl(c[j] - x[j]) with c[j] = fl(c[j-1] + x[j]), the running
// sum taken strictly left to right -- bit for bit what the plain version
// (torch.cumsum(x) - x on the CPU) and the numpy oracle (np.cumsum(x) - x in
// simulate_scalar) compute. The batched engine feeds these values to
// searchsorted, a discrete branch: a task whose position lies within a few
// ulps of an interval edge takes its owner from the last bits of the scan,
// and any other association order (a blocked or tree scan) moves such a
// task to the neighbouring node on bursty traces. Floating-point addition
// does not associate, so this order admits no parallel split: one thread
// walks the row.
//
// Shape of the walk: the block stages the row through shared memory in
// tiles of kTile doubles, two buffers. While lane 0 of warp 0 walks tile t
// (one dependent add per element; the loads, a group ahead, and the
// subtraction are off the chain), the other warps store tile t-1 and load
// tile t+1 coalesced, so the walk runs at the add chain's latency and
// memory stays hidden. A zero past the row's end adds nothing (c + 0 = c).
//
// Bound: bytes. Each element is read once and written once (16 B in
// float64); a (128, 1.38M) call moves 2.8 GB, >= 0.84 ms at 3.35 TB/s. The
// add chain of one row bounds the time from below far above that: n
// dependent float64 adds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;
constexpr int kMovers = kThreads - 32;                    // warps 1..7
constexpr int kMoves = (kTile + kMovers - 1) / kMovers;   // elements each
constexpr int kGroup = 8;                                 // walker's batch

__global__ void __launch_bounds__(kThreads)
sequential_scan_rows(const double* __restrict__ x, double* __restrict__ out,
                     int64_t n) {
  __shared__ double buf[2][kTile];
  const int tid = threadIdx.x;
  const double* xr = x + static_cast<int64_t>(blockIdx.x) * n;
  double* outr = out + static_cast<int64_t>(blockIdx.x) * n;
  const int64_t n_tiles = (n + kTile - 1) / kTile;

  // prologue: every thread loads tile 0
  for (int i = tid; i < kTile; i += kThreads) {
    buf[0][i] = i < n ? xr[i] : 0.0;
  }
  __syncthreads();

  double c = 0.0;  // the running sum; only lane 0 of warp 0 keeps it
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int cur = static_cast<int>(t & 1);
    if (tid == 0) {
      // groups of kGroup: the next group's loads are issued before this
      // group's adds and stores, so no load waits inside the add chain
      // (past the row's end the tile holds zeros, and those outputs are
      // never stored)
      double* b = buf[cur];
      double x[kGroup], nx[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) x[k] = b[k];
      for (int j = 0; j < kTile; j += kGroup) {
        if (j + kGroup < kTile) {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) nx[k] = b[j + kGroup + k];
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          c += x[k];
          b[j + k] = c - x[k];
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) x[k] = nx[k];
      }
    } else if (tid >= 32) {
      // warps 1..7: store tile t-1 from the other buffer, then load tile
      // t+1 into it, all of a thread's loads in flight at once; each thread
      // reads its elements before it writes them
      double* o = buf[cur ^ 1];
      const int64_t prev = (t - 1) * kTile;
      const int64_t next = (t + 1) * kTile;
      if (t > 0) {
#pragma unroll
        for (int k = 0; k < kMoves; ++k) {
          const int i = tid - 32 + k * kMovers;
          if (i < kTile && prev + i < n) outr[prev + i] = o[i];
        }
      }
      if (next < n) {
        double v[kMoves];
#pragma unroll
        for (int k = 0; k < kMoves; ++k) {
          const int i = tid - 32 + k * kMovers;
          v[k] = i < kTile && next + i < n ? xr[next + i] : 0.0;
        }
#pragma unroll
        for (int k = 0; k < kMoves; ++k) {
          const int i = tid - 32 + k * kMovers;
          if (i < kTile) o[i] = v[k];
        }
      }
    }
    __syncthreads();
  }
  // epilogue: store the last tile
  const int64_t last = (n_tiles - 1) * kTile;
  const double* b = buf[(n_tiles - 1) & 1];
  for (int i = tid; i < kTile; i += kThreads) {
    if (last + i < n) outr[last + i] = b[i];
  }
}

}  // namespace

// out[r, j] = x[r, 0] + ... + x[r, j-1] for a row-major (rows, n) float64
// array on `device`, launched on `stream`, with the plain version's bits
// (see above). Returns a cudaError_t (0 = ok).
extern "C" int prefix_scan_f64(const double* x, double* out, int64_t rows,
                               int64_t n, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  sequential_scan_rows<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prefix_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
