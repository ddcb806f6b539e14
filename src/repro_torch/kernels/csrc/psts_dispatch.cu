// Two PSTS dispatch kernels on Hopper (sm_90a): the FIFO dispatch prefix in
// float64 (dispatch_work_prefix_f64, two launches) and the MoE expert-dispatch
// positions in int32 over k priority levels (dispatch_positions_levels_i32,
// one launch, at the end of the file).
//
// ---------------------------------------------------------------------------
// FIFO dispatch prefix in float64: for each token j of row r whose
// destination e = expert_idx[r, j] lies in [0, E), prefix[r, j] is the weight
// of the EARLIER tokens of row r routed to e (the backlog the slot's own
// dispatch wave builds in front of j), and fill[r, e] is the total weight
// routed to e. A token whose destination lies outside [0, E) (-1 = none) gets
// prefix 0 and adds nothing. Given init (R, E), each destination's sum
// starts there instead of at 0: prefix and fill then include init[r, e],
// and fill = ((init + w1) + w2) + ..., the order in which
// np.add.at(queue, owner, works) adds a slot's wave to the queues.
//
// Replaces: src/repro/kernels/psts_dispatch.py::dispatch_work_prefix_pallas.
// The TPU kernel builds a (block, 128) one-hot in VMEM and scans it down the
// token axis, which caps E at one 128-lane tile. At full width E is the node
// count, 12,500. Here each destination keeps ONE float64 accumulator.
//
// Exactness: every prefix and fill is the left-to-right float64 sum of the
// numpy loop in runtime/vector_backend.py::simulate_scalar (acc[e] += w in
// token order), bit for bit. acc[e] only ever sees destination e's own
// tokens, so any schedule that keeps each destination's additions in token
// order gives the same bits: the work is split across destinations, never
// across the tokens of one destination (carry + (w1 + w2) is not
// (carry + w1) + w2).
//
// Bound: bytes. Every token's destination is read (4 B) and its prefix
// written (8 B); a token with a destination also has its weight read (8 B);
// fill is written once. On the main path's slot wave ~1/200 of a row's
// tokens have a destination, so the pass over the row dominates.
//
// Design, two launches (one ops.dispatch_work_prefix call, which its launch
// counter counts once):
//  1. work_prefix_stage, grid (chunks of 16,384 tokens, rows): the bandwidth
//     pass over the whole card. Each thread keeps 16 destination loads of 16
//     bytes in flight, writes prefix 0 for the tokens without a destination
//     (16-byte stores where all four of a load have none), and the block
//     compacts its valid tokens in index order into the chunk's own staging
//     region (token, destination, weight), with the chunk's count and its
//     least and greatest destination. The region holds a whole chunk, so no
//     counting pass comes first. A chunk whose every token has a
//     destination is not staged: the walk reads it in place.
//  2. work_prefix_walk, grid (destination ranges, rows), one warp a block:
//     the ordered walk. Block p owns the destinations [E p / P, E (p+1) / P)
//     of its row, with their accumulators in shared memory while they fit
//     (else in the row of `fill`), and walks the row's tokens chunk by chunk
//     in index order, skipping chunks whose destinations miss its range,
//     loading the next 128 tokens while it walks the current ones. A warp
//     takes 32 tokens at a time and groups its lanes by destination with
//     __match_any_sync; each group's lowest lane (its leader) carries the
//     group's sum in a register and adds its members' weights, handed over
//     through shared memory, in lane order (token order), noting each
//     member's prefix before adding its weight. Groups of different
//     destinations run side by side, and destination ranges spread one
//     row's chains over many SMs: the per-slot totals call (E = T slots,
//     nearly every token valid) has its slots in long runs of consecutive
//     tokens, which one block would walk one after another.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// -- pass 1: stage
constexpr int kStageThreads = 256;
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kStageLoads = 16;                          // int4 per thread
constexpr int kStageStride = kStageThreads * 4;          // tokens per load
constexpr int kChunk = kStageStride * kStageLoads;       // 16,384 tokens
// -- pass 2: walk
constexpr int kWalkBatches = 4;       // 32-token batches loaded at once
constexpr int kWalkBlocks = 2048;     // aim of rows x destination ranges
constexpr int kMaxRanges = 64;

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// four consecutive destinations from token j on (-1 past the row's end):
// one 16-byte load where the row allows it
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* er, int64_t j,
                                      int64_t n_tokens) {
  if (kVec && j + 3 < n_tokens)
    return __ldcs(reinterpret_cast<const int4*>(er + j));
  int4 d;
  d.x = j < n_tokens ? er[j] : -1;
  d.y = j + 1 < n_tokens ? er[j + 1] : -1;
  d.z = j + 2 < n_tokens ? er[j + 2] : -1;
  d.w = j + 3 < n_tokens ? er[j + 3] : -1;
  return d;
}

__device__ __forceinline__ int get(const int4& d, int c) {
  return c == 0 ? d.x : c == 1 ? d.y : c == 2 ? d.z : d.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kStageThreads)
work_prefix_stage(const int32_t* __restrict__ expert_idx,
                  const double* __restrict__ weights,
                  double* __restrict__ prefix, int2* __restrict__ stage_je,
                  double* __restrict__ stage_w, int4* __restrict__ meta,
                  int64_t rows, int64_t n_tokens, int n_chunks,
                  int n_experts) {
  __shared__ int offs[kStageLoads * kStageWarps];  // (load, warp) order
  __shared__ int wmin[kStageWarps], wmax[kStageWarps];
  __shared__ bool in_place;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int64_t start = static_cast<int64_t>(chunk) * kChunk;

  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int32_t* er = expert_idx + row * n_tokens;
    const double* wr = weights + row * n_tokens;
    double* pr = prefix + row * n_tokens;
    const int64_t slot = row * n_chunks + chunk;

    // token of (load k, thread, c): start + k * kStageStride + tid * 4 + c,
    // so (k, warp, lane, c) order is index order
    int4 d[kStageLoads];
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k)
      d[k] = load4<kVec>(er, start + k * kStageStride + tid * 4, n_tokens);

    unsigned valid[kStageLoads];  // 4 bits per load
    int incl[kStageLoads];
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      unsigned bits = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = get(d[k], c);
        if (e >= 0 && e < n_experts) {
          bits |= 1u << c;
          lo = min(lo, e);
          hi = max(hi, e);
        }
      }
      valid[k] = bits;
      incl[k] = warp_inclusive_sum(__popc(bits), lane);
      if (lane == 31) offs[k * kStageWarps + warp] = incl[k];
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      wmin[warp] = lo;
      wmax[warp] = hi;
    }
    __syncthreads();

    // exclusive offsets of the 128 (load, warp) counts, in that order
    if (warp == 0) {
      int v[4];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = offs[lane * 4 + i];
        sum += v[i];
      }
      int run = warp_inclusive_sum(sum, lane) - sum;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        offs[lane * 4 + i] = run;
        run += v[i];
      }
      int m = lane < kStageWarps ? wmin[lane] : INT_MAX;
      int x = lane < kStageWarps ? wmax[lane] : -1;
      m = __reduce_min_sync(kFull, m);
      x = __reduce_max_sync(kFull, x);
      if (lane == 31) {
        const bool dense = run == min(static_cast<int64_t>(kChunk),
                                      n_tokens - start);
        meta[slot] = make_int4(run, m, x, dense);
        in_place = dense;
      }
    }
    __syncthreads();
    // a chunk whose every token has a destination is walked in place
    if (in_place) {
      __syncthreads();  // the next row rewrites in_place
      continue;
    }

    int2* sje = stage_je + slot * kChunk;
    double* sw = stage_w + slot * kChunk;
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int64_t j0 = start + k * kStageStride + tid * 4;
      int o = offs[k * kStageWarps + warp] + incl[k] - __popc(valid[k]);
      if (kVec && valid[k] == 0 && j0 + 3 < n_tokens) {
        double2* p2 = reinterpret_cast<double2*>(pr + j0);
        __stcs(p2, make_double2(0.0, 0.0));
        __stcs(p2 + 1, make_double2(0.0, 0.0));
        continue;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t j = j0 + c;
        if (valid[k] >> c & 1u) {
          sje[o] = make_int2(static_cast<int>(j), get(d[k], c));
          sw[o] = wr[j];
          ++o;
        } else if (j < n_tokens) {
          pr[j] = 0.0;
        }
      }
    }
    __syncthreads();  // the next row reuses offs, wmin and wmax
  }
}

// One 32-token batch of the walk: lanes with the same destination form a
// group; the group's leader adds its members' weights in lane order (token
// order) to the destination's sum, noting each member's prefix first.
// Weights come in and prefixes go out through shared memory at fixed
// addresses, all loads ahead of the sum, so the leader's loop is a chain of
// float64 adds and nothing waits on a load inside it.
__device__ __forceinline__ void walk_batch(int e, int j, double w,
                                           double* acc, double* pr,
                                           double* hand, int lane) {
  if (!__any_sync(kFull, e >= 0)) return;
  const unsigned peers = __match_any_sync(kFull, e);
  hand[lane] = w;
  __syncwarp();
  if (e >= 0 && lane == __ffs(peers) - 1) {
    double x[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) x[l] = hand[l];
    double a = acc[e];
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const bool member = peers >> l & 1u;
      if (member) hand[l] = a;  // member l's prefix
      a = member ? a + x[l] : a;
    }
    acc[e] = a;
  }
  __syncwarp();
  if (e >= 0) pr[j] = hand[lane];
  __syncwarp();  // hand and acc are read by the next batch
}

// up to kWalkBatches x 32 tokens of a chunk from entry b0 on, with their
// destinations made local to [lo, hi) (-1 = outside it, or past the count)
struct WalkBatches {
  int e[kWalkBatches];
  int j[kWalkBatches];
  double w[kWalkBatches];
};

__device__ __forceinline__ void fetch(WalkBatches& f, int b0, int n,
                                      bool in_place, const int2* sje,
                                      const double* sw, const int32_t* er,
                                      const double* wr, int64_t start,
                                      int lo, int hi, int lane) {
#pragma unroll
  for (int q = 0; q < kWalkBatches; ++q) {
    const int v = b0 + q * 32 + lane;
    int e = -1, j = 0;
    double w = 0.0;
    if (v < n) {
      if (in_place) {
        j = static_cast<int>(start + v);
        e = er[j];
        w = wr[j];
      } else {
        const int2 je = sje[v];
        j = je.x;
        e = je.y;
        w = sw[v];
      }
    }
    f.e[q] = e >= lo && e < hi ? e - lo : -1;
    f.j[q] = j;
    f.w[q] = w;
  }
}

__global__ void __launch_bounds__(32)
work_prefix_walk(const int32_t* __restrict__ expert_idx,
                 const double* __restrict__ weights,
                 const int2* __restrict__ stage_je,
                 const double* __restrict__ stage_w,
                 const int4* __restrict__ meta, double* __restrict__ prefix,
                 double* __restrict__ fill, const double* __restrict__ init,
                 int64_t rows, int64_t n_tokens,
                 int n_chunks, int n_experts, int ranges,
                 bool acc_in_shared) {
  extern __shared__ double acc_smem[];
  __shared__ double hand[32];
  const int lane = threadIdx.x;
  const int p = blockIdx.x;
  const int lo = static_cast<int>(static_cast<int64_t>(n_experts) * p /
                                  ranges);
  const int hi = static_cast<int>(static_cast<int64_t>(n_experts) * (p + 1) /
                                  ranges);
  const int width = hi - lo;

  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int32_t* er = expert_idx + row * n_tokens;
    const double* wr = weights + row * n_tokens;
    double* pr = prefix + row * n_tokens;
    double* fr = fill + row * static_cast<int64_t>(n_experts);
    double* acc = acc_in_shared ? acc_smem : fr + lo;
    const double* ir =
        init ? init + row * static_cast<int64_t>(n_experts) + lo : nullptr;
    for (int e = lane; e < width; e += 32) acc[e] = ir ? ir[e] : 0.0;
    __syncwarp();

    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const int4 m = c0 + lane < n_chunks
                         ? meta[row * n_chunks + c0 + lane]
                         : make_int4(0, INT_MAX, -1, 0);
      unsigned hits = __ballot_sync(kFull, m.x > 0 && m.z >= lo && m.y < hi);
      while (hits) {
        const int i = __ffs(hits) - 1;
        hits &= hits - 1;
        const int n = __shfl_sync(kFull, m.x, i);
        const bool in_place = __shfl_sync(kFull, m.w, i) != 0;
        const int64_t slot = row * n_chunks + c0 + i;
        const int2* sje = stage_je + slot * kChunk;
        const double* sw = stage_w + slot * kChunk;
        const int64_t start = static_cast<int64_t>(c0 + i) * kChunk;
        // the next batches load while this one is walked
        WalkBatches cur, next;
        fetch(cur, 0, n, in_place, sje, sw, er, wr, start, lo, hi, lane);
        for (int b0 = 0; b0 < n; b0 += 32 * kWalkBatches) {
          if (b0 + 32 * kWalkBatches < n)
            fetch(next, b0 + 32 * kWalkBatches, n, in_place, sje, sw, er,
                  wr, start, lo, hi, lane);
#pragma unroll
          for (int q = 0; q < kWalkBatches; ++q)
            walk_batch(cur.e[q], cur.j[q], cur.w[q], acc, pr, hand, lane);
          cur = next;
        }
      }
    }

    if (acc_in_shared) {
      for (int e = lane; e < width; e += 32) fr[lo + e] = acc_smem[e];
    }
    __syncwarp();  // the next row clears the accumulators
  }
}


// ---------------------------------------------------------------------------
// MoE expert-dispatch positions in int32 over k priority levels: topk
// (R, T, k) holds each token's expert at each level (outside [0, E), e.g.
// -1, means none). Level s counts from base_s, with base_0 = `base` (or 0)
// and base_s = min(fill_{s-1}, capacity): pos[r, j, s] = base_s[e] + the
// number of EARLIER tokens of row r whose level-s expert is e (the paper's
// load scan S, one priority slot of sched/moe_dispatch.py::_positions_scan;
// all first choices place before any second choice), kept iff pos <
// capacity; a token without an expert gets position 0. `filled` =
// min(fill_{k-1}, capacity). A position at or past the capacity keeps its
// unclamped value. With k = 1, a base and capacity INT_MAX this is one
// level of the JAX kernel: the single-level op (ops.dispatch_positions).
//
// Replaces: src/repro/kernels/psts_dispatch.py::dispatch_positions_pallas,
// called k times per MoE layer there (once per level, the clamp between
// them in XLA). The TPU kernel builds a (block, 128) int32 one-hot in VMEM
// and scans it, which caps E at one 128-lane tile. Here E is not capped.
//
// Bound: bytes, 4 B read and 4 B + 1 B written per (token, level), 4 B per
// expert of base and fill: 1.2 MB at granite's prefill (8, 2048, k 8, E
// 32), 0.35 us at 3.35 TB/s, so a launch is bound by its latency and by the
// host's issue, not by either rate. One launch per MoE layer and forward
// replaces k.
//
// Design: block r owns row r. It copies the row's T x k experts into shared
// memory with 16-byte loads (64 KB at (2048, 8)) where they fit, and
// overwrites them with the positions level by level. Per level, the row
// goes in rounds of 2,048 tokens, 32 consecutive tokens to a "group" of
// lanes (a warp's item i: 64 groups a round, in token order):
//  - table path (the (64 x E) counts fit in shared memory): inside a group,
//    __match_any_sync ranks the lanes that share an expert, and the lowest
//    of them writes their count to the group's row of the table. One
//    exclusive scan down each expert's column (a thread a column) from the
//    level's running fill then gives each group its start: no group waits
//    for another.
//  - ordered-claim path (large E): one token per thread; the 16 warps
//    claim their counters in the row of `filled` in warp order, one
//    __syncthreads each.
// Between levels the fill is clamped to the capacity in the kernel. All
// integer arithmetic: exact and independent of timing.

constexpr int kPosThreads = 512;
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPosItems = 4;                           // tokens a lane, a round
constexpr int kPosGroups = kPosWarps * kPosItems;      // 64 table rows
constexpr int kPosRound = 32 * kPosGroups;             // 2,048 tokens

// the table's int32 cells (64 rows of counts, then E of running fill),
// rounded up to 16 bytes so that the staged row behind it takes int4 stores
__host__ __device__ __forceinline__ int64_t table_ints(int64_t n_experts) {
  return ((kPosGroups + 1) * n_experts + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kPosThreads)
positions_levels(const int32_t* __restrict__ topk,
                 const int32_t* __restrict__ base, int32_t* __restrict__ pos,
                 uint8_t* __restrict__ keep, int32_t* __restrict__ filled,
                 int64_t n_tokens, int k, int n_experts, int capacity,
                 bool table, bool staged) {
  extern __shared__ int32_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const int64_t n = n_tokens * k;
  const int32_t* tr = topk + row * n;
  int32_t* orow = pos + row * n;
  int32_t* fr = filled + row * static_cast<int64_t>(n_experts);
  const unsigned lower_lanes = (1u << lane) - 1u;
  // table: cnt (64 x E), then the running fill (E); staged: the row
  int32_t* cnt = smem;
  int32_t* run = table ? smem + kPosGroups * n_experts : fr;
  int32_t* cells = smem + (table ? table_ints(n_experts) : 0);
  const int32_t* src = staged ? cells : tr;
  int32_t* dst = staged ? cells : orow;

  if (staged) {
    const bool vec = (n & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(tr) & 15) == 0;
    if (vec) {
      for (int64_t i = tid; i < n / 4; i += kPosThreads)
        reinterpret_cast<int4*>(cells)[i] =
            __ldcs(reinterpret_cast<const int4*>(tr) + i);
    } else {
      for (int64_t i = tid; i < n; i += kPosThreads) cells[i] = tr[i];
    }
  }
  for (int e = tid; e < n_experts; e += kPosThreads)
    run[e] = base != nullptr ? base[row * n_experts + e] : 0;
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    if (table) {
      for (int64_t start = 0; start < n_tokens; start += kPosRound) {
        const bool last = start + kPosRound >= n_tokens;
        // groups holding a token this round (1 of 64 in a decode step)
        const int groups = static_cast<int>(
            min(static_cast<int64_t>(kPosGroups), (n_tokens - start + 31) / 32));
        for (int i = tid; i < groups * n_experts; i += kPosThreads)
          cnt[i] = 0;
        __syncthreads();
        // group g = warp * kPosItems + i holds tokens start + 32 g + lane
        int e[kPosItems], rank[kPosItems];
#pragma unroll
        for (int i = 0; i < kPosItems; ++i) {
          const int g = warp * kPosItems + i;
          const int64_t j = start + 32 * g + lane;
          e[i] = -1;
          rank[i] = 0;
          if (g >= groups) continue;
          int x = -1;
          if (j < n_tokens) {
            x = src[j * k + s];
            if (x < 0 || x >= n_experts) x = -1;
          }
          const unsigned peers = __match_any_sync(kFull, x);
          if (x >= 0 && lane == __ffs(peers) - 1)
            cnt[g * n_experts + x] = __popc(peers);
          e[i] = x;
          rank[i] = __popc(peers & lower_lanes);
        }
        __syncthreads();
        // each expert's column, in group order, from the level's running
        // fill: a thread a column, its loads independent of the sum
        for (int x = tid; x < n_experts; x += kPosThreads) {
          int carry = run[x];
#pragma unroll 16
          for (int g = 0; g < groups; ++g) {
            const int v = cnt[g * n_experts + x];
            cnt[g * n_experts + x] = carry;
            carry += v;
          }
          // the next level counts from the kept fill
          run[x] = last ? min(carry, capacity) : carry;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kPosItems; ++i) {
          const int g = warp * kPosItems + i;
          const int64_t j = start + 32 * g + lane;
          if (j < n_tokens) {
            const int p = e[i] >= 0 ? cnt[g * n_experts + e[i]] + rank[i]
                                    : 0;
            dst[j * k + s] = p;
            if (!staged && keep != nullptr)
              keep[row * n + j * k + s] = p < capacity;
          }
        }
        __syncthreads();  // the next round clears the table
      }
      if (n_tokens == 0) {
        for (int x = tid; x < n_experts; x += kPosThreads)
          run[x] = min(run[x], capacity);
        __syncthreads();
      }
    } else {
      for (int64_t start = 0; start < n_tokens; start += kPosThreads) {
        const int64_t j = start + tid;
        int x = -1;
        if (j < n_tokens) {
          x = src[j * k + s];
          if (x < 0 || x >= n_experts) x = -1;
        }
        const unsigned peers = __match_any_sync(kFull, x);
        const int r = __popc(peers & lower_lanes);
        int claimed = 0;
        // warps claim their counters in warp order: token order in the row
        for (int w = 0; w < kPosWarps; ++w) {
          if (warp == w && r == 0 && x >= 0) {
            claimed = run[x];
            run[x] = claimed + __popc(peers);
          }
          __syncthreads();
        }
        claimed = __shfl_sync(kFull, claimed, __ffs(peers) - 1);
        if (j < n_tokens) {
          const int p = x >= 0 ? claimed + r : 0;
          dst[j * k + s] = p;
          if (!staged && keep != nullptr)
            keep[row * n + j * k + s] = p < capacity;
        }
      }
      // the next level counts from the kept fill
      for (int x = tid; x < n_experts; x += kPosThreads)
        run[x] = min(run[x], capacity);
      __syncthreads();
    }
  }

  if (staged) {
    for (int64_t i = tid; i < n; i += kPosThreads) {
      const int p = cells[i];
      orow[i] = p;
      if (keep != nullptr) keep[row * n + i] = p < capacity;
    }
  }
  if (table) {
    for (int x = tid; x < n_experts; x += kPosThreads) fr[x] = run[x];
  }
}

// Each kernel's room for dynamic shared memory on a device (the opt-in
// maximum less its static shared memory), with the kernel's limit raised to
// it: once per device, since these calls cost more host time than a short
// launch.
struct DeviceSetup {
  bool done = false;
  int walk_room = 0;
  int positions_room = 0;
};

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int optin, int* room) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *room = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *room);
  if (err != cudaSuccess) return err;
  // as much of the SM's memory as shared memory as it can take: the walk's
  // one-warp blocks are many to an SM only so
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t setup(int device, const DeviceSetup** out) {
  static DeviceSetup cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  DeviceSetup& s = cache[device];
  if (!s.done) {
    int optin = 0;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
            cudaSuccess ||
        (err = raise_smem(work_prefix_walk, optin, &s.walk_room)) !=
            cudaSuccess ||
        (err = raise_smem(positions_levels, optin, &s.positions_room)) !=
            cudaSuccess)
      return err;
    s.done = true;
  }
  *out = &s;
  return cudaSuccess;
}

}  // namespace

// prefix (rows, n_tokens) and fill (rows, n_experts), row-major float64, from
// expert_idx (rows, n_tokens) int32 and weights (rows, n_tokens) float64 on
// `device`, each destination's sum started at init (rows, n_experts) float64
// or at 0 when init is null, in two launches on `stream`, through staging
// buffers of rows x chunks x kChunk tokens (stage_je int2, stage_w double)
// and rows x chunks int4 (meta), chunks = ceil(n_tokens / kChunk). Returns a
// cudaError_t (0 = ok).
extern "C" int dispatch_work_prefix_f64(const int32_t* expert_idx,
                                        const double* weights, double* prefix,
                                        double* fill, void* stage_je,
                                        double* stage_w, void* meta,
                                        const double* init,
                                        int64_t rows, int64_t n_tokens,
                                        int64_t n_experts, int device,
                                        void* stream) {
  const DeviceSetup* dev = nullptr;
  cudaError_t err = setup(device, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (n_experts <= 0 || n_experts > INT_MAX || n_tokens > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = static_cast<int>((n_tokens + kChunk - 1) / kChunk);
  const unsigned grid_rows = static_cast<unsigned>(rows < 65535 ? rows
                                                                 : 65535);
  const int e = static_cast<int>(n_experts);
  if (n_chunks > 0) {
    const bool vec = n_tokens % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(expert_idx) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(prefix) & 15) == 0;
    const dim3 grid(static_cast<unsigned>(n_chunks), grid_rows);
    auto* je = static_cast<int2*>(stage_je);
    auto* m = static_cast<int4*>(meta);
    if (vec)
      work_prefix_stage<true><<<grid, kStageThreads, 0, st>>>(
          expert_idx, weights, prefix, je, stage_w, m, rows, n_tokens,
          n_chunks, e);
    else
      work_prefix_stage<false><<<grid, kStageThreads, 0, st>>>(
          expert_idx, weights, prefix, je, stage_w, m, rows, n_tokens,
          n_chunks, e);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  // destination ranges: enough blocks to spread one row's chains
  int ranges = static_cast<int>((kWalkBlocks + rows - 1) / rows);
  ranges = ranges < 1 ? 1 : ranges > kMaxRanges ? kMaxRanges : ranges;
  ranges = ranges > e ? e : ranges;
  const int64_t acc_bytes =
      (n_experts + ranges - 1) / ranges * static_cast<int64_t>(sizeof(double));
  const bool acc_in_shared = acc_bytes <= dev->walk_room;
  work_prefix_walk<<<dim3(static_cast<unsigned>(ranges), grid_rows), 32,
                     acc_in_shared ? static_cast<int>(acc_bytes) : 0, st>>>(
      expert_idx, weights, static_cast<const int2*>(stage_je), stage_w,
      static_cast<const int4*>(meta), prefix, fill, init, rows, n_tokens,
      n_chunks, e, ranges, acc_in_shared);
  return static_cast<int>(cudaGetLastError());
}

// pos (rows, n_tokens, k) int32, keep (rows, n_tokens, k) uint8 (may be
// null) and filled (rows, n_experts) int32 from topk (rows, n_tokens, k)
// int32 and base (rows, n_experts) int32 (null = 0) on `device`, in one
// launch on `stream`. Returns a cudaError_t (0 = ok).
extern "C" int dispatch_positions_levels_i32(const int32_t* topk,
                                             const int32_t* base, int32_t* pos,
                                             uint8_t* keep, int32_t* filled,
                                             int64_t rows, int64_t n_tokens,
                                             int64_t k, int64_t n_experts,
                                             int64_t capacity, int device,
                                             void* stream) {
  const DeviceSetup* dev = nullptr;
  cudaError_t err = setup(device, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (rows > INT_MAX || k <= 0 || k > INT_MAX || n_experts <= 0 ||
      n_experts > INT_MAX || capacity < 0 || capacity > INT_MAX ||
      n_tokens > INT_MAX / k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t room = dev->positions_room;
  const int64_t table_bytes = table_ints(n_experts) * 4;
  const bool table = table_bytes <= room;
  const int64_t used = table ? table_bytes : 0;
  const int64_t row_bytes = n_tokens * k * 4;
  const bool staged = used + row_bytes <= room;
  const int dyn = static_cast<int>(used + (staged ? row_bytes : 0));
  positions_levels<<<static_cast<unsigned>(rows), kPosThreads, dyn,
                     static_cast<cudaStream_t>(stream)>>>(
      topk, base, pos, keep, filled, n_tokens, static_cast<int>(k),
      static_cast<int>(n_experts), static_cast<int>(capacity), table, staged);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* psts_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
