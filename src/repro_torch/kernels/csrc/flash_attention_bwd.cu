// Flash attention backward on Hopper (sm_90a): dQ, dK and dV of the index
// form of flash_attention.cu's forward (causal, optional sliding window,
// optional tanh soft-cap c * tanh(x / c)), float32 accumulation, gradients
// in the input type. Two pairs of kernels, picked by type:
//
//   flash_bwd_dq_tc, flash_bwd_dkdv_tc   bfloat16, on the tensor cores
//                  (mma.sync m16n8k16 bf16 -> f32); the training path's.
//   flash_bwd_dq, flash_bwd_dkdv         float32, float32 FMAs from shared
//                  memory (TF32 products would keep ~3 digits, too few for
//                  float32 callers).
//
// Replaces: the gradient that jax.grad takes of the JAX package's training
// attention (src/repro/models/attention.py:97, chunked_attention); the TPU
// kernel src/repro/kernels/flash_attention.py:93 (flash_attention_pallas)
// has no backward. A FlashAttention-2 split in two launches on one stream:
// a dQ kernel, one block per (batch, head, query tile), then a dK/dV kernel,
// one block per (batch, KV head, key tile), which keeps its K and V tile and
// its dK, dV and walks every query tile that sees its key tile, for each of
// the H / KV query heads of its group in turn. So the GQA sum over query
// heads needs no atomics and has a fixed order: two calls give the same
// bits, and a resumed training run replays the first.
//
// Both recompute P = exp(logit - LSE) from q, k and the forward's per-row
// natural log-sum-exp (flash_attention.cu writes it when asked), under the
// forward's mask: a masked logit gives P = 0 exactly, as the reference's
// where(mask, logits, -2^30) does. With dP = dO V^T, dS = P (dP - D) times
// (1 - tanh^2) under a soft-cap, times the scale; then dV = P^T dO,
// dK = dS^T Q, dQ = dS K. D is the softmax backward's sum_j P dP, taken in
// float32 from the float32 products, as autograd takes it from the
// reference, not rowsum(dO * O) of the forward's output: that output is
// rounded to bf16, and where dP - D cancels (a query that sees few keys)
// its rounding puts whole rows of dQ off (0.19 relative on the worst row at
// the training shape). The dQ kernel walks its key tiles twice, first for D
// (which it writes for the dK/dV kernel), then for dQ: S and dP are formed
// three times, 9 products of 2 * hd flops a visible pair where 5 would do.
// Query tile t visits key tile u iff u is in make_plan(t); the dK/dV kernel
// walks exactly the query tiles whose plan holds its key tile (key_walk),
// so both skip the tiles the forward skips.
//
// Bound: at granite-moe-1b-a400m's training shape (B 4, H 16, KV 8, S 2048,
// hd 64, bf16, causal) the 5 products take ~86 GFLOP: 0.087 ms at the 989
// TFLOP/s bf16 tensor-core rate, against ~84 MB of q, k, v, dO, the LSE and
// dq, dk, dv at 3.35 TB/s (0.025 ms); operations bound it. The 9 products
// this design does take 0.156 ms at that rate.
//
// The bf16 kernels (tc::): 16 rows of the block's fixed side (queries for
// dQ, keys for dK/dV) a warp, 64-row tiles at hd 64 and 128, 32-query tiles
// at hd 256 (Tune<HD>; hd below a width is zero-filled up to it). The fixed
// side (Q and dO, or K and V) is copied once by cp.async and read by
// ldmatrix as the mma's A fragments (kept in registers by the dQ kernel at
// hd 64); the walked side goes through a double-buffered cp.async ring,
// tile t + 1 in flight while tile t is computed, with bf16 rows padded by 16
// bytes so that the 8 rows one ldmatrix reads fall in 8 bank groups. A warp
// takes the walked tile in kSub sub-tiles. The fragments are the forward's:
//   dQ kernel    S = Q K^T and dP = dO V^T take K and V by ldmatrix as the
//                B ("col") operand; dS goes from the f32 accumulators
//                straight into bf16 A fragments (two n8 accumulators make
//                one k16 fragment) and dQ += dS K reads K by
//                ldmatrix.trans, as the forward reads V.
//   dK/dV kernel S^T = K Q^T and dP^T = V dO^T read Q and dO as the B
//                operand; P^T and dS^T become A fragments; dV += P^T dO and
//                dK += dS^T Q read dO and Q by ldmatrix.trans. A thread's
//                accumulator rows are keys and its columns queries, so the
//                LSE and D of the query tile (copied with it) go by column.
// P and dS are formed in float32 and rounded to bf16 only as mma operands.
// P takes exp2 with log2(e) folded into one FFMA. Masks are tested only on
// tiles that touch an edge (the diagonal, the window's edge, S). Wider heads
// split a row group's output columns over 2 warps (kColQ, kColKV), each
// forming the group's S and dP itself, so that the accumulators fit the
// registers (at hd 256 the dK and dV of 16 keys alone are 256 registers a
// thread). The grids rank blocks longest first: the last query tile, and
// key tile 0, see the most tiles under causality.
//
// ptxas (nvcc 12.9, sm_90a), threads and dynamic shared bytes a block:
//   hd 64    dq_tc 128 registers (cap: 4 blocks an SM), 72 / 212 bytes of
//            spill stores / loads, 128 threads, 55,296 B; dkdv_tc 128
//            registers, 100 / 88 bytes spilled, 128 threads, 56,320 B
//   hd 128   dq_tc 248 registers, 128 threads, 104,448 B; dkdv_tc 221,
//            256 threads, 105,472 B; no spills
//   hd 256   dq_tc 244 registers, 128 threads, 168,960 B; dkdv_tc 241,
//            256 threads, 135,680 B; no spills
//
// The float32 kernels: a 16 x 16 thread grid owns a TILE x TILE block of
// logits, each thread TILE / 16 rows by TILE / 16 columns, interleaved by
// 16; tiles are row-major with an odd pitch (HD + 1 floats), so the 16
// threads that read 16 different rows at one column hit 16 different banks.
// TILE is 64 for head widths up to 128 and 32 for 256 (shared memory: 100
// KB, 166 KB and 140 KB a block). The dQ kernel walks its KV tiles twice,
// once for D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16

struct Strides {  // element strides over (batch, head, sequence)
  int64_t b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, S) contiguous
  float* delta;      // (B, H, S) contiguous: D, written by the dQ kernel
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, KV, S, hd;
  float scale;
  int causal, window;
  float softcap;
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// flash_attention.cu's make_plan in the index form (L = S, no padded rows):
// the KV tiles [first, first + n) that query rows [q0, min(q0 + bq, S)) visit.
struct Plan {
  int first, n;
};

__host__ __device__ __forceinline__ Plan make_plan(int q0, int bq, int bk,
                                                   int S, bool causal,
                                                   int window) {
  const int q1 = imin(q0 + bq, S);
  if (q0 >= q1) return {0, 0};
  const int first = (window > 0 ? imax(0, q0 - window + 1) : 0) / bk;
  const int last = ((causal ? q1 : S) + bk - 1) / bk;
  return {first, imax(0, last - first)};
}

// The dK/dV kernel's walk: the query tiles (of bq rows) whose plan holds the
// key tile at k0, a run [first, first + n) (a plan's first and last tiles
// never decrease from one query tile to the next). Under causality no query
// tile before k0 / bq reaches key k0.
struct Walk {
  int first, n;
};

__host__ __device__ __forceinline__ Walk key_walk(int k0, int bq, int bk,
                                                  int S, bool causal,
                                                  int window) {
  const int kt = k0 / bk;
  const int n_qt = (S + bq - 1) / bq;
  int first = -1, n = 0;
  for (int qt = causal ? k0 / bq : 0; qt < n_qt; ++qt) {
    const Plan plan = make_plan(qt * bq, bq, bk, S, causal, window);
    if (kt < plan.first) break;  // later query tiles start later still
    if (kt >= plan.first + plan.n) {
      if (first >= 0) break;
      continue;
    }
    if (first < 0) first = qt;
    ++n;
  }
  return {first < 0 ? 0 : first, n};
}

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// Rows [0, rows) x columns [0, hd) of a (row stride `ld`) tile into a
// TILE x HD float tile of pitch HD + 1, zero elsewhere; consecutive threads
// read consecutive elements of a row.
template <typename T, int HD, int TILE>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t ld, int rows, int hd) {
  for (int u = threadIdx.x; u < TILE * HD; u += kThreads) {
    const int r = u / HD;
    const int d = u % HD;
    float x = 0.0f;
    if (r < rows && d < hd) x = to_f(src[static_cast<int64_t>(r) * ld + d]);
    dst[r * (HD + 1) + d] = x;
  }
}

// The per-row LSE and D of query rows [q0, q0 + TILE) of head (b, h).
template <int TILE>
__device__ __forceinline__ void load_rows(float* __restrict__ lse_s,
                                          float* __restrict__ del_s,
                                          const Args& a, int b, int h,
                                          int q0) {
  if (threadIdx.x < TILE) {
    const int i = q0 + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.S + i;
    lse_s[threadIdx.x] = i < a.S ? a.lse[at] : 0.0f;
    del_s[threadIdx.x] = i < a.S ? a.delta[at] : 0.0f;
  }
}

// P of query i and key j, both < S, from the raw product qk = q_i . k_j,
// and t = tanh(logit / cap) under a soft-cap.
__device__ __forceinline__ float pair_p(float qk, float lse, int i, int j,
                                        const Args& a, float& t) {
  bool ok = true;
  if (a.causal) ok = i >= j;
  if (a.window > 0) ok = ok && (i - j) < a.window;
  float x = qk * a.scale;
  t = 0.0f;
  if (a.softcap > 0.0f) {
    t = tanhf(x / a.softcap);
    x = a.softcap * t;
  }
  return ok ? expf(x - lse) : 0.0f;
}

// P and dS (scaled to units of q.k) of query i and key j, both < S, from
// qk and dp = dO_i . v_j.
__device__ __forceinline__ void pair_grads(float qk, float dp, float lse,
                                           float delta, int i, int j,
                                           const Args& a, float& p,
                                           float& ds) {
  float t;
  p = pair_p(qk, lse, i, j, a, t);
  float d = p * (dp - delta);
  if (a.softcap > 0.0f) d *= 1.0f - t * t;
  ds = d * a.scale;
}

template <int HD, int TILE>
constexpr int dkdv_smem() {
  return (4 * TILE * (HD + 1) + 2 * TILE * (TILE + 1) + 2 * TILE) * 4;
}

template <int HD, int TILE>
constexpr int dq_smem() {
  return (4 * TILE * (HD + 1) + TILE * (TILE + 1) + 2 * TILE) * 4;
}

// S and dP of a TILE x TILE block: rows (ty + 16 x) of A and B, columns
// (tx + 16 y) of C and D: s = A C^T, dp = B D^T, over HD.
template <int HD, int R>
__device__ __forceinline__ void products(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         const float* __restrict__ C,
                                         const float* __restrict__ D,
                                         int tx, int ty, float (&s)[R][R],
                                         float (&dp)[R][R]) {
  constexpr int P = HD + 1;
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int y = 0; y < R; ++y) s[x][y] = dp[x][y] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[R], bv[R], cv[R], dv[R];
#pragma unroll
    for (int x = 0; x < R; ++x) {
      av[x] = A[(ty + 16 * x) * P + d];
      bv[x] = B[(ty + 16 * x) * P + d];
      cv[x] = C[(tx + 16 * x) * P + d];
      dv[x] = D[(tx + 16 * x) * P + d];
    }
#pragma unroll
    for (int x = 0; x < R; ++x)
#pragma unroll
      for (int y = 0; y < R; ++y) {
        s[x][y] = fmaf(av[x], cv[y], s[x][y]);
        dp[x][y] = fmaf(bv[x], dv[y], dp[x][y]);
      }
  }
}

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(Args a) {
  constexpr int P = HD + 1;     // pitch of the TILE x HD tiles
  constexpr int PP = TILE + 1;  // pitch of the TILE x TILE tiles
  constexpr int R = TILE / 16;  // keys (and queries) a thread owns
  constexpr int C = HD / 16;    // output columns a thread owns
  extern __shared__ float smem[];
  float* Ks = smem;                  // [TILE][P]
  float* Vs = Ks + TILE * P;         // [TILE][P]
  float* Qs = Vs + TILE * P;         // [TILE][P]
  float* Gs = Qs + TILE * P;         // [TILE][P] dO
  float* Ps = Gs + TILE * P;         // [TILE keys][PP] P^T
  float* Ds = Ps + TILE * PP;        // [TILE keys][PP] dS^T
  float* lse_s = Ds + TILE * PP;     // [TILE]
  float* del_s = lse_s + TILE;       // [TILE]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kt = blockIdx.x;
  const int k0 = kt * TILE;
  const int b = blockIdx.y / a.KV;
  const int kvh = blockIdx.y % a.KV;
  const int rep = a.H / a.KV;
  const int S = a.S;

  load_tile<T, HD, TILE>(Ks,
                         static_cast<const T*>(a.k) + b * a.sk.b +
                             kvh * a.sk.h + k0 * a.sk.s,
                         a.sk.s, imin(TILE, S - k0), a.hd);
  load_tile<T, HD, TILE>(Vs,
                         static_cast<const T*>(a.v) + b * a.sv.b +
                             kvh * a.sv.h + k0 * a.sv.s,
                         a.sv.s, imin(TILE, S - k0), a.hd);

  float dk[R][C], dv[R][C];
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[x][c] = dv[x][c] = 0.0f;

  const int n_qt = (S + TILE - 1) / TILE;
  // causal: no query tile before the key tile sees it
  for (int qt = a.causal ? kt : 0; qt < n_qt; ++qt) {
    const Plan plan = make_plan(qt * TILE, TILE, TILE, S, a.causal != 0,
                                a.window);
    if (kt < plan.first) break;  // later query tiles start later still
    if (kt >= plan.first + plan.n) continue;
    const int q0 = qt * TILE;
    for (int r = 0; r < rep; ++r) {
      const int h = kvh * rep + r;
      __syncthreads();  // the previous query tile's readers are done
      load_tile<T, HD, TILE>(Qs,
                             static_cast<const T*>(a.q) + b * a.sq.b +
                                 h * a.sq.h + q0 * a.sq.s,
                             a.sq.s, imin(TILE, S - q0), a.hd);
      load_tile<T, HD, TILE>(Gs,
                             static_cast<const T*>(a.dout) + b * a.sdo.b +
                                 h * a.sdo.h + q0 * a.sdo.s,
                             a.sdo.s, imin(TILE, S - q0), a.hd);
      load_rows<TILE>(lse_s, del_s, a, b, h, q0);
      __syncthreads();

      // S^T and dP^T: keys ty + 16 x, queries tx + 16 y
      float s[R][R], dp[R][R];
      products<HD, R>(Ks, Vs, Qs, Gs, tx, ty, s, dp);
#pragma unroll
      for (int x = 0; x < R; ++x)
#pragma unroll
        for (int y = 0; y < R; ++y) {
          const int jl = ty + 16 * x;
          const int il = tx + 16 * y;
          float p = 0.0f, ds = 0.0f;
          if (q0 + il < S && k0 + jl < S)
            pair_grads(s[x][y], dp[x][y], lse_s[il], del_s[il], q0 + il,
                       k0 + jl, a, p, ds);
          Ps[jl * PP + il] = p;
          Ds[jl * PP + il] = ds;
        }
      __syncthreads();

      // dV[j] += sum_i P[i, j] dO[i]; dK[j] += sum_i dS[i, j] Q[i]
#pragma unroll 4
      for (int i = 0; i < TILE; ++i) {
        float pv[R], dsv[R];
#pragma unroll
        for (int x = 0; x < R; ++x) {
          pv[x] = Ps[(ty + 16 * x) * PP + i];
          dsv[x] = Ds[(ty + 16 * x) * PP + i];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float g = Gs[i * P + tx + 16 * c];
          const float qq = Qs[i * P + tx + 16 * c];
#pragma unroll
          for (int x = 0; x < R; ++x) {
            dv[x][c] = fmaf(pv[x], g, dv[x][c]);
            dk[x][c] = fmaf(dsv[x], qq, dk[x][c]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h;
  T* dv_out = static_cast<T*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h;
#pragma unroll
  for (int x = 0; x < R; ++x) {
    const int j = k0 + ty + 16 * x;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hd) {
        dk_out[j * a.sdk.s + col] = from_f<T>(dk[x][c]);
        dv_out[j * a.sdv.s + col] = from_f<T>(dv[x][c]);
      }
    }
  }
}

template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Args a) {
  constexpr int P = HD + 1;
  constexpr int PP = TILE + 1;
  constexpr int R = TILE / 16;  // queries (and keys) a thread owns
  constexpr int C = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [TILE][P]
  float* Gs = Qs + TILE * P;         // [TILE][P] dO
  float* Ks = Gs + TILE * P;         // [TILE][P]
  float* Vs = Ks + TILE * P;         // [TILE][P]
  float* Ds = Vs + TILE * P;         // [TILE queries][PP] dS
  float* lse_s = Ds + TILE * PP;
  float* del_s = lse_s + TILE;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TILE;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int S = a.S;

  load_tile<T, HD, TILE>(Qs,
                         static_cast<const T*>(a.q) + b * a.sq.b +
                             h * a.sq.h + q0 * a.sq.s,
                         a.sq.s, imin(TILE, S - q0), a.hd);
  load_tile<T, HD, TILE>(Gs,
                         static_cast<const T*>(a.dout) + b * a.sdo.b +
                             h * a.sdo.h + q0 * a.sdo.s,
                         a.sdo.s, imin(TILE, S - q0), a.hd);
  if (threadIdx.x < TILE) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] =
        i < S ? a.lse[(static_cast<int64_t>(b) * a.H + h) * S + i] : 0.0f;
  }

  float dq[R][C];
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int c = 0; c < C; ++c) dq[x][c] = 0.0f;

  const Plan plan = make_plan(q0, TILE, TILE, S, a.causal != 0, a.window);
  const T* kbase = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* vbase = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  auto load_kv = [&](int k0) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD, TILE>(Ks, kbase + k0 * a.sk.s, a.sk.s,
                           imin(TILE, S - k0), a.hd);
    load_tile<T, HD, TILE>(Vs, vbase + k0 * a.sv.s, a.sv.s,
                           imin(TILE, S - k0), a.hd);
    __syncthreads();
  };

  // pass 1: D[i] = sum_j P[i, j] dP[i, j]; the 16 threads of a row (tx)
  // sum their parts with shuffles (they share a half warp)
  float dsum[R];
#pragma unroll
  for (int x = 0; x < R; ++x) dsum[x] = 0.0f;
  for (int t = 0; t < plan.n; ++t) {
    const int k0 = (plan.first + t) * TILE;
    load_kv(k0);
    float s[R][R], dp[R][R];
    products<HD, R>(Qs, Gs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int x = 0; x < R; ++x)
#pragma unroll
      for (int y = 0; y < R; ++y) {
        const int il = ty + 16 * x;
        const int jl = tx + 16 * y;
        if (q0 + il < S && k0 + jl < S) {
          float tnh;
          const float p = pair_p(s[x][y], lse_s[il], q0 + il, k0 + jl, a,
                                 tnh);
          dsum[x] = fmaf(p, dp[x][y], dsum[x]);
        }
      }
  }
#pragma unroll
  for (int x = 0; x < R; ++x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum[x] += __shfl_xor_sync(0xffffffffu, dsum[x], off);
    const int il = ty + 16 * x;
    if (tx == 0) {
      del_s[il] = dsum[x];
      if (q0 + il < S)
        a.delta[(static_cast<int64_t>(b) * a.H + h) * S + q0 + il] = dsum[x];
    }
  }

  // pass 2: dQ
  for (int t = 0; t < plan.n; ++t) {
    const int k0 = (plan.first + t) * TILE;
    load_kv(k0);  // its first barrier also publishes del_s

    // S and dP: queries ty + 16 x, keys tx + 16 y
    float s[R][R], dp[R][R];
    products<HD, R>(Qs, Gs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int x = 0; x < R; ++x)
#pragma unroll
      for (int y = 0; y < R; ++y) {
        const int il = ty + 16 * x;
        const int jl = tx + 16 * y;
        float p = 0.0f, ds = 0.0f;
        if (q0 + il < S && k0 + jl < S)
          pair_grads(s[x][y], dp[x][y], lse_s[il], del_s[il], q0 + il,
                     k0 + jl, a, p, ds);
        Ds[il * PP + jl] = ds;
      }
    __syncthreads();

    // dQ[i] += sum_j dS[i, j] K[j]
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float dsv[R];
#pragma unroll
      for (int x = 0; x < R; ++x) dsv[x] = Ds[(ty + 16 * x) * PP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kk = Ks[j * P + tx + 16 * c];
#pragma unroll
        for (int x = 0; x < R; ++x) dq[x][c] = fmaf(dsv[x], kk, dq[x][c]);
      }
    }
  }

  T* dq_out = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int x = 0; x < R; ++x) {
    const int i = q0 + ty + 16 * x;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hd) dq_out[i * a.sdq.s + col] = from_f<T>(dq[x][c]);
    }
  }
}

// Lets `kKernel` take `bytes` of dynamic shared memory; once per kernel and
// device.
template <auto kKernel>
cudaError_t allow_smem(int bytes, int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <typename T, int HD, int TILE>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  constexpr int kv_bytes = dkdv_smem<HD, TILE>();
  constexpr int q_bytes = dq_smem<HD, TILE>();
  cudaError_t err = allow_smem<flash_bwd_dkdv<T, HD, TILE>>(kv_bytes, device);
  if (err == cudaSuccess)
    err = allow_smem<flash_bwd_dq<T, HD, TILE>>(q_bytes, device);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.S + TILE - 1) / TILE;
  // the dQ kernel writes D, which the dK/dV kernel reads (one stream)
  flash_bwd_dq<T, HD, TILE>
      <<<dim3(n_tiles, a.B * a.H), kThreads, q_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, HD, TILE>
      <<<dim3(n_tiles, a.B * a.KV), kThreads, kv_bytes, stream>>>(a);
  return cudaGetLastError();
}

// The float32 kernels' tiles: 64 queries and 64 keys, 32 at HD = 256.
constexpr int fma_tile(int hd) { return hd <= 128 ? 64 : 32; }

cudaError_t launch_fma(const Args& a, int device, cudaStream_t stream) {
  if (a.hd <= 64) return launch<float, 64, fma_tile(64)>(a, device, stream);
  if (a.hd <= 128)
    return launch<float, 128, fma_tile(128)>(a, device, stream);
  return launch<float, 256, fma_tile(256)>(a, device, stream);
}


// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16 bf16 -> f32), cp.async ring
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// The tile plan by head width, for both kernels: query tiles of kBQ rows,
// key tiles of kBK. A dQ block owns one query tile (kBQ / 16 row groups of
// 16 queries) and walks key tiles; a dK/dV block owns one key tile (kBK / 16
// row groups) and walks query tiles. kColQ / kColKV warps share a row group,
// each owning HD / kCol of the output columns and computing the group's S
// and dP itself (the dK and dV accumulators take HD / kCol registers a
// thread each). A warp takes the walked tile in kSub sub-tiles, so that the
// logit and dP accumulators of one sub-tile alone are live (32 registers a
// thread at 64 columns). kRegsQ keeps the dQ kernel's A fragments (Q and
// dO) in registers; the dK/dV kernel re-reads K and V from shared memory.
// kMinBlocks is the blocks an SM should hold (__launch_bounds__, hence a
// register cap). At hd 64 (measured on the card at granite-train's shape)
// a cap of 128 registers (4 blocks, 16 warps an SM) spills a little and
// ran 1.24 -> 0.90 ms against no cap; K and V in registers ran the dK/dV
// kernel 12% slower, Q and dO in shared memory the dQ kernel 5% slower, and
// tiles of 128 queries or keys (8 warps, the same cap) no faster.
template <int HD>
struct Tune;
template <>
struct Tune<64> {
  static constexpr int kBQ = 64, kBK = 64, kColQ = 1, kColKV = 1;
  static constexpr bool kRegsQ = true;
  static constexpr int kSub = 2, kMinBlocks = 4;
};
template <>
struct Tune<128> {
  static constexpr int kBQ = 64, kBK = 64, kColQ = 1, kColKV = 2;
  static constexpr bool kRegsQ = false;
  static constexpr int kSub = 1, kMinBlocks = 1;
};
template <>
struct Tune<256> {
  static constexpr int kBQ = 32, kBK = 64, kColQ = 2, kColKV = 2;
  static constexpr bool kRegsQ = false;
  static constexpr int kSub = 1, kMinBlocks = 1;
};

// Threads and shared bytes of one kernel: kFixed rows held for the whole
// block, a double-buffered ring of kWalk-row tiles, bf16 rows padded by 16
// bytes (ldmatrix without bank conflicts; cp.async's 16-byte stores stay
// aligned), and kRowFloats float32 values beside them.
template <int HD, int kFixedRows, int kWalkRows, int kCol, int kRowFloats>
struct Shape {
  static constexpr int kLd = HD + 8;
  static constexpr int kThreads = 32 * (kFixedRows / 16) * kCol;
  static constexpr int kFixed = kFixedRows * kLd;
  static constexpr int kTile = kWalkRows * kLd;
  static constexpr int kSmem = (2 * kFixed + 4 * kTile) * 2 + kRowFloats * 4;
};
// dQ: Q and dO fixed, K and V walked
template <int HD>
using QShape = Shape<HD, Tune<HD>::kBQ, Tune<HD>::kBK, Tune<HD>::kColQ, 0>;
// dK/dV: K and V fixed, Q and dO walked with their rows' LSE and D
template <int HD>
using KvShape =
    Shape<HD, Tune<HD>::kBK, Tune<HD>::kBQ, Tune<HD>::kColKV,
          4 * Tune<HD>::kBQ>;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Rows [0, rows_valid) x columns [0, hd) of a row-major bf16 tile (row
// stride `ld`) into a kRows x HD shared tile of pitch HD + 8, zero
// elsewhere, by cp.async: consecutive threads copy consecutive 16-byte
// pieces of a row.
template <int HD, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t ld, int rows_valid,
                                          int hd) {
  constexpr int kChunks = HD / 8;
  for (int u = threadIdx.x; u < kRows * kChunks; u += kThreads) {
    const int r = u / kChunks;
    const int c = (u % kChunks) * 8;
    const bool ok = r < rows_valid && c < hd;
    cp_async16(dst + r * (HD + 8) + c, ok ? src + r * ld + c : src, ok);
  }
}

// The 16 x HD A fragments of rows [r0, r0 + 16) of a shared tile
// (ldmatrix lane l: row l % 16, columns (l / 16) * 8 of each 16-column
// slice), kept in registers or re-read each time.
template <int HD, bool kInRegs>
struct AFrags {
  unsigned f[kInRegs ? HD / 16 : 1][4];
  const bf16* p;
  __device__ __forceinline__ void init(const bf16* tile, int r0, int lane) {
    p = tile + (r0 + (lane & 15)) * (HD + 8) + (lane >> 4) * 8;
    if constexpr (kInRegs) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(f[kk], p + kk * 16);
    }
  }
  __device__ __forceinline__ void get(unsigned (&a)[4], int kk) const {
    if constexpr (kInRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
    } else {
      ldmatrix_x4(a, p + kk * 16);
    }
  }
};

// x = A X^T and y = B Y^T for a warp's 16 rows of A, B (fragments) against
// the kN * 8 rows of the shared tiles X, Y (pitch HD + 8): X's rows are the
// n index, so a non-transposed ldmatrix of an 8 x 8 (row, dim) block is the
// B fragment, and x4 gives two n8 tiles' k16 halves.
template <int HD, int kN, bool kInRegs>
__device__ __forceinline__ void two_products(
    const AFrags<HD, kInRegs>& A, const AFrags<HD, kInRegs>& B,
    const bf16* X, const bf16* Y, int lane, float (&x)[kN][4],
    float (&y)[kN][4]) {
  constexpr int kLd = HD + 8;
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[n][c] = y[n][c] = 0.0f;
  const int off =
      (((lane >> 4) << 3) + (lane & 7)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    unsigned a[4], b[4];
    A.get(a, kk);
    B.get(b, kk);
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      unsigned bx[4], by[4];
      ldmatrix_x4(bx, X + off + np * 16 * kLd + kk * 16);
      mma(x[2 * np], a, bx[0], bx[1]);
      mma(x[2 * np + 1], a, bx[2], bx[3]);
      ldmatrix_x4(by, Y + off + np * 16 * kLd + kk * 16);
      mma(y[2 * np], b, by[0], by[1]);
      mma(y[2 * np + 1], b, by[2], by[3]);
    }
  }
}

// acc (16 x kD * 8) += P (16 x kK * 8, f32 accumulators, rounded to bf16 as
// the A operand: the accumulators of n8 tiles 2kk and 2kk + 1 are the A
// fragment of slice kk) times columns [c0, c0 + kD * 8) of the shared tile
// X (kK * 8 rows, pitch HD + 8), read by ldmatrix.trans (lane l: row l % 16,
// columns (l / 16) * 8), which gives the B fragments of two n8 tiles.
template <int HD, int kK, int kD>
__device__ __forceinline__ void product_acc(const float (&p)[kK][4],
                                            const bf16* X, int c0, int lane,
                                            float (&acc)[kD][4]) {
  constexpr int kLd = HD + 8;
  const bf16* xf = X + (lane & 15) * kLd + (lane >> 4) * 8 + c0;
#pragma unroll
  for (int kk = 0; kk < kK / 2; ++kk) {
    const unsigned a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kD / 2; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, xf + kk * 16 * kLd + dp * 16);
      mma(acc[2 * dp], a, b[0], b[1]);
      mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// P and dS (in units of q.k) of query i and key j from the raw products
// qk = q_i . k_j and dp = dO_i . v_j, with lse2 = LSE_i * log2(e); ok:
// the mask admits the pair. P = exp(logit - LSE) as exp2 with log2(e) in
// one FFMA; a masked pair gives P = dS = 0 exactly.
__device__ __forceinline__ void pair_tc(float qk, float dp, float lse2,
                                        float delta, bool ok, const Args& a,
                                        float& p, float& ds) {
  float d;
  if (a.softcap > 0.0f) {
    const float t = tanhf(qk * (a.scale / a.softcap));
    p = ok ? ex2(fmaf(a.softcap * kLog2e, t, -lse2)) : 0.0f;
    d = p * (dp - delta) * (1.0f - t * t);
  } else {
    p = ok ? ex2(fmaf(qk, a.scale * kLog2e, -lse2)) : 0.0f;
    d = p * (dp - delta);
  }
  ds = d * a.scale;
}

// Whether the mask admits every pair of query rows [q0, q0 + bq) and keys
// [k0, k0 + bk): then no pair of the tile needs its test.
__device__ __forceinline__ bool tile_full(int q0, int bq, int k0, int bk,
                                          const Args& a) {
  return q0 + bq <= a.S && k0 + bk <= a.S &&
         (!a.causal || k0 + bk - 1 <= q0) &&
         (a.window <= 0 || q0 + bq - 1 - k0 < a.window);
}

__device__ __forceinline__ bool admits(int i, int j, const Args& a) {
  bool ok = i < a.S && j < a.S;
  if (a.causal) ok = ok && i >= j;
  if (a.window > 0) ok = ok && i - j < a.window;
  return ok;
}

// dQ (and D = sum_j P dP, written to a.delta): one block per (batch, head,
// query tile), the longest tiles (the last, under causality) first. It
// walks its plan's key tiles twice, first for D, then for dQ.
template <int HD>
__global__ void __launch_bounds__(QShape<HD>::kThreads, Tune<HD>::kMinBlocks)
flash_bwd_dq_tc(Args a) {
  using Tn = Tune<HD>;
  using Sh = QShape<HD>;
  constexpr int kBQ = Tn::kBQ, kBK = Tn::kBK;
  constexpr int kLd = HD + 8;
  constexpr int kN = kBK / 8 / Tn::kSub;   // n8 tiles of a logit sub-tile
  constexpr int kD = HD / Tn::kColQ / 8;   // n8 tiles of the warp's dQ
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);  // [kBQ][kLd]
  bf16* Gs = Qs + Sh::kFixed;                   // [kBQ][kLd] dO
  bf16* Ks = Gs + Sh::kFixed;                   // [2][kBK][kLd]
  bf16* Vs = Ks + 2 * Sh::kTile;                // [2][kBK][kLd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row within the warp's 8-row halves
  const int tig = lane & 3;  // thread in the quad that shares a row
  const int rg = warp / Tn::kColQ;               // the warp's 16 queries
  const int c0 = (warp % Tn::kColQ) * (HD / Tn::kColQ);  // its dQ columns
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  const int S = a.S;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const Plan plan = make_plan(q0, kBQ, kBK, S, a.causal != 0, a.window);
  const int n_steps = 2 * plan.n;  // pass 0: D; pass 1: dQ

  const bf16* kbase = static_cast<const bf16*>(a.k) + b * a.sk.b +
                      kvh * a.sk.h;
  const bf16* vbase = static_cast<const bf16*>(a.v) + b * a.sv.b +
                      kvh * a.sv.h;
  auto prefetch = [&](int t) {
    const int k0 = (plan.first + t % plan.n) * kBK;
    const int rows = imin(kBK, S - k0);
    load_rows<HD, kBK, Sh::kThreads>(Ks + (t & 1) * Sh::kTile,
                                     kbase + k0 * a.sk.s, a.sk.s, rows, a.hd);
    load_rows<HD, kBK, Sh::kThreads>(Vs + (t & 1) * Sh::kTile,
                                     vbase + k0 * a.sv.s, a.sv.s, rows, a.hd);
  };
  const int q_rows = imin(kBQ, S - q0);
  load_rows<HD, kBQ, Sh::kThreads>(
      Qs, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h +
              q0 * a.sq.s,
      a.sq.s, q_rows, a.hd);
  load_rows<HD, kBQ, Sh::kThreads>(
      Gs, static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h +
              q0 * a.sdo.s,
      a.sdo.s, q_rows, a.hd);
  if (n_steps > 0) prefetch(0);
  cp_async_commit();

  // the thread's rows rg * 16 + g + 8 * hh: LSE (times log2 e) and D
  const int64_t row0 = (static_cast<int64_t>(b) * a.H + h) * S + q0;
  float lse2[2], dsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rg * 16 + g + 8 * hh;
    lse2[hh] = r < q_rows ? a.lse[row0 + r] * kLog2e : 0.0f;
  }
  float dq[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[d][c] = 0.0f;
  AFrags<HD, Tn::kRegsQ> qa, ga;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t == 0) {
      qa.init(Qs, rg * 16, lane);
      ga.init(Gs, rg * 16, lane);
    }
    if (t + 1 < n_steps) prefetch(t + 1);
    cp_async_commit();

    const int k0 = (plan.first + t % plan.n) * kBK;
    const bf16* Kt = Ks + (t & 1) * Sh::kTile;
    const bf16* Vt = Vs + (t & 1) * Sh::kTile;
    const bool full = tile_full(q0, kBQ, k0, kBK, a);
    const bool second = t >= plan.n;
#pragma unroll
    for (int sub = 0; sub < Tn::kSub; ++sub) {
      const int j0 = sub * kN * 8;  // the sub-tile's first key
      // S = Q K^T, dP = dO V^T; s[n][c] is query rg * 16 + g + 8 * (c >> 1),
      // key j0 + n * 8 + 2 * tig + (c & 1) of the tiles
      float s[kN][4], dp[kN][4];
      two_products<HD, kN>(qa, ga, Kt + j0 * kLd, Vt + j0 * kLd, lane, s, dp);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hh = c >> 1;
          const bool ok =
              full || admits(q0 + rg * 16 + g + 8 * hh,
                             k0 + j0 + n * 8 + 2 * tig + (c & 1), a);
          float p, ds;
          pair_tc(s[n][c], dp[n][c], lse2[hh], second ? dsum[hh] : 0.0f, ok,
                  a, p, ds);
          if (!second) dsum[hh] = fmaf(p, dp[n][c], dsum[hh]);
          s[n][c] = ds;
        }
      // dQ += dS K over the sub-tile's keys
      if (second) product_acc<HD, kN, kD>(s, Kt + j0 * kLd, c0, lane, dq);
    }
    if (t == plan.n - 1) {
      // D of the thread's rows: the quad's 4 threads hold a row's keys
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 1);
        dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 2);
        const int r = rg * 16 + g + 8 * hh;
        if (tig == 0 && c0 == 0 && r < q_rows) a.delta[row0 + r] = dsum[hh];
      }
    }
  }
  cp_async_wait_all();

  bf16* dq_out = static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rg * 16 + g + 8 * hh;
    if (r >= q_rows) continue;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const int col = c0 + d * 8 + 2 * tig;
      if (col < a.hd)
        *reinterpret_cast<__nv_bfloat162*>(dq_out + (q0 + r) * a.sdq.s +
                                           col) =
            __floats2bfloat162_rn(dq[d][2 * hh], dq[d][2 * hh + 1]);
    }
  }
}

// dK and dV: one block per (batch, KV head, key tile), key tile 0 (under
// causality the one most query tiles see) first. It walks the query tiles
// whose plan holds its key tile (key_walk) and, for each, the H / KV query
// heads of its group in order: a fixed order, no atomics.
template <int HD>
__global__ void __launch_bounds__(KvShape<HD>::kThreads, Tune<HD>::kMinBlocks)
flash_bwd_dkdv_tc(Args a) {
  using Tn = Tune<HD>;
  using Sh = KvShape<HD>;
  constexpr int kBQ = Tn::kBQ, kBK = Tn::kBK;
  constexpr int kLd = HD + 8;
  constexpr int kN = kBQ / 8 / Tn::kSub;   // n8 tiles of an S^T sub-tile
  constexpr int kD = HD / Tn::kColKV / 8;  // n8 tiles of the warp's dK, dV
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);  // [kBK][kLd]
  bf16* Vs = Ks + Sh::kFixed;                   // [kBK][kLd]
  bf16* Qs = Vs + Sh::kFixed;                   // [2][kBQ][kLd]
  bf16* Gs = Qs + 2 * Sh::kTile;                // [2][kBQ][kLd] dO
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * Sh::kTile);  // [2][kBQ]
  float* del_s = lse_s + 2 * kBQ;                               // [2][kBQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int rg = warp / Tn::kColKV;                        // its 16 keys
  const int c0 = (warp % Tn::kColKV) * (HD / Tn::kColKV);  // its columns
  const int b = blockIdx.x / a.KV;
  const int kvh = blockIdx.x % a.KV;
  const int k0 = blockIdx.y * kBK;
  const int rep = a.H / a.KV;
  const int S = a.S;
  const Walk walk = key_walk(k0, kBQ, kBK, S, a.causal != 0, a.window);
  const int n_steps = walk.n * rep;  // step t: query tile t / rep, head t % rep

  const bf16* qbase = static_cast<const bf16*>(a.q) + b * a.sq.b;
  const bf16* gbase = static_cast<const bf16*>(a.dout) + b * a.sdo.b;
  const int64_t rows_b = static_cast<int64_t>(b) * a.H * S;
  auto prefetch = [&](int t) {
    const int q0 = (walk.first + t / rep) * kBQ;
    const int h = kvh * rep + t % rep;
    const int rows = imin(kBQ, S - q0);
    const int buf = t & 1;
    load_rows<HD, kBQ, Sh::kThreads>(Qs + buf * Sh::kTile,
                                     qbase + h * a.sq.h + q0 * a.sq.s,
                                     a.sq.s, rows, a.hd);
    load_rows<HD, kBQ, Sh::kThreads>(Gs + buf * Sh::kTile,
                                     gbase + h * a.sdo.h + q0 * a.sdo.s,
                                     a.sdo.s, rows, a.hd);
    for (int u = threadIdx.x; u < 2 * kBQ; u += Sh::kThreads) {
      const int r = u % kBQ;
      const bool ok = r < rows;
      const int64_t at = rows_b + static_cast<int64_t>(h) * S + q0 +
                         (ok ? r : 0);
      if (u < kBQ)
        cp_async4(lse_s + buf * kBQ + r, a.lse + at, ok);
      else
        cp_async4(del_s + buf * kBQ + r, a.delta + at, ok);
    }
  };
  const int k_rows = imin(kBK, S - k0);
  load_rows<HD, kBK, Sh::kThreads>(
      Ks, static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h +
              k0 * a.sk.s,
      a.sk.s, k_rows, a.hd);
  load_rows<HD, kBK, Sh::kThreads>(
      Vs, static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h +
              k0 * a.sv.s,
      a.sv.s, k_rows, a.hd);
  if (n_steps > 0) prefetch(0);
  cp_async_commit();

  float dk[kD][4], dv[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[d][c] = dv[d][c] = 0.0f;
  AFrags<HD, false> ka, va;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t == 0) {
      ka.init(Ks, rg * 16, lane);
      va.init(Vs, rg * 16, lane);
    }
    if (t + 1 < n_steps) prefetch(t + 1);
    cp_async_commit();

    const int buf = t & 1;
    const int q0 = (walk.first + t / rep) * kBQ;
    const bf16* Qt = Qs + buf * Sh::kTile;
    const bf16* Gt = Gs + buf * Sh::kTile;
    const float* lse_t = lse_s + buf * kBQ;
    const float* del_t = del_s + buf * kBQ;
    const bool full = tile_full(q0, kBQ, k0, kBK, a);
#pragma unroll
    for (int sub = 0; sub < Tn::kSub; ++sub) {
      const int i0 = sub * kN * 8;  // the sub-tile's first query
      // S^T = K Q^T, dP^T = V dO^T; s[n][c] is key rg * 16 + g + 8 * (c >>
      // 1), query i0 + n * 8 + 2 * tig + (c & 1) of the tiles: a thread's
      // rows are keys and its columns queries, so LSE and D go by the column
      float s[kN][4], dp[kN][4];
      two_products<HD, kN>(ka, va, Qt + i0 * kLd, Gt + i0 * kLd, lane, s,
                           dp);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int col = i0 + n * 8 + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 d2 = *reinterpret_cast<const float2*>(del_t + col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = full || admits(q0 + col + (c & 1),
                                         k0 + rg * 16 + g + 8 * (c >> 1), a);
          float p, ds;
          pair_tc(s[n][c], dp[n][c], ((c & 1) ? l2.y : l2.x) * kLog2e,
                  (c & 1) ? d2.y : d2.x, ok, a, p, ds);
          s[n][c] = p;
          dp[n][c] = ds;
        }
      }
      // dV += P^T dO, dK += dS^T Q over the sub-tile's queries
      product_acc<HD, kN, kD>(s, Gt + i0 * kLd, c0, lane, dv);
      product_acc<HD, kN, kD>(dp, Qt + i0 * kLd, c0, lane, dk);
    }
  }
  cp_async_wait_all();

  bf16* dk_out = static_cast<bf16*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h;
  bf16* dv_out = static_cast<bf16*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = k0 + rg * 16 + g + 8 * hh;
    if (j >= S) continue;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const int col = c0 + d * 8 + 2 * tig;
      if (col < a.hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk_out + j * a.sdk.s + col) =
            __floats2bfloat162_rn(dk[d][2 * hh], dk[d][2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + j * a.sdv.s + col) =
            __floats2bfloat162_rn(dv[d][2 * hh], dv[d][2 * hh + 1]);
      }
    }
  }
}

template <int HD>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  constexpr int q_bytes = QShape<HD>::kSmem;
  constexpr int kv_bytes = KvShape<HD>::kSmem;
  const int n_qt = (a.S + Tune<HD>::kBQ - 1) / Tune<HD>::kBQ;
  const int n_kt = (a.S + Tune<HD>::kBK - 1) / Tune<HD>::kBK;
  if (n_qt > 65535 || n_kt > 65535) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<flash_bwd_dq_tc<HD>>(q_bytes, device);
  if (err == cudaSuccess)
    err = allow_smem<flash_bwd_dkdv_tc<HD>>(kv_bytes, device);
  if (err != cudaSuccess) return err;
  // the dQ kernel writes D, which the dK/dV kernel reads (one stream)
  flash_bwd_dq_tc<HD><<<dim3(a.B * a.H, n_qt), QShape<HD>::kThreads,
                        q_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc<HD><<<dim3(a.B * a.KV, n_kt), KvShape<HD>::kThreads,
                          kv_bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_hd(const Args& a, int device, cudaStream_t stream) {
  if (a.hd <= 64) return launch<64>(a, device, stream);
  if (a.hd <= 128) return launch<128>(a, device, stream);
  return launch<256>(a, device, stream);
}

}  // namespace tc

}  // namespace

// dq, dk, dv of attention(q, k, v) in the index form, on `device`, launched
// on `stream`. dtype 0: float32, 1: bfloat16 (every tensor but lse and delta
// in it). strides: 21 element strides, (batch, head, seq) of q, k, v, dout,
// dq, dk, dv in that order, the head dimension contiguous. lse: the forward's
// (B, H, S) float32 log-sum-exp; delta: (B, H, S) float32 scratch (gets D).
// window <= 0: none; softcap <= 0: none. Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int64_t B, int64_t H, int64_t KV, int64_t S,
                                   int64_t hd, const int64_t* strides,
                                   float scale, int causal, int64_t window,
                                   float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 ||
      B * H > 65535 || S > 0x7fffffff || window > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Strides* st[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i)
    *st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = static_cast<int>(B);
  a.H = static_cast<int>(H);
  a.KV = static_cast<int>(KV);
  a.S = static_cast<int>(S);
  a.hd = static_cast<int>(hd);
  a.scale = scale;
  a.causal = causal;
  a.window = window > 0 ? static_cast<int>(window) : 0;
  a.softcap = softcap;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_fma(a, device, s);
      break;
    case 1:
      err = hd % 8 != 0 ? cudaErrorInvalidValue : tc::launch_hd(a, device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tiles of the kernels that take `dtype` (0: float32, 1: bfloat16) at
// head width `hd`, written to out[2]: {query tile, key tile}. Returns 0, or
// cudaErrorInvalidValue for a width or type the kernels do not take.
extern "C" int flash_bwd_tiles(int dtype, int hd, int* out) {
  if (hd <= 0 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    out[0] = out[1] = fma_tile(hd);
    return 0;
  }
  if (dtype != 1 || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64) {
    out[0] = tc::Tune<64>::kBQ;
    out[1] = tc::Tune<64>::kBK;
  } else if (hd <= 128) {
    out[0] = tc::Tune<128>::kBQ;
    out[1] = tc::Tune<128>::kBK;
  } else {
    out[0] = tc::Tune<256>::kBQ;
    out[1] = tc::Tune<256>::kBK;
  }
  return 0;
}

// The key tiles (first keys) the dQ kernels visit for query rows
// [q0, min(q0 + bq, S)) with key tiles of bk, at most `cap`, written to
// `starts`; returns the count. The forward's rule in the index form, on the
// host.
extern "C" int flash_bwd_tile_plan(int q0, int bq, int bk, int S, int causal,
                                   int window, int* starts, int cap) {
  const Plan plan = make_plan(q0, bq, bk, S, causal != 0, window);
  for (int t = 0; t < plan.n && t < cap; ++t)
    starts[t] = (plan.first + t) * bk;
  return plan.n;
}

// The query tiles (first rows) the dK/dV kernels visit for the key tile at
// k0 (key_walk), at most `cap`, written to `starts`; returns the count.
extern "C" int flash_bwd_key_plan(int k0, int bq, int bk, int S, int causal,
                                  int window, int* starts, int cap) {
  const Walk walk = key_walk(k0, bq, bk, S, causal != 0, window);
  for (int t = 0; t < walk.n && t < cap; ++t)
    starts[t] = (walk.first + t) * bq;
  return walk.n;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
