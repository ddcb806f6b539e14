// Flash attention backward on Hopper (sm_90a): dQ, dK and dV of the index
// form of flash_attention.cu's forward (causal, optional sliding window,
// optional tanh soft-cap c * tanh(x / c)), for float32 and bfloat16 inputs,
// float32 accumulation, gradients in the input type.
//
// Replaces: the gradient that jax.grad takes of the JAX package's training
// attention (src/repro/models/attention.py:97, chunked_attention); the TPU
// kernel src/repro/kernels/flash_attention.py:93 (flash_attention_pallas)
// has no backward. A FlashAttention-2 split in two launches:
//
//   flash_bwd_dq     one block per (batch, head, query tile), walking the
//                    KV tiles of the forward's tile plan (make_plan) twice:
//                    first for D[i] = sum_j P[i, j] dP[i, j], which it also
//                    writes out, then for dQ.
//   flash_bwd_dkdv   one block per (batch, KV head, key tile). It keeps its
//                    K and V tile in shared memory and dK, dV in registers,
//                    and walks every query tile that sees the key tile, for
//                    each of the H / KV query heads of its group in turn. So
//                    the GQA sum over query heads needs no atomics and has a
//                    fixed order: the result does not depend on timing.
//
// Both recompute P = exp(logit - LSE) from q, k and the forward's per-row
// log-sum-exp (flash_attention.cu writes it when asked), under the forward's
// mask: a masked logit gives P = 0 exactly, as the reference's
// where(mask, logits, -2^30) does. With dP = dO V^T, dS = P (dP - D) times
// (1 - tanh^2) under a soft-cap, times the scale; then dV = P^T dO,
// dK = dS^T Q, dQ = dS K. D is the softmax backward's sum_j P dP, taken in
// float32 as autograd takes it from the reference, not rowsum(dO * O) of the
// forward's output: that output is rounded to bf16, and where dP - D cancels
// (a query that sees few keys) its rounding puts whole rows of dQ off (0.19
// relative on the worst row at the training shape). The extra pass costs two
// of the nine products a pair. Query tile t visits key tile u in the dQ kernel iff
// u is in make_plan(t); the dK/dV kernel walks exactly the query tiles whose
// plan holds its key tile, so both skip the tiles the forward skips.
//
// Design: float32 FMAs from shared memory for both types (bf16 is widened as
// it is loaded). A 16 x 16 thread grid owns a TILE x TILE block of logits,
// each thread TILE / 16 rows by TILE / 16 columns, interleaved by 16;
// tiles are row-major with an odd pitch (HD + 1 floats), so the 16 threads
// that read 16 different rows at one column hit 16 different banks. TILE is
// 64 keys and 64 queries for head widths up to 128 and 32 for 256 (shared
// memory: 100 KB, 166 KB and 140 KB a block).
//
// Bound: at granite-moe-1b-a400m's training shape (B 4, H 16, KV 8, S 2048,
// hd 64, bf16, causal) the backward does 5 products of 2 * hd flops per
// visible (query, key) pair (S, dP, dV, dK, dQ), ~86 GFLOP: 0.087 ms at the
// 989 TFLOP/s bf16 tensor-core rate, so operations bound it. This design
// recomputes S and dP in both kernels and twice in the dQ kernel (9 products
// a pair) on the float32 FMA units (67 TFLOP/s); moving it onto the tensor
// cores (mma.sync or wgmma, as the forward) is the redesign it waits for.

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
  float* delta;      // (B, H, S) contiguous: D, written by flash_bwd_dq
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename T>
cudaError_t launch_hd(const Args& a, int device, cudaStream_t stream) {
  if (a.hd <= 64) return launch<T, 64, 64>(a, device, stream);
  if (a.hd <= 128) return launch<T, 128, 64>(a, device, stream);
  return launch<T, 256, 32>(a, device, stream);
}

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
      err = launch_hd<float>(a, device, s);
      break;
    case 1:
      err = launch_hd<__nv_bfloat16>(a, device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The KV tiles (first keys) the dQ kernel visits for query rows
// [q0, min(q0 + tile, S)), at most `cap`, written to `starts`; returns the
// count. The forward's rule in the index form, on the host.
extern "C" int flash_bwd_tile_plan(int q0, int tile, int S, int causal,
                                   int window, int* starts, int cap) {
  const Plan plan = make_plan(q0, tile, tile, S, causal != 0, window);
  for (int t = 0; t < plan.n && t < cap; ++t) starts[t] = (plan.first + t) * tile;
  return plan.n;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
