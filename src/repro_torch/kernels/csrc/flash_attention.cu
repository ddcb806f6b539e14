// Flash attention forward on Hopper (sm_90a): causal GQA online-softmax
// attention with an optional sliding window and tanh logit soft-cap, float32
// accumulation, output in the input type. Two kernels:
//
//   flash_fwd_tc   bfloat16 inputs, on the tensor cores (mma.sync m16n8k16
//                  bf16 -> f32); the serving path's kernel.
//   flash_fwd_fma  float32 inputs, float32 FMAs from shared memory (TF32
//                  products would keep ~3 digits, too few for float32
//                  callers).
//
// Replaces: src/repro/kernels/flash_attention.py:93, flash_attention_pallas.
// The TPU kernel walks a sequential (q block, kv block) grid with the running
// max, sum and accumulator in VMEM scratch and skips fully masked kv blocks
// with pl.when. Here a block owns one (batch, head, 64-query tile) and walks
// its KV tiles itself, keeping the running max and sum of its rows in
// registers. Every reduction has a fixed order and nothing is atomic, so the
// result does not depend on timing.
//
// q (B, H, S, hd), k and v (B, KV, S, hd), o (B, H, S, hd), each given by its
// own element strides over (batch, head, sequence) with the head dimension
// contiguous, so the model's (B, S, H, hd) projections go in without a copy.
// Query head h reads KV head h / (H / KV). Key j is seen by query i iff
//   (causal) q_pos[i] >= kv_pos[j], (window) q_pos[i] - kv_pos[j] < window,
//   and kv_pos[j] >= 0,
// with masked logits at -2^30 as in the JAX package (a key beyond S weighs
// exactly 0). Index form: q_pos[i] = i, kv_pos[j] = j. Length form, the
// model's prefill over right-padded prompts
// (src/repro/models/attention.py::attn_prefill): the kernels take the
// prompts' real lengths L_b (1 <= L_b <= S; clamped to it, so that no
// length reads outside the tensors) and mask as that function's positions
// do: kv_pos[b, j] = j for j < L_b and -1 beyond, q_pos = max(kv_pos, 0).
//
// Tile plan (both kernels; `tile_plan` in ../flash_attention.py states the
// same rule in Python, and `flash_tile_plan` at the end of this file runs
// this file's rule on the host, so that the two can be compared). A block
// owns query rows [q0, q1), q1 = min(q0 + 64, S); L = L_b (S in the index
// form). Real rows [q0, min(q1, L)) need keys
// from the window's left edge (q0 - window + 1) to the causal frontier
// (min(q1, L)), or to L without causality; padded rows [max(q0, L), q1) see
// key 0 only (all keys below L without causality). The block visits the KV
// tiles of 64 keys that hold those keys: tile 0 first when it has padded
// rows, then the real rows' tiles; tiles at or past L are never visited, and
// every visited tile holds a key that some row of the block sees.
//
// Bound: at the serving path's prefill (B 8, H 16, KV 8, S 2048, hd 64,
// bf16, right-padded prompts of 256-2048 tokens) the products take 4 * hd
// flops per head and visible (query, key) pair, ~33 GFLOP, against ~50 MB of
// q, k, v and o: 0.034 ms at the 989 TFLOP/s bf16 tensor-core rate, 0.015
// ms at 3.35 TB/s. So the tensor cores bound the bf16 kernel, and the
// exponentials come next (one per pair: 16 a clock per SM, ~as long as the
// products at hd 64). The float32 kernel is bound by its FMAs (67 TFLOP/s).
//
// flash_fwd_tc (FlashAttention-2's warp layout): 4 warps of 16 query rows.
// Q is copied once with cp.async and, for HD = 64, kept in registers as the
// mma's A fragments (ldmatrix); wider heads re-read them from shared memory
// each tile, to leave the registers to the f32 accumulator (HD / 2 a
// thread). K and V tiles of 64 keys stay in bf16 in a double-buffered
// cp.async ring (tile t + 1 is in flight while tile t is computed); rows are
// padded by 16 bytes, so the 8 rows that one ldmatrix reads fall in 8
// different bank groups. S = Q K^T takes K by ldmatrix as the B ("col")
// operand; the logits are capped and, on tiles that touch an edge (the
// diagonal, the window's edge, padding, S), masked; the online softmax runs
// in base 2 in registers (one FFMA and one ex2 per logit; the 4 threads of
// a quad share a row). P goes from the S accumulators straight into bf16 A
// fragments (two n8 accumulators make one k16 fragment), V is read by
// ldmatrix.trans, O stays in f32 registers, and the epilogue divides by the
// row sum. The grid ranks the query tiles of all heads by their work, so the
// longest blocks start first; a causal tile wholly in the padding copies V's
// row 0, the one key its rows see.
//
// flash_fwd_fma: Q (transposed), K (transposed) and V tiles in shared memory
// as float32; each of 256 threads owns a 4 x 4 block of the 64 x 64 logit
// tile and 4 rows x hd/16 output columns; the 16 threads that share a row
// reduce its max and sum with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1073741824.0f;  // -2^30

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// The KV tiles a block visits, in order: tiles [0, n_pad), then tiles
// [first, first + n - n_pad). See the header.
struct TilePlan {
  int n_pad, first, n;
  __host__ __device__ int start(int t, int bk) const {
    return (t < n_pad ? t : first + t - n_pad) * bk;
  }
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ __forceinline__ TilePlan make_plan(int q0, int bq,
                                                       int bk, int S, int L,
                                                       bool causal,
                                                       int window) {
  const int q1 = imin(q0 + bq, S);
  const int real_end = imin(q1, L);
  int n_pad = 0, first = 0, last = 0;
  if (imax(q0, L) < q1) n_pad = ((causal ? 1 : L) + bk - 1) / bk;
  if (q0 < real_end) {
    first = (window > 0 ? imax(0, q0 - window + 1) : 0) / bk;
    last = ((causal ? real_end : L) + bk - 1) / bk;
  }
  first = imax(first, n_pad);
  return {n_pad, first, n_pad + imax(0, last - first)};
}

// L_b of the length form (S in the index form), clamped to [1, S].
__device__ __forceinline__ int seq_length(const int32_t* lengths, int b,
                                          int S) {
  return lengths == nullptr ? S : min(max(lengths[b], 1), S);
}

// Lets `kKernel` take `bytes` of dynamic shared memory, as much of the SM's
// memory as shared memory as it can. Once per kernel and device: the call
// costs more host time than a short launch.
template <auto kKernel>
cudaError_t allow_smem(int bytes, int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kKernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kLd = kBK + 4;   // padded row of the transposed tiles and P

// Rows [0, rows_valid) x columns [0, hd) of a row-major tile (row stride
// `row_stride` elements) into shared memory, zero elsewhere in the 64 x HD
// tile: transposed (dst[d * kLd + r]) or not (dst[r * (HD + 4) + d]).
// Consecutive threads read consecutive 16-byte pieces of a row.
template <int HD, bool kTransposed>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t row_stride, int rows_valid,
                                          int hd, float* __restrict__ dst) {
  constexpr int kPerRow = HD / 4;
  for (int u = threadIdx.x; u < kBK * kPerRow; u += kThreads) {
    const int r = u / kPerRow;
    const int d0 = (u % kPerRow) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows_valid && d0 < hd)
      x = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r) * row_stride + d0));
    const float vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kTransposed) {
        dst[(d0 + i) * kLd + r] = vals[i];
      } else {
        dst[r * (HD + 4) + d0 + i] = vals[i];
      }
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr int smem_bytes() {
  return (2 * HD * kLd + kBK * (HD + 4) + kBQ * kLd) * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              const int32_t* __restrict__ lengths, float* __restrict__ lse,
              int H, int KV, int S,
              int hd, Strides st, float scale, int causal, int window,
              float softcap) {
  extern __shared__ float4 smem_f4[];
  float* Qt = reinterpret_cast<float*>(smem_f4);  // [HD][kLd]
  float* Kt = Qt + HD * kLd;                       // [HD][kLd]
  float* Vs = Kt + HD * kLd;                       // [kBK][HD + 4]
  float* Ps = Vs + kBK * (HD + 4);                 // [kBQ][kLd]
  constexpr int kCols = HD / 16;  // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int q_rows = min(kBQ, S - q0);
  const int L = seq_length(lengths, b, S);
  const TilePlan plan = make_plan(q0, kBQ, kBK, S, L, causal != 0, window);

  load_tile<HD, true>(q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, q_rows,
                      hd, Qt);
  const float* kbase = k + b * st.kb + kvh * st.kh;
  const float* vbase = v + b * st.vb + kvh * st.vh;

  int qp[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    qp[i] = r < L ? r : 0;
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < plan.n; ++t) {
    const int k0 = plan.start(t, kBK);
    __syncthreads();  // the previous tile's readers are done
    const int k_rows = min(kBK, S - k0);
    load_tile<HD, true>(kbase + k0 * st.ks, st.ks, k_rows, hd, Kt);
    load_tile<HD, false>(vbase + k0 * st.vs, st.vs, k_rows, hd, Vs);
    __syncthreads();

    // logits of rows ty*4+i, columns tx*4+c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLd + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&Kt[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx * 4 + c;  // kv_pos = j below L, -1 beyond
        float x = s[i][c] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = j < L;
        if (causal) ok = ok && qp[i] >= j;
        if (window > 0) ok = ok && (qp[i] - j) < window;
        // a key beyond the sequence weighs exactly 0, a masked one -2^30
        s[i][c] = ok ? x : (j >= S ? __int_as_float(0xff800000) : kNeg);
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * kLd + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P V over this tile's keys; columns jj*64 + tx*4 + (0..3)
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * kLd + c]);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < HD / 64; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(c + cc) * (HD + 4) + jj * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj * 4 + 0] = fmaf(p[i][cc], vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(p[i][cc], vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(p[i][cc], vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(p[i][cc], vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + q0 + r] = m[i] + logf(l[i]);
    float* orow = o + b * st.ob + h * st.oh + (q0 + r) * st.os;
#pragma unroll
    for (int jj = 0; jj < HD / 64; ++jj) {
      const int d = jj * 64 + tx * 4;
      if (d < hd)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][jj * 4] * inv, acc[i][jj * 4 + 1] * inv,
                        acc[i][jj * 4 + 2] * inv, acc[i][jj * 4 + 3] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int32_t* lengths, float* lse, int B, int H, int KV,
                   int S,
                   int hd, const Strides& st, float scale, int causal,
                   int window, float softcap, int device,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  auto kernel = flash_fwd_fma<HD>;
  cudaError_t err = allow_smem<flash_fwd_fma<HD>>(bytes, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lengths, lse, H,
      KV, S, hd, st, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async double buffering
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per block: 4 warps x 16
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK, "load_rows copies 64-row tiles of Q, K and V");

// By head width: whether Q's A fragments stay in registers, and the blocks
// an SM should hold (the register cap that follows). The f32 accumulator
// takes HD / 2 registers a thread and the logit tile 32; for HD = 64 a cap
// of 128 registers (4 blocks, 16 warps an SM) spills a few bytes and ran
// faster at the serve shape than 3 blocks without the cap.
template <int HD>
struct Tune;
template <>
struct Tune<64> {
  static constexpr bool kQInRegs = true;
  static constexpr int kMinBlocks = 4;
};
template <>
struct Tune<128> {
  static constexpr bool kQInRegs = false;
  static constexpr int kMinBlocks = 1;
};
template <>
struct Tune<256> {
  static constexpr bool kQInRegs = false;
  static constexpr int kMinBlocks = 1;
};

template <int HD>
struct Shape {
  // a shared-memory row in bf16, padded by 16 bytes (ldmatrix without bank
  // conflicts; cp.async's 16-byte stores stay aligned)
  static constexpr int kLd = HD + 8;
  static constexpr int kTile = kBK * kLd;
  // Q, K[2], V[2] in bf16
  static constexpr int kSmem = 5 * kTile * 2;
};

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

// 2^x on the special-function unit (one instruction; 0 for x = -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Rows [0, rows_valid) x columns [0, hd) of a row-major (row stride
// `row_stride`) bf16 tile into a 64 x HD shared tile with row pitch kLd,
// zero elsewhere, by cp.async: consecutive threads copy consecutive 16-byte
// pieces of a row.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t row_stride, int rows_valid,
                                          int hd) {
  constexpr int kChunks = HD / 8;
  constexpr int kRowStep = kThreads / kChunks;
  const int r = threadIdx.x / kChunks;
  const int c = (threadIdx.x % kChunks) * 8;
  const bf16* from = src + r * row_stride + c;
  bf16* to = dst + r * Shape<HD>::kLd + c;
#pragma unroll
  for (int i = 0; i < kBK / kRowStep; ++i) {
    const bool ok = c < hd && r + i * kRowStep < rows_valid;
    cp_async16(to, ok ? from : src, ok);
    from += kRowStep * row_stride;
    to += kRowStep * Shape<HD>::kLd;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Tune<HD>::kMinBlocks)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             const int32_t* __restrict__ lengths, float* __restrict__ lse,
             int H, int KV, int S,
             int hd,
             Strides st, float scale, int causal, int window,
             float softcap) {
  using Sh = Shape<HD>;
  constexpr int kLd = Sh::kLd;
  constexpr int kN = kBK / 8;   // n8 tiles of a logit row block
  constexpr int kD = HD / 8;    // n8 tiles of an output row block
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);       // [kBQ][kLd]
  bf16* Ks = Qs + kBQ * kLd;                          // [2][kBK][kLd]
  bf16* Vs = Ks + 2 * Sh::kTile;                      // [2][kBK][kLd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row within the warp's 8-row halves
  const int tig = lane & 3;  // thread in the quad that shares a row
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int L = seq_length(lengths, b, S);
  // blockIdx.y ranks the query tiles of every head by their work: the
  // tiles that hold real rows from the last (the most KV tiles) down, then
  // the padded ones, so the longest blocks start first
  const int n_real = (min(L, S) + kBQ - 1) / kBQ;
  const int rank = blockIdx.y;
  const int q0 = (rank < n_real ? n_real - 1 - rank : rank) * kBQ;
  const int q_rows = min(kBQ, S - q0);
  const TilePlan plan = make_plan(q0, kBQ, kBK, S, L, causal != 0, window);
  // a tile needs no mask when every key is real and seen by every row
  const int q1 = min(q0 + kBQ, S);
  const int real_last = min(q1, L) - 1;
  const bool has_pad = max(q0, L) < q1;

  const bf16* kbase = k + b * st.kb + kvh * st.kh;
  const bf16* vbase = v + b * st.vb + kvh * st.vh;
  if (causal && q0 >= L) {
    // every row is padding and sees key 0 alone, with weight exactly 1:
    // its output is V's row 0
    constexpr int kChunks = HD / 8;
    bf16* obase = o + b * st.ob + h * st.oh;
    for (int u = tid; u < q_rows * kChunks; u += kThreads) {
      const int r = u / kChunks;
      const int c = (u % kChunks) * 8;
      if (c < hd)
        *reinterpret_cast<uint4*>(obase + (q0 + r) * st.os + c) =
            *reinterpret_cast<const uint4*>(vbase + c);
    }
    return;
  }
  auto issue = [&](int t) {
    const int k0 = plan.start(t, kBK);
    const int buf = t & 1;
    const int rows = min(kBK, S - k0);
    load_rows<HD>(Ks + buf * Sh::kTile, kbase + k0 * st.ks, st.ks, rows, hd);
    load_rows<HD>(Vs + buf * Sh::kTile, vbase + k0 * st.vs, st.vs, rows, hd);
  };

  load_rows<HD>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, q_rows,
                hd);
  if (plan.n > 0) issue(0);
  cp_async_commit();

  // Logits stay in units of q.k: logit = x * scale, and the softmax works
  // in base 2 with x * scale * log2(e) taken by one FFMA. Masked entries
  // get -2^30 (before the scale; their weight is exactly 0 beside any seen
  // key), keys beyond S -inf. With a soft-cap, x = cap / scale * tanh(x *
  // scale / cap).
  const float sl = scale * kLog2e;
  const float cap_in = softcap > 0.0f ? scale / softcap : 0.0f;
  const float cap_out = softcap > 0.0f ? softcap / scale : 0.0f;

  // warp w owns rows w * 16 + g and w * 16 + g + 8 (hh = 0, 1), with
  // positions q_pos = r (real) or 0 (padding)
  int qp[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + warp * 16 + g + 8 * hh;
    qp[hh] = r < L ? r : 0;
    m[hh] = kNeg;
    l[hh] = 0.0f;  // this thread's share of the row sum
  }
  float acc[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.0f;

  // A fragments of the warp's 16 rows: ldmatrix lane l gives the address of
  // row l % 16, columns (l / 16) * 8 of each 16-column slice
  const bf16* qfrag = Qs + (warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
  unsigned qf[Tune<HD>::kQInRegs ? HD / 16 : 1][4];

  for (int t = 0; t < plan.n; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if constexpr (Tune<HD>::kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldmatrix_x4(qf[kk], qfrag + kk * 16);
      }
    }
    if (t + 1 < plan.n) issue(t + 1);
    cp_async_commit();

    const int k0 = plan.start(t, kBK);
    const bf16* Kt = Ks + (t & 1) * Sh::kTile;
    const bf16* Vt = Vs + (t & 1) * Sh::kTile;

    // S = Q K^T: K rows are keys, so a non-transposed ldmatrix of an 8 x 8
    // (key, dim) block is the B fragment; x4 gives two n8 tiles' k16 halves
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
    const bf16* kfrag =
        Kt + (((lane >> 4) << 3) + (lane & 7)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[4];
      if constexpr (Tune<HD>::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, qfrag + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, kfrag + np * 16 * kLd + kk * 16);
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // cap and mask; s[n][c] is row g + 8 * (c >> 1), key n * 8 + 2 * tig +
    // (c & 1) of the tile
    const bool full = !has_pad && k0 + kBK <= L &&
                      (!causal || k0 + kBK - 1 <= q0) &&
                      (window <= 0 || real_last - k0 < window);
    if (softcap > 0.0f || !full) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[n][c];
          if (softcap > 0.0f) x = cap_out * tanhf(x * cap_in);
          if (!full) {
            const int j = k0 + n * 8 + 2 * tig + (c & 1);
            const int qpr = qp[c >> 1];
            bool ok = j < L;
            if (causal) ok = ok && qpr >= j;
            if (window > 0) ok = ok && (qpr - j) < window;
            x = ok ? x : (j >= S ? __int_as_float(0xff800000) : kNeg);
          }
          s[n][c] = x;
        }
    }

    // online softmax per row; the quad's 4 threads hold a row's 64 keys
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int n = 0; n < kN; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = ex2((m[hh] - mx) * sl);
      const float msl = mx * sl;
      m[hh] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[n][2 * hh + e], sl, -msl));
          s[n][2 * hh + e] = p;
          rs += p;
        }
      l[hh] = l[hh] * alpha + rs;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        acc[d][2 * hh] *= alpha;
        acc[d][2 * hh + 1] *= alpha;
      }
    }

    // O += P V: the accumulators of n8 tiles 2kk and 2kk + 1 are the A
    // fragment of key slice kk; V by ldmatrix.trans (lane l: key row l % 16,
    // dims (l / 16) * 8) gives the B fragments of two n8 dim tiles
    const bf16* vfrag = Vt + (lane & 15) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 2; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vfrag + kk * 16 * kLd + dp * 16);
        mma(acc[2 * dp], a, bv[0], bv[1]);
        mma(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    const int r = warp * 16 + g + 8 * hh;
    if (r >= q_rows) continue;
    // m is in units of q.k: the row's log-sum-exp is m * scale + log(sum)
    if (lse != nullptr && tig == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + q0 + r] =
          m[hh] * scale + logf(sum);
    bf16* orow = o + b * st.ob + h * st.oh + (q0 + r) * st.os;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const int col = d * 8 + 2 * tig;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[d][2 * hh] * inv, acc[d][2 * hh + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int32_t* lengths, float* lse, int B, int H, int KV,
                   int S,
                   int hd, const Strides& st, float scale, int causal,
                   int window, float softcap, int device,
                   cudaStream_t stream) {
  constexpr int bytes = Shape<HD>::kSmem;
  const int n_tiles = (S + kBQ - 1) / kBQ;
  if (n_tiles > 65535) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc<HD>;
  cudaError_t err = allow_smem<flash_fwd_tc<HD>>(bytes, device);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, n_tiles);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lengths, lse, H, KV,
      S, hd, st, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace tc

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*,
                                 void*, const int32_t*, float*, int, int, int,
                                 int,
                                 int, const Strides&, float, int, int, float,
                                 int, cudaStream_t);

// Checks the arguments, picks HD in {64, 128, 256} (hd zero-filled up to
// it) and launches.
int run(LaunchFn hd64, LaunchFn hd128, LaunchFn hd256, const void* q,
        const void* k, const void* v, void* o, const int32_t* lengths,
        float* lse, int64_t B, int64_t H, int64_t KV, int64_t S, int64_t hd,
        const int64_t* strides, float scale, int causal, int64_t window,
        float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 ||
      hd % 8 != 0 || B * H > 65535 || S > 0x7fffffff || window > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const LaunchFn fn = hd <= 64 ? hd64 : (hd <= 128 ? hd128 : hd256);
  err = fn(q, k, v, o, lengths, lse, static_cast<int>(B),
           static_cast<int>(H),
           static_cast<int>(KV), static_cast<int>(S), static_cast<int>(hd),
           st, scale, causal, window > 0 ? static_cast<int>(window) : 0,
           softcap, device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

// o = attention(q, k, v) on `device`, launched on `stream`; the _f32 entry
// takes float32 tensors, the _tc entry bfloat16. strides: 12 element
// strides, (batch, head, seq) of q, k, v, o in that order; the head
// dimension is contiguous and every row starts on 16 bytes. lengths: null
// for the index form, else (B,) int32 L_b on the device for the length
// form. lse: null, or (B, H, S) float32 contiguous on the device, which
// then gets each query row's natural log-sum-exp of its (capped, masked)
// logits, the backward kernels' input (flash_attention_bwd.cu). window <= 0:
// none; softcap <= 0: none. Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const int32_t* lengths, float* lse,
                                   int64_t B, int64_t H, int64_t KV,
                                   int64_t S,
                                   int64_t hd,
                                   const int64_t* strides, float scale,
                                   int causal, int64_t window, float softcap,
                                   int device, void* stream) {
  return run(f32::launch<64>, f32::launch<128>, f32::launch<256>, q, k, v, o,
             lengths, lse, B, H, KV, S, hd, strides, scale, causal, window,
             softcap, device, stream);
}

extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* o,
                                  const int32_t* lengths, float* lse,
                                  int64_t B, int64_t H, int64_t KV, int64_t S,
                                  int64_t hd,
                                  const int64_t* strides, float scale,
                                  int causal, int64_t window, float softcap,
                                  int device, void* stream) {
  return run(tc::launch<64>, tc::launch<128>, tc::launch<256>, q, k, v, o,
             lengths, lse, B, H, KV, S, hd, strides, scale, causal, window,
             softcap, device, stream);
}

// The tile plan that both kernels run (make_plan), on the host: writes the
// first keys of the KV tiles that query rows [q0, min(q0 + bq, S)) visit,
// at most `cap` of them, to `starts` and returns how many there are.
extern "C" int flash_tile_plan(int q0, int bq, int bk, int S, int L,
                               int causal, int window, int* starts,
                               int cap) {
  const TilePlan plan = make_plan(q0, bq, bk, S, L, causal != 0, window);
  for (int t = 0; t < plan.n && t < cap; ++t) starts[t] = plan.start(t, bk);
  return plan.n;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
