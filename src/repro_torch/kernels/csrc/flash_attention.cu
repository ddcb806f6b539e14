// Flash attention forward on Hopper (sm_90a): causal GQA online-softmax
// attention with an optional sliding window and tanh logit soft-cap, float32
// accumulation, output in the input type (float32 or bfloat16).
//
// q (B, H, S, hd), k and v (B, KV, S, hd), o (B, H, S, hd), each given by its
// own element strides over (batch, head, sequence) with the head dimension
// contiguous, so the model's (B, S, H, hd) projections go in without a copy.
// Query head h reads KV head h / (H / KV). The mask, with masked logits set
// to -2^30 as in the JAX package:
//   index form (no positions):  key j is seen by query i iff (causal) i >= j
//                               and (window) i - j < window;
//   position form (q_pos (B, S), kv_pos (B, S) int32): iff kv_pos[j] >= 0 and
//                               (causal) q_pos[i] >= kv_pos[j] and (window)
//                               q_pos[i] - kv_pos[j] < window.
// The position form is the model's prefill over right-padded prompts
// (src/repro/models/attention.py::attn_prefill: kv_pos = -1 on padding,
// q_pos = max(pos, 0)); it needs q_pos[i] <= i and kv_pos[j] in {j, -1},
// which keeps the causal tile skip below valid. Without that skip the
// window's left edge is not skipped in the position form (a padded query at
// position 0 may see key 0 from any tile).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas.
// The TPU kernel walks a sequential (q block, kv block) grid with the running
// max, sum and accumulator in VMEM scratch and skips fully masked kv blocks
// with pl.when. Here a block owns one (batch, head, 64-query tile) and walks
// the KV tiles itself, from the window's left edge to the causal frontier,
// keeping the running max and sum of its rows in registers.
//
// Bound: at the serving path's shapes (S up to 2048, hd 64, bf16) the causal
// products are 4 * B * H * S^2 * hd / 2 operations against ~2 bytes per
// element of q, k, v and o, so the card's tensor-core rate bounds it. This
// first kernel does not use the tensor cores: the products are float32 FMAs
// from shared memory (each thread owns a 4 x 4 block of the 64 x 64 logit
// tile and 4 rows x hd/16 columns of the output, read as float4), so it runs
// far from that bound. wgmma with TMA-fed tiles is later work.
//
// Design: Q (transposed), K (transposed) and V tiles live in shared memory in
// float32; logits, the softmax rescale and P are float32; the 16 threads that
// share a row reduce its max and sum with shuffles. Every reduction has a
// fixed order, so the result does not depend on timing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kLd = kBK + 4;   // padded row of the transposed tiles and P
constexpr float kNeg = -1073741824.0f;  // -2^30
constexpr int kOutside = -2147483647 - 1;  // a key beyond the sequence

template <typename T>
struct Pack;  // one 16-byte load of T, widened to float

template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ static void widen(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  __device__ static void store4(float* dst, const float* x) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void widen(const uint4& raw, float* out) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);          // element 2i (low)
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store4(__nv_bfloat16* dst, const float* x) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
};

// Rows [0, rows_valid) x columns [0, hd) of a row-major tile (row stride
// `row_stride` elements) into shared memory as float32, zero elsewhere in
// the 64 x HD tile: transposed (dst[d * kLd + r]) or not (dst[r * (HD + 4) +
// d]). Consecutive threads read consecutive 16-byte pieces of a row.
template <typename T, int HD, bool kTransposed>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t row_stride, int rows_valid,
                                          int hd, float* __restrict__ dst) {
  constexpr int V = Pack<T>::n;
  constexpr int kPerRow = HD / V;
  for (int u = threadIdx.x; u < kBK * kPerRow; u += kThreads) {
    const int r = u / kPerRow;
    const int d0 = (u % kPerRow) * V;
    float vals[V];
    if (r < rows_valid && d0 < hd) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(r) * row_stride + d0));
      Pack<T>::widen(raw, vals);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
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

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int HD>
constexpr int smem_bytes() {
  return (2 * HD * kLd + kBK * (HD + 4) + kBQ * kLd) * 4 + kBK * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          const int32_t* __restrict__ q_pos,
          const int32_t* __restrict__ kv_pos, int H, int KV, int S, int hd,
          Strides st, float scale, int causal, int window, float softcap) {
  extern __shared__ float4 smem_f4[];
  float* Qt = reinterpret_cast<float*>(smem_f4);  // [HD][kLd]
  float* Kt = Qt + HD * kLd;                       // [HD][kLd]
  float* Vs = Kt + HD * kLd;                       // [kBK][HD + 4]
  float* Ps = Vs + kBK * (HD + 4);                 // [kBQ][kLd]
  int* kvp = reinterpret_cast<int*>(Ps + kBQ * kLd);  // [kBK]
  constexpr int kCols = HD / 16;  // output columns per thread

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int q_rows = min(kBQ, S - q0);

  load_tile<T, HD, true>(q + b * st.qb + h * st.qh + q0 * st.qs, st.qs,
                         q_rows, hd, Qt);
  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;

  int qp[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    qp[i] = q_pos == nullptr ? r : (r < S ? q_pos[b * S + r] : 0);
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // KV tiles from the window's left edge to the causal frontier
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  int k_begin = 0;
  if (window > 0 && q_pos == nullptr)
    k_begin = (max(0, q0 - window + 1) / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    const int k_rows = min(kBK, S - k0);
    load_tile<T, HD, true>(kbase + k0 * st.ks, st.ks, k_rows, hd, Kt);
    load_tile<T, HD, false>(vbase + k0 * st.vs, st.vs, k_rows, hd, Vs);
    if (tid < kBK) {
      const int j = k0 + tid;
      kvp[tid] = j >= S ? kOutside : (kv_pos == nullptr ? j
                                                         : kv_pos[b * S + j]);
    }
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
        const int kp = kvp[tx * 4 + c];
        float x = s[i][c] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kp >= 0;
        if (causal) ok = ok && qp[i] >= kp;
        if (window > 0) ok = ok && (qp[i] - kp) < window;
        // a key beyond the sequence weighs exactly 0, a masked one -2^30
        s[i][c] = ok ? x : (kp == kOutside ? __int_as_float(0xff800000) : kNeg);
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
    T* orow = o + b * st.ob + h * st.oh + (q0 + r) * st.os;
#pragma unroll
    for (int jj = 0; jj < HD / 64; ++jj) {
      const int d = jj * 64 + tx * 4;
      if (d < hd) {
        const float x[4] = {acc[i][jj * 4] * inv, acc[i][jj * 4 + 1] * inv,
                            acc[i][jj * 4 + 2] * inv,
                            acc[i][jj * 4 + 3] * inv};
        Pack<T>::store4(orow + d, x);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int32_t* q_pos, const int32_t* kv_pos, int B, int H,
                   int KV, int S, int hd, const Strides& st, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  auto kernel = flash_fwd<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), q_pos, kv_pos, H, KV, S,
      hd, st, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      const int32_t* q_pos, const int32_t* kv_pos, int B,
                      int H, int KV, int S, int hd, const Strides& st,
                      float scale, int causal, int window, float softcap,
                      cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, q_pos, kv_pos, B, H, KV, S, hd, st,
                         scale, causal, window, softcap, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, q_pos, kv_pos, B, H, KV, S, hd, st,
                          scale, causal, window, softcap, stream);
  return launch<T, 256>(q, k, v, o, q_pos, kv_pos, B, H, KV, S, hd, st, scale,
                        causal, window, softcap, stream);
}

}  // namespace

// o = attention(q, k, v) on `device`, launched on `stream`. dtype: 0 =
// float32, 1 = bfloat16 (all four tensors). strides: 12 element strides,
// (batch, head, seq) of q, k, v, o in that order; the head dimension is
// contiguous and every row starts on 16 bytes. q_pos / kv_pos: (B, S) int32,
// both null for the index form. window <= 0: none; softcap <= 0: none.
// Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o,
                                   const int32_t* q_pos,
                                   const int32_t* kv_pos, int64_t B,
                                   int64_t H, int64_t KV, int64_t S,
                                   int64_t hd, const int64_t* strides,
                                   float scale, int causal, int64_t window,
                                   float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > 256 ||
      hd % 8 != 0 || B * H > 65535 || S > 0x7fffffff ||
      window > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = window > 0 ? static_cast<int>(window) : 0;
  err = dtype == 0
            ? launch_hd<float>(q, k, v, o, q_pos, kv_pos, B, H, KV, S, hd,
                               st, scale, causal, w, softcap, s)
            : launch_hd<__nv_bfloat16>(q, k, v, o, q_pos, kv_pos, B, H, KV,
                                       S, hd, st, scale, causal, w, softcap,
                                       s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
