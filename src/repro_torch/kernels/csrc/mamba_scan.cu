// Selective scan, the Mamba-1 recurrence h_t = da_t * h_{t-1} + dbx_t over
// the sequence, in float32, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mamba_scan.py::mamba_scan_pallas. The TPU
// kernel cuts the sequence into time blocks, runs a log-depth doubling scan
// inside each block in VMEM and carries h across the blocks of a sequential
// grid axis. Nothing carries between Hopper blocks, and the ladder's extra
// passes only pay where a block of time steps sits in fast memory. Here every
// (batch, state, channel) recurrence is independent, so each thread owns VEC
// consecutive channels of one (b, n) row, keeps their h in registers and
// walks the sequence in order: no shared memory, no synchronisation, and the
// sum is taken in sequence order (one fma per step).
//
// Layout: da, dbx and h are (B, S, N, di), di last, as the Pallas kernel has
// them. Neighbouring threads own neighbouring channels, so each time step's
// loads and stores are coalesced rows of the (N, di) plane; with di % 4 == 0
// and 16-byte aligned pointers a thread takes 4 channels in one vector load.
// The loads of U time steps are issued before the dependent fma chain uses
// them, so each thread keeps 2 x U loads in flight.
//
// Bound: bytes. Each element is read twice (da, dbx) and written once (h,
// float32) for one fma: 12 B an element in float32, 8 B with bf16 inputs. At
// the falcon-mamba-7b prefill shape (4, 2048, 16, 8192) that is 12.9 GB, at
// least 3.85 ms at 3.35 TB/s.
//
// Padding: a right-padded step has da = 1 and dbx = 0, so h carries through
// and h[:, S-1] is the state after each sequence's last real token. Any S,
// N and di; no block-size padding.
//
// Backward (mamba_scan_bwd): the same thread layout walks the sequence in
// reverse with the carried gradient in registers. For the output gradient
// g = dL/dh: gh_t = g_t + da_{t+1} * gh_{t+1}, dL/ddbx_t = gh_t and
// dL/dda_t = gh_t * h_{t-1} (h_{-1} = 0), from da, the forward's h and g.
// jax.grad takes this gradient of the JAX package's training scan
// (src/repro/models/ssm.py:94, selective_scan_chunked); the Pallas kernel
// has no backward. Bound: bytes, 20 B an element (da, h, g read, both
// gradients written, float32): 1.60 ms at (1, 2048, 16, 8192) at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct Load;

template <>
struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&o)[1]) {
    o[0] = *p;
  }
};

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&o)[1]) {
    o[0] = __bfloat162float(*p);
  }
};

template <>
struct Load<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&o)[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = lo.x;
    o[1] = lo.y;
    o[2] = hi.x;
    o[3] = hi.y;
  }
};

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// One thread per VEC channels of one (b, n) row; U time steps per round.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ da, const T* __restrict__ dbx,
                  float* __restrict__ h, int64_t batch, int64_t seq,
                  int64_t n_state, int64_t d_inner) {
  constexpr int U = 16 / VEC;
  const int64_t groups = d_inner / VEC;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= batch * n_state * groups) return;
  const int64_t bn = g / groups;             // b * N + n
  const int64_t d0 = (g - bn * groups) * VEC;
  const int64_t b = bn / n_state;
  const int64_t n = bn - b * n_state;
  const int64_t step = n_state * d_inner;    // elements per time step
  int64_t off = b * seq * step + n * d_inner + d0;

  float state[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) state[i] = 0.0f;

  for (int64_t t0 = 0; t0 < seq; t0 += U, off += U * step) {
    float a[U][VEC];
    float x[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < seq) {
        Load<T, VEC>::run(da + off + u * step, a[u]);
        Load<T, VEC>::run(dbx + off + u * step, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < seq) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          state[i] = fmaf(a[u][i], state[i], x[u][i]);
        }
        store<VEC>(h + off + u * step, state);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* da, const void* dbx, float* h, int64_t batch,
                   int64_t seq, int64_t n_state, int64_t d_inner,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p, int64_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec4 = d_inner % 4 == 0 && aligned(da, 4 * sizeof(T)) &&
                    aligned(dbx, 4 * sizeof(T)) && aligned(h, 16);
  const int vec = vec4 ? 4 : 1;
  const int64_t threads = batch * n_state * (d_inner / vec);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const auto* a = static_cast<const T*>(da);
  const auto* x = static_cast<const T*>(dbx);
  if (vec4) {
    mamba_scan_kernel<T, 4><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(a, x, h, batch, seq, n_state,
                                        d_inner);
  } else {
    mamba_scan_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(a, x, h, batch, seq, n_state,
                                        d_inner);
  }
  return cudaGetLastError();
}

// One thread per VEC channels of one (b, n) row, from t = S - 1 down; U
// time steps' loads go out before their dependent chain.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const T* __restrict__ da, const float* __restrict__ h,
                      const float* __restrict__ g, float* __restrict__ gda,
                      float* __restrict__ gdbx, int64_t batch, int64_t seq,
                      int64_t n_state, int64_t d_inner) {
  constexpr int U = 16 / VEC;
  const int64_t groups = d_inner / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= batch * n_state * groups) return;
  const int64_t bn = idx / groups;
  const int64_t d0 = (idx - bn * groups) * VEC;
  const int64_t b = bn / n_state;
  const int64_t n = bn - b * n_state;
  const int64_t step = n_state * d_inner;
  const int64_t base = b * seq * step + n * d_inner + d0;

  float carry[VEC];  // da_{t+1} * gh_{t+1}
#pragma unroll
  for (int i = 0; i < VEC; ++i) carry[i] = 0.0f;

  for (int64_t t1 = seq - 1; t1 >= 0; t1 -= U) {
    float a[U][VEC], gg[U][VEC], hp[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t1 - u;
      if (t >= 0) {
        const int64_t off = base + t * step;
        Load<T, VEC>::run(da + off, a[u]);
        Load<float, VEC>::run(g + off, gg[u]);
        if (t > 0) {
          Load<float, VEC>::run(h + off - step, hp[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) hp[u][i] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t t = t1 - u;
      if (t >= 0) {
        float gh[VEC], ga[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          gh[i] = gg[u][i] + carry[i];
          ga[i] = gh[i] * hp[u][i];
          carry[i] = a[u][i] * gh[i];
        }
        const int64_t off = base + t * step;
        store<VEC>(gdbx + off, gh);
        store<VEC>(gda + off, ga);
      }
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* da, const float* h, const float* g,
                       float* gda, float* gdbx, int64_t batch, int64_t seq,
                       int64_t n_state, int64_t d_inner, cudaStream_t stream) {
  const auto aligned = [](const void* p, int64_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec4 = d_inner % 4 == 0 && aligned(da, 4 * sizeof(T)) &&
                    aligned(h, 16) && aligned(g, 16) && aligned(gda, 16) &&
                    aligned(gdbx, 16);
  const int vec = vec4 ? 4 : 1;
  const int64_t threads = batch * n_state * (d_inner / vec);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const auto* a = static_cast<const T*>(da);
  if (vec4) {
    mamba_scan_bwd_kernel<T, 4><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(a, h, g, gda, gdbx, batch, seq,
                                            n_state, d_inner);
  } else {
    mamba_scan_bwd_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(a, h, g, gda, gdbx, batch, seq,
                                            n_state, d_inner);
  }
  return cudaGetLastError();
}

}  // namespace

// h[b, t] = da[b, t] * h[b, t-1] + dbx[b, t] for row-major (B, S, N, di)
// da and dbx of one type (dtype 0: float32, 1: bfloat16), h float32 of the
// same shape, from h = 0, on `device`, launched on `stream`. Returns a
// cudaError_t (0 = ok).
extern "C" int mamba_scan_fwd(int dtype, const void* da, const void* dbx,
                              float* h, int64_t batch, int64_t seq,
                              int64_t n_state, int64_t d_inner, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || seq <= 0 || n_state <= 0 || d_inner <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(da, dbx, h, batch, seq, n_state, d_inner, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(da, dbx, h, batch, seq, n_state, d_inner,
                                  s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The gradients of mamba_scan_fwd: from da (dtype 0: float32, 1:
// bfloat16), the forward's h and the output gradient g (both float32, all
// row-major (B, S, N, di)), writes gda = dL/dda and gdbx = dL/ddbx in
// float32, on `device`, launched on `stream`. Returns a cudaError_t.
extern "C" int mamba_scan_bwd(int dtype, const void* da, const float* h,
                              const float* g, float* gda, float* gdbx,
                              int64_t batch, int64_t seq, int64_t n_state,
                              int64_t d_inner, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || seq <= 0 || n_state <= 0 || d_inner <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_bwd<float>(da, h, g, gda, gdbx, batch, seq, n_state,
                              d_inner, s);
      break;
    case 1:
      err = launch_bwd<__nv_bfloat16>(da, h, g, gda, gdbx, batch, seq,
                                      n_state, d_inner, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
