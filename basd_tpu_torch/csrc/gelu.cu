// The exact (erf) GELU and its gradient, each in one pass over a
// contiguous bf16 or fp32 tensor.
//
// Forward: y = x * 0.5 * (1 + erf(x / sqrt(2))). Backward: dx = dy * (cdf
// + x * pdf), cdf = 0.5 * (1 + erf(x / sqrt(2))), pdf = exp(-x^2 / 2) /
// sqrt(2 pi). Both are computed in fp32 from the operands as stored, in the
// operation order and with the constants of PyTorch's GeluCUDAKernelImpl and
// GeluBackwardCUDAKernelImpl, and rounded once to the tensor's dtype: the
// bits of F.gelu(x.float()).to(x.dtype) and of its autograd
// (`ops/activations.py:gelu_plain`, `gelu_backward_plain`).
// Route "vec": every thread moves kUnroll 16-byte vectors of each operand
// (8 bf16 or 4 fp32 values each), all loads issued before any math, where
// every pointer is 16-byte aligned; block 0 also takes the last n % 8 (or
// % 4) values one at a time. Route "scalar": one value a thread, for
// pointers that are not aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// M_SQRT1_2 and M_2_SQRTPI * M_SQRT1_2 * 0.5, rounded to fp32 as PyTorch's
// constexpr opmath_t constants are
constexpr float kAlpha = 0.70710678118654752440;
constexpr float kBeta = 1.12837916709551257390 * 0.70710678118654752440 * 0.5;

__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

__device__ __forceinline__ float gelu_grad(float dy, float x) {
  const float cdf = 0.5f * (1.0f + erff(x * kAlpha));
  const float pdf = expf(-0.5f * x * x) * kBeta;
  return dy * (cdf + x * pdf);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// `vecs` whole 16-byte vectors, then the `n - vecs * kPer` values left
template <typename T>
__global__ void __launch_bounds__(kThreads)
basd_gelu_fwd_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long vecs,
                         long long n) {
  constexpr int kPer = 16 / sizeof(T);
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < vecs) v[u] = __ldcs(x + i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < vecs) {
      T* e = reinterpret_cast<T*>(&v[u]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) e[k] = from_float<T>(gelu(to_float(e[k])));
      __stcs(y + i, v[u]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - vecs * kPer) {
    const long long i = vecs * kPer + threadIdx.x;
    reinterpret_cast<T*>(y)[i] = from_float<T>(gelu(to_float(reinterpret_cast<const T*>(x)[i])));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
basd_gelu_fwd_scalar_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) y[i] = from_float<T>(gelu(to_float(x[i])));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
basd_gelu_bwd_vec_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ x,
                         uint4* __restrict__ dx, long long vecs, long long n) {
  constexpr int kPer = 16 / sizeof(T);
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  uint4 g[kUnroll], v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < vecs) {
      g[u] = __ldcs(dy + i);
      v[u] = __ldcs(x + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < vecs) {
      T* ge = reinterpret_cast<T*>(&g[u]);
      const T* ve = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        ge[k] = from_float<T>(gelu_grad(to_float(ge[k]), to_float(ve[k])));
      }
      __stcs(dx + i, g[u]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - vecs * kPer) {
    const long long i = vecs * kPer + threadIdx.x;
    reinterpret_cast<T*>(dx)[i] = from_float<T>(gelu_grad(
        to_float(reinterpret_cast<const T*>(dy)[i]), to_float(reinterpret_cast<const T*>(x)[i])));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
basd_gelu_bwd_scalar_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                            T* __restrict__ dx, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) dx[i] = from_float<T>(gelu_grad(to_float(dy[i]), to_float(x[i])));
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned blocks(long long items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

template <typename T>
int launch_fwd(const void* x, void* y, long long n, cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  if (aligned(x) && aligned(y)) {
    const long long vecs = n / kPer;
    const unsigned grid = vecs > 0 ? blocks((vecs + kUnroll - 1) / kUnroll) : 1;
    basd_gelu_fwd_vec_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), vecs, n);
  } else {
    basd_gelu_fwd_scalar_kernel<T><<<blocks(n), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* dy, const void* x, void* dx, long long n, cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  if (aligned(dy) && aligned(x) && aligned(dx)) {
    const long long vecs = n / kPer;
    const unsigned grid = vecs > 0 ? blocks((vecs + kUnroll - 1) / kUnroll) : 1;
    basd_gelu_bwd_vec_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(dy), static_cast<const uint4*>(x), static_cast<uint4*>(dx),
        vecs, n);
  } else {
    basd_gelu_bwd_scalar_kernel<T><<<blocks(n), kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<T*>(dx), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// the scalar route's grid must fit one dimension
constexpr long long kMaxElements = 0x7fffffffLL * kThreads;

}  // namespace

extern "C" {

// x and y, n contiguous values; is_bf16 picks bf16, else fp32. Returns the
// launch's cudaGetLastError.
int basd_gelu_fwd(const void* x, void* y, long long n, int is_bf16, void* stream) {
  if (n <= 0) return 0;
  if (n > kMaxElements) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, y, n, s) : launch_fwd<float>(x, y, n, s);
}

// dy, x and dx, n contiguous values of one dtype
int basd_gelu_bwd(const void* dy, const void* x, void* dx, long long n, int is_bf16,
                  void* stream) {
  if (n <= 0) return 0;
  if (n > kMaxElements) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(dy, x, dx, n, s)
                 : launch_bwd<float>(dy, x, dx, n, s);
}
}  // extern "C"
