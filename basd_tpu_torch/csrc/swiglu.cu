// The SwiGLU gate of a packed fc1 output: out[r, c] = silu(x[r, c]) *
// x[r, g + c] for rows x of width 2g, in one pass over the tensor.
//
// silu(a) * b = a / (1 + exp(-a)) * b is computed in fp32 from the
// operands as stored (bf16 or fp32) and rounded once to the output dtype,
// as the plain version (`ops/activations.py:swiglu_gate_plain`) does.
// Route "vec": one CTA a row, each thread moving 16 bytes of a, 16 of b
// and 16 of the output a step (8 bf16 or 4 fp32 values), where g is a
// multiple of that width and both pointers are 16-byte aligned, so every
// row's halves are too. Route "scalar": the same loop one value at a time,
// for any other g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gate(float a, float b) {
  return a / (1.0f + expf(-a)) * b;
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

// one CTA a row; `vecs` 16-byte vectors a half-row
template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_gate_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int vecs) {
  constexpr int kPer = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const uint4* a = x + row * 2 * vecs;
  const uint4* b = a + vecs;
  uint4* o = out + row * vecs;
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    uint4 av = __ldcs(a + v);
    uint4 bv = __ldcs(b + v);
    const T* ae = reinterpret_cast<const T*>(&av);
    const T* be = reinterpret_cast<const T*>(&bv);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      oe[i] = from_float<T>(gate(to_float(ae[i]), to_float(be[i])));
    }
    __stcs(o + v, ov);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_gate_scalar_kernel(const T* __restrict__ x, T* __restrict__ out, int g) {
  const long long row = blockIdx.x;
  const T* a = x + row * 2 * g;
  const T* b = a + g;
  T* o = out + row * g;
  for (int c = threadIdx.x; c < g; c += kThreads) {
    o[c] = from_float<T>(gate(to_float(a[c]), to_float(b[c])));
  }
}

template <typename T>
int launch(const void* x, void* out, long long rows, int g, cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (g % kPer == 0 && aligned) {
    swiglu_gate_vec_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), g / kPer);
  } else {
    swiglu_gate_scalar_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (rows, 2g) and out (rows, g), contiguous; is_bf16 picks bf16, else
// fp32. Returns the launch's cudaGetLastError.
int basd_swiglu_gate(const void* x, void* out, long long rows, int g, int is_bf16,
                     void* stream) {
  if (rows <= 0 || g <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, out, rows, g, s) : launch<float>(x, out, rows, g, s);
}
}  // extern "C"
