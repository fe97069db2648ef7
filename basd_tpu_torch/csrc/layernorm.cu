// LayerNorm over the last axis in one pass, for the calls that autograd does
// not need (the frozen teacher's 2 depth + 1 LayerNorms, an eval forward):
// y = (x - mean) * rsqrt(var + eps) * w + b for rows (rows, D) of bf16 or
// fp32 x, fp32 weight and bias, y in x's dtype, the statistics and the
// affine map in fp32 and the result rounded once (__float2bfloat16_rn).
//
// It replaces no TPU kernel: the JAX package's LayerNorm is flax's
// nn.LayerNorm, which XLA fuses. The port's composite (x widened to fp32,
// torch's fp32 LayerNorm, the result narrowed back) moves 20 bytes a bf16
// value in three kernels; this one reads x once and writes y once, 4 bytes
// a bf16 value, so it is bound by memory bandwidth. Each row is held in
// registers as it was loaded (16-byte vectors): the mean is its fp32 sum
// over D, then the centred sum of squares comes from the same registers
// (two-pass arithmetic, one read of memory). The sums run in another order
// than torch's Welford kernel, so y is within a unit in the last place of
// the composite's, not its bits.
//
// Routes (`route_of`, which `basd_layernorm_route` reports), where D is a
// whole number of 16-byte vectors and x, y,
// w and b are 16-byte aligned: "warp", one warp a row, up to kMaxWarpVecs
// vectors a lane (D <= 1,536 in bf16), kWarpRows rows a block; "cta", one
// block of 2 to kMaxCtaWarps warps a row, kCtaVecs vectors a lane (D 4,096
// in bf16 takes 4 warps), the warps' sums met in shared memory. Route
// "scalar" (any D or alignment; ConvNeXt's odd widths): one block a row,
// one value a thread a step, reading the row from memory three times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRows = kThreads / 32;
constexpr int kMaxWarpVecs = 6;
constexpr int kCtaVecs = 4;
constexpr int kMaxCtaWarps = 8;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum of v, the same in every thread (warps' sums added in
// warp order); `part` holds one float a warp and is used once
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) s += part[i];
  return s;
}

// the kPer values of one 16-byte vector, widened to fp32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int k = 0; k < 16 / static_cast<int>(sizeof(T)); ++k) f[k] = to_float(e[k]);
}

// y's vector j of a row from x's vector v: (x - mean) * rstd * w + b
template <typename T>
__device__ __forceinline__ uint4 normalize(const uint4& v, const float4* __restrict__ w,
                                           const float4* __restrict__ b, int j, float mean,
                                           float rstd) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kQuads = kPer / 4;
  float f[kPer], wf[kPer], bf[kPer];
  unpack<T>(v, f);
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 wq = w[j * kQuads + q], bq = b[j * kQuads + q];
    wf[4 * q] = wq.x, wf[4 * q + 1] = wq.y, wf[4 * q + 2] = wq.z, wf[4 * q + 3] = wq.w;
    bf[4 * q] = bq.x, bf[4 * q + 1] = bq.y, bf[4 * q + 2] = bq.z, bf[4 * q + 3] = bq.w;
  }
  uint4 out;
  T* e = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int k = 0; k < kPer; ++k) e[k] = from_float<T>(fmaf((f[k] - mean) * rstd, wf[k], bf[k]));
  return out;
}

// the fp32 sum of the values of the loaded vectors (v[i] is vector
// first + i * step of the row, loaded where it is below vecs)
template <typename T, int kVecs>
__device__ __forceinline__ float row_sum(const uint4 (&v)[kVecs], int first, int step,
                                         int vecs) {
  constexpr int kPer = 16 / sizeof(T);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (first + i * step < vecs) {
      float f[kPer];
      unpack<T>(v[i], f);
#pragma unroll
      for (int k = 0; k < kPer; ++k) s += f[k];
    }
  }
  return s;
}

template <typename T, int kVecs>
__device__ __forceinline__ float centred_squares(const uint4 (&v)[kVecs], int first, int step,
                                                 int vecs, float mean) {
  constexpr int kPer = 16 / sizeof(T);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (first + i * step < vecs) {
      float f[kPer];
      unpack<T>(v[i], f);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float d = f[k] - mean;
        s = fmaf(d, d, s);
      }
    }
  }
  return s;
}

// route "warp": warp r of the block takes row blockIdx.x * kWarpRows + r,
// lane l its vectors l, l + 32, ...
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
basd_layernorm_warp_kernel(const uint4* __restrict__ x, const float4* __restrict__ w,
                           const float4* __restrict__ b, uint4* __restrict__ y,
                           long long rows, int vecs, float d, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const uint4* xr = x + row * vecs;
  uint4 v[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (lane + 32 * i < vecs) v[i] = xr[lane + 32 * i];
  }
  const float mean = warp_sum(row_sum<T, kVecs>(v, lane, 32, vecs)) / d;
  const float var = warp_sum(centred_squares<T, kVecs>(v, lane, 32, vecs, mean)) / d;
  const float rstd = rsqrtf(var + eps);
  uint4* yr = y + row * vecs;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    if (j < vecs) yr[j] = normalize<T>(v[i], w, b, j, mean, rstd);
  }
}

// route "cta": block blockIdx.x takes its row, thread t its vectors t,
// t + blockDim.x, ...
template <typename T, int kVecs>
__global__ void __launch_bounds__(kMaxCtaWarps * 32)
basd_layernorm_cta_kernel(const uint4* __restrict__ x, const float4* __restrict__ w,
                          const float4* __restrict__ b, uint4* __restrict__ y, int vecs,
                          float d, float eps) {
  __shared__ float part[2][kMaxCtaWarps];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, step = blockDim.x;
  const uint4* xr = x + row * vecs;
  uint4 v[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (t + step * i < vecs) v[i] = xr[t + step * i];
  }
  const float mean = block_sum(row_sum<T, kVecs>(v, t, step, vecs), part[0]) / d;
  const float var = block_sum(centred_squares<T, kVecs>(v, t, step, vecs, mean), part[1]) / d;
  const float rstd = rsqrtf(var + eps);
  uint4* yr = y + row * vecs;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = t + step * i;
    if (j < vecs) yr[j] = normalize<T>(v[i], w, b, j, mean, rstd);
  }
}

// route "scalar": block blockIdx.x takes its row of D values, one value a
// thread a step, three passes over the row
template <typename T>
__global__ void __launch_bounds__(kThreads)
basd_layernorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ b, T* __restrict__ y, int D, float eps) {
  __shared__ float part[2][kThreads / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * D;
  float s = 0.0f;
  for (int j = threadIdx.x; j < D; j += kThreads) s += to_float(xr[j]);
  const float mean = block_sum(s, part[0]) / static_cast<float>(D);
  float sq = 0.0f;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    const float c = to_float(xr[j]) - mean;
    sq = fmaf(c, c, sq);
  }
  const float rstd = rsqrtf(block_sum(sq, part[1]) / static_cast<float>(D) + eps);
  T* yr = y + static_cast<long long>(blockIdx.x) * D;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    yr[j] = from_float<T>(fmaf((to_float(xr[j]) - mean) * rstd, w[j], b[j]));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int kVecs>
void warp_route(const void* x, const float* w, const float* b, void* y, long long rows,
                int vecs, float d, float eps, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((rows + kWarpRows - 1) / kWarpRows);
  basd_layernorm_warp_kernel<T, kVecs><<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(x), reinterpret_cast<const float4*>(w),
      reinterpret_cast<const float4*>(b), static_cast<uint4*>(y), rows, vecs, d, eps);
}

enum Route { kWarpRoute = 0, kCtaRoute = 1, kScalarRoute = 2 };

// the route a call takes: warp or cta where D is a whole number of 16-byte
// vectors and every pointer is 16-byte aligned, by the row's vectors
template <typename T>
Route route_of(const void* x, const float* w, const float* b, const void* y, int D) {
  constexpr int kPer = 16 / sizeof(T);
  const int vecs = D / kPer;
  if (D % kPer || !aligned16(x) || !aligned16(y) || !aligned16(w) || !aligned16(b) ||
      vecs > 32 * kCtaVecs * kMaxCtaWarps)
    return kScalarRoute;
  return vecs <= 32 * kMaxWarpVecs ? kWarpRoute : kCtaRoute;
}

template <typename T>
int launch(const void* x, const float* w, const float* b, void* y, long long rows, int D,
           float eps, cudaStream_t s) {
  const int vecs = D / (16 / static_cast<int>(sizeof(T)));
  const float d = static_cast<float>(D);
  switch (route_of<T>(x, w, b, y, D)) {
    case kWarpRoute:
      switch ((vecs + 31) / 32) {
        case 1: warp_route<T, 1>(x, w, b, y, rows, vecs, d, eps, s); break;
        case 2: warp_route<T, 2>(x, w, b, y, rows, vecs, d, eps, s); break;
        case 3: warp_route<T, 3>(x, w, b, y, rows, vecs, d, eps, s); break;
        case 4: warp_route<T, 4>(x, w, b, y, rows, vecs, d, eps, s); break;
        case 5: warp_route<T, 5>(x, w, b, y, rows, vecs, d, eps, s); break;
        default: warp_route<T, 6>(x, w, b, y, rows, vecs, d, eps, s); break;
      }
      break;
    case kCtaRoute: {
      const int warps = (vecs + 32 * kCtaVecs - 1) / (32 * kCtaVecs);
      basd_layernorm_cta_kernel<T, kCtaVecs><<<static_cast<unsigned>(rows), 32 * warps, 0, s>>>(
          static_cast<const uint4*>(x), reinterpret_cast<const float4*>(w),
          reinterpret_cast<const float4*>(b), static_cast<uint4*>(y), vecs, d, eps);
      break;
    }
    default:
      basd_layernorm_scalar_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
          static_cast<const T*>(x), w, b, static_cast<T*>(y), D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and y (rows, D) contiguous, of one dtype (is_bf16 picks bf16, else
// fp32); w and b (D,) fp32. Returns the launch's cudaGetLastError.
int basd_layernorm_fwd(const void* x, const float* w, const float* b, void* y,
                       long long rows, int D, float eps, int is_bf16, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, b, y, rows, D, eps, s)
                 : launch<float>(x, w, b, y, rows, D, eps, s);
}

// the route `basd_layernorm_fwd` takes on these operands: 0 warp, 1 cta,
// 2 scalar
int basd_layernorm_route(const void* x, const float* w, const float* b, const void* y, int D,
                         int is_bf16) {
  return is_bf16 ? route_of<__nv_bfloat16>(x, w, b, y, D) : route_of<float>(x, w, b, y, D);
}
}  // extern "C"
