// TrivialAugment geometric warp (K4) for Hopper (sm_90a): per sample an
// optional hflip, a lossless quarter-turn and the Paeth three-shear with
// translation, on square fp32 NHWC images.
//
// Replaces the Pallas TPU kernel `_warp_kernel` of
// basd_tpu/ops/warp_kernel.py:161 (launched by `_warp_call`) and computes
// the function of `geometric_warp_plain` in
// basd_tpu_torch/ops/warp_kernel.py. Per-sample parameter rows are
// [alpha, beta, gamma, tx, ty, k, flip, 0]. In order:
//   1. hflip when flip > 0.5;
//   2. quarter-turn by k, as `augment._quarter_turn`: k = 1 is
//      flip(swapaxes(x, 1, 2), axis=1), i.e. out(y, x) = in(x, n-1-y);
//   3. three 1-D bilinear passes with zero fill, out[s] = in[s + delta]:
//      along W with delta = alpha (y - cy) + tx for row y, along H with
//      delta = beta (x - cy) + ty for column x, along W with
//      delta = gamma (y - cy); cy = (n - 1) / 2.
//
// The TPU kernel flips with exchange-matrix matmuls (Mosaic has no
// reverse), transposes between passes (lane slicing is slow there) and
// sweeps up to 65 dense taps per pass (VMEM favours dense shifts). None of
// that is needed here. Within one pass a line's delta is one constant,
// since it depends only on the perpendicular coordinate, so each output
// pixel is two taps: w0 in[s + t0] + w1 in[s + t0 + 1], t0 = floor(delta),
// with the tent weights w = max(0, 1 - |delta - t|) of the plain version's
// sweep. Delta and the two-tap sum are rounded op by op (__fmul_rn,
// __fadd_rn, no FMA contraction), as the plain version's separate torch
// ops round them, so identity rows and quarter-turns are bit-exact and the
// dense sweep (n <= 41) agrees to the last bit.
//
// What bounds it here: bytes. The work is ~10 flops per pixel per pass, so
// the least time is one read and one write of the batch (2 B C n^2 4
// bytes) at 3.35 TB/s: 0.94 us at the Table-3 batch (128, 32, 32, 3). The
// design moves exactly those bytes: one CTA per (sample, channel) loads its
// n x n plane once into shared memory, applying flip and quarter-turn as
// an index map on the load, runs the three passes in place there and
// stores the plane once; no intermediate touches HBM. The plane's row
// stride is n + 1, so column passes hit distinct banks. Each pass gives
// one warp a line: the warp reads its sources into registers, syncs, and
// writes the line in place (lines of one pass are independent, so one
// buffer is enough); a block barrier separates the passes. At Table-3
// sizes the launch itself dominates; coalescing the strided NHWC channel
// reads is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 240;  // n x (n + 1) fp32 <= 227 KB of shared memory
constexpr int kPerLane = (kMaxN + 31) / 32;

__device__ __forceinline__ float tent(float delta, float t) {
  return fmaxf(0.f, 1.f - fabsf(delta - t));
}

// Resample one line in place: element s lives at line[s * step].
__device__ __forceinline__ void shift_line(float* line, int step, int n,
                                           float delta, int lane) {
  // clamp keeps the int conversion defined; a tap that far out has weight 0
  const float t0 = fminf(fmaxf(floorf(delta), -2.f * n), 2.f * n);
  const float w0 = tent(delta, t0), w1 = tent(delta, t0 + 1.f);
  const int it = (int)t0;
  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    v[j] = 0.f;
    if (s < n) {
      const int i0 = s + it, i1 = i0 + 1;
      const float a = (i0 >= 0 && i0 < n) ? line[i0 * step] : 0.f;
      const float b = (i1 >= 0 && i1 < n) ? line[i1 * step] : 0.f;
      v[j] = __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    if (s < n) line[s * step] = v[j];
  }
  __syncwarp();
}

__device__ __forceinline__ float line_delta(float shear, int i, float cy,
                                            float shift) {
  return __fadd_rn(__fmul_rn(shear, (float)i - cy), shift);
}

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ params, int n, int channels) {
  extern __shared__ float plane[];  // n rows of stride n + 1
  const int b = blockIdx.x / channels, c = blockIdx.x - b * channels;
  const float* p = params + 8 * (long long)b;
  const float alpha = p[0], beta = p[1], gamma = p[2], tx = p[3], ty = p[4];
  const int kq = ((int)p[5]) & 3;
  const bool flip = p[6] > 0.5f;
  const int ld = n + 1;
  const long long img = (long long)b * n * n * channels;

  // load with hflip, then quarter-turn, as an index map
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int y = idx / n, xx = idx - y * n;
    int sy, sx;
    switch (kq) {
      case 0: sy = y; sx = xx; break;
      case 1: sy = xx; sx = n - 1 - y; break;
      case 2: sy = n - 1 - y; sx = n - 1 - xx; break;
      default: sy = n - 1 - xx; sx = y; break;
    }
    if (flip) sx = n - 1 - sx;
    plane[y * ld + xx] = x[img + ((long long)sy * n + sx) * channels + c];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float cy = 0.5f * (float)(n - 1);
  for (int y = warp; y < n; y += kWarps)  // pass 1: along W
    shift_line(plane + y * ld, 1, n, line_delta(alpha, y, cy, tx), lane);
  __syncthreads();
  for (int col = warp; col < n; col += kWarps)  // pass 2: along H
    shift_line(plane + col, ld, n, line_delta(beta, col, cy, ty), lane);
  __syncthreads();
  for (int y = warp; y < n; y += kWarps)  // pass 3: along W
    shift_line(plane + y * ld, 1, n, line_delta(gamma, y, cy, 0.f), lane);
  __syncthreads();

  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int y = idx / n, xx = idx - y * n;
    out[img + (long long)idx * channels + c] = plane[y * ld + xx];
  }
}

}  // namespace

extern "C" int basd_warp(const void* x, void* out, const void* params,
                         int batch, int n, int channels, void* stream) {
  if (batch <= 0 || channels <= 0 || n <= 0 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)n * (n + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  warp_kernel<<<batch * channels, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const float*)params, n, channels);
  return (int)cudaGetLastError();
}
