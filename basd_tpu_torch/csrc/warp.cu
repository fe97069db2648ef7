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
// ops round them, so every route returns the plain version's bits.
//
// What bounds it here: bytes. The work is ~10 flops per pixel per pass, so
// the least time is one read and one write of the batch (2 B C n^2 4
// bytes) at 3.35 TB/s: 0.94 us at the Table-3 batch (128, 32, 32, 3),
// 92 us at the reference's default (256, 224, 224, 3). Each plane is
// loaded once into shared memory, flip and quarter-turn applied as an
// index map on the load, the three passes run in place there (each warp
// resamples whole lines: it reads a line's sources into registers, syncs
// and writes the line back; a block barrier separates the passes) and the
// plane is stored once; no intermediate touches device memory.
//
// The first design (the kPlane route below, one CTA of 256 threads per
// (sample, channel)) read and wrote 4 bytes at a 12-byte stride across the
// NHWC channels, so a warp's request spanned three times the bytes it
// used, and the three channel CTAs of a sample fetched the same lines; at
// 224 px a 224 x 225 plane took 201,600 B of shared memory, one CTA of 8
// warps per SM, so the load, the passes and the store ran one after
// another with little to hide their latency; and it divided by a run-time
// n in the load and store loops. 0.0116 ms at (128, 32, 32, 3) by the
// event loop of wrapper calls (PERF.md §6). The routes, chosen by (n, C)
// in basd_tpu_torch/ops/warp_kernel.py:warp_route, each its own entry
// point:
//   * kCta (`basd_warp_cta`, when a sample's C planes fit one CTA: C = 3
//     to n = 139): one CTA of 1,024 threads per sample. It reads the
//     sample, n^2 C contiguous floats, with 16-byte loads, coalesced, and
//     writes each value into its channel's plane (the channels
//     de-interleaved in shared memory); the passes run over all C n lines
//     of a direction at once; the store gathers the planes back into
//     16-byte stores;
//   * kCluster (`basd_warp_cluster`, 2 <= C <= 8 above that, such as
//     (256, 224, 224, 3)): a thread-block cluster of C CTAs per sample,
//     CTA c owning channel c's plane. Each CTA loads a contiguous 1/C of
//     the sample with 16-byte loads and writes each value into its
//     channel owner's shared memory over distributed shared memory
//     (`map_shared_rank`), once a cluster barrier at the kernel's start
//     has shown every CTA of the cluster running (the programming model
//     allows remote stores only then; it cost nothing measurable on an
//     H100, 0.3714 against 0.3713 ms at (256, 224, 224, 3), PERF.md §6),
//     then the cluster syncs; each runs the three
//     passes on its own plane with 32 warps; each stores its 1/C of the
//     sample the same way, reading the owners' planes;
//   * kPlane (`basd_warp_plane`, C > 8 above one CTA's shared memory, which
//     no caller of the port has): the first design, unchanged.
// The index map of the load is affine in the input pixel (o0 + iy dy +
// ix dx, per sample), and element indices are split into pixel, channel,
// row and column by multiply-high division by the run-time C and n
// (FastDiv), so no loop divides by a run-time value. kCta's planes have an
// odd row stride (n + 1 for even n, n for odd n) so that the column passes
// and the quarter-turned loads hit 32 banks; kCta is instantiated per
// elements per lane of a line (ceil(n / 32)), so that a line's unrolled
// loop issues no empty slots at small n.
//
// Measured on an H100 (PERF.md §6, basd_tpu_torch/tools/time_warp.py,
// device time per launch, against the first design): (128, 32, 32, 3)
// 0.0071 against 0.0101 ms, (256, 224, 224, 3) 0.377 against 0.659 ms,
// both on chip_smoke.py's mix of every op. Alternatives that lost: the
// cluster route with 4-byte DSMEM scatter and gather, 0.576 ms at
// (256, 224, 224, 3) unturned (0.372 with 16-byte moves); kCta with 256 or
// 512 threads, 0.0149 and 0.0111 ms at (128, 32, 32, 3) against 0.0105
// with 1,024 (before the per-lane instantiations); kCluster with 512
// threads, 0.401 against 0.374 ms. What bounds it now at 224 px: one
// 201,600-byte plane per SM, so a CTA's load, passes and store still run
// one after another (0.37 ms against the 0.092 ms bound), and
// quarter-turned samples (k = 1, 3), whose rows land in plane columns,
// scatter 4-byte DSMEM stores (0.52 ms when every sample is turned).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 240;  // one n x (n + 1) fp32 plane <= 227 KB
constexpr int kPerLane = (kMaxN + 31) / 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, sm_90
constexpr int kThreads = 1024;           // the kCta and kCluster routes
constexpr int kPlaneThreads = 256;       // the kPlane route
constexpr int kMaxCluster = 8;           // the portable cluster size

__host__ __device__ inline int plane_ld(int n) { return n % 2 ? n : n + 1; }

// x / d for 0 <= x < 2^31 without a division: q = umulhi(x, mul) >> shift,
// mul = ceil(2^p / d), p = 31 + ceil(log2 d) (CUTLASS's FastDivmod)
struct FastDiv {
  unsigned d, mul, shift;
};

FastDiv make_fastdiv(unsigned d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    unsigned lg = 0;
    while ((1u << lg) < d) ++lg;
    const unsigned p = 31 + lg;
    f.mul = (unsigned)(((1ull << p) + d - 1) / d);
    f.shift = p - 32;
  }
  return f;
}

__device__ __forceinline__ unsigned fdiv(unsigned x, const FastDiv& f) {
  return f.d == 1 ? x : __umulhi(x, f.mul) >> f.shift;
}

__device__ __forceinline__ float tent(float delta, float t) {
  return fmaxf(0.f, 1.f - fabsf(delta - t));
}

// Resample one line in place: element s lives at line[s * step]; kPer >=
// ceil(n / 32) elements per lane.
template <int kPer = kPerLane>
__device__ __forceinline__ void shift_line(float* line, int step, int n,
                                           float delta, int lane) {
  // clamp keeps the int conversion defined; a tap that far out has weight 0
  const float t0 = fminf(fmaxf(floorf(delta), -2.f * n), 2.f * n);
  const float w0 = tent(delta, t0), w1 = tent(delta, t0 + 1.f);
  const int it = (int)t0;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
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
  for (int j = 0; j < kPer; ++j) {
    const int s = lane + 32 * j;
    if (s < n) line[s * step] = v[j];
  }
  __syncwarp();
}

__device__ __forceinline__ float line_delta(float shear, int i, float cy,
                                            float shift) {
  return __fadd_rn(__fmul_rn(shear, (float)i - cy), shift);
}

// The three passes over `planes` planes of one sample (rows ld apart, ld *
// n floats apart), a warp per line, kPer >= ceil(n / 32) elements per
// lane; ends with a block barrier.
template <int kPer>
__device__ void run_passes(float* planes, int nplanes, int n, int ld,
                           const float* __restrict__ p, const FastDiv& fd_n) {
  const float alpha = p[0], beta = p[1], gamma = p[2], tx = p[3], ty = p[4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32, lines = nplanes * n, psz = n * ld;
  const float cy = 0.5f * (float)(n - 1);
  for (int l = warp; l < lines; l += warps) {  // pass 1: along W
    const int q = fdiv(l, fd_n), y = l - q * n;
    shift_line<kPer>(planes + q * psz + y * ld, 1, n, line_delta(alpha, y, cy, tx), lane);
  }
  __syncthreads();
  for (int l = warp; l < lines; l += warps) {  // pass 2: along H
    const int q = fdiv(l, fd_n), col = l - q * n;
    shift_line<kPer>(planes + q * psz + col, ld, n, line_delta(beta, col, cy, ty), lane);
  }
  __syncthreads();
  for (int l = warp; l < lines; l += warps) {  // pass 3: along W
    const int q = fdiv(l, fd_n), y = l - q * n;
    shift_line<kPer>(planes + q * psz + y * ld, 1, n, line_delta(gamma, y, cy, 0.f), lane);
  }
  __syncthreads();
}

// Where input pixel (iy, ix) of a sample lands in its plane: o0 + iy dy +
// ix dx, the inverse of hflip then the quarter-turn by k
struct LoadMap {
  int o0, dy, dx;
};

__device__ __forceinline__ LoadMap load_map(const float* __restrict__ p, int n, int ld) {
  const int k = ((int)p[5]) & 3;
  // the column before the flip: fx0 + fdx * ix
  const bool flip = p[6] > 0.5f;
  const int fx0 = flip ? n - 1 : 0, fdx = flip ? -1 : 1;
  switch (k) {
    case 0: return {fx0, ld, fdx};                                   // (iy, sx)
    case 1: return {(n - 1 - fx0) * ld, 1, -fdx * ld};               // (n-1-sx, iy)
    case 2: return {(n - 1) * ld + n - 1 - fx0, -ld, -fdx};          // (n-1-iy, n-1-sx)
    default: return {fx0 * ld + n - 1, -1, fdx * ld};                // (sx, n-1-iy)
  }
}

// Calls f(e, x[e]) for every e in [lo, hi), by this thread's share, with
// 16-byte loads where x + e is 16-byte aligned.
template <class F>
__device__ __forceinline__ void for_each_load(const float* __restrict__ x, long long lo,
                                              long long hi, F f) {
  const int mis = (int)(((uintptr_t)x >> 2) & 3);
  const long long a = min(hi, lo + ((4 - (int)((lo + mis) & 3)) & 3));
  const long long z = a + ((hi - a) & ~3LL);
  const int t = threadIdx.x, nt = blockDim.x;
  if (lo + t < a) f(lo + t, x[lo + t]);
  // two loads in flight before their values are used
  for (long long e = a + 4LL * t; e < z; e += 8LL * nt) {
    const long long e2 = e + 4LL * nt;
    const float4 v = *reinterpret_cast<const float4*>(x + e);
    const float4 v2 = e2 < z ? *reinterpret_cast<const float4*>(x + e2) : v;
    f(e, v.x);
    f(e + 1, v.y);
    f(e + 2, v.z);
    f(e + 3, v.w);
    if (e2 < z) {
      f(e2, v2.x);
      f(e2 + 1, v2.y);
      f(e2 + 2, v2.z);
      f(e2 + 3, v2.w);
    }
  }
  if (z + t < hi) f(z + t, x[z + t]);
}

// Writes out[e] = g(e) for every e in [lo, hi), by this thread's share,
// with 16-byte stores where out + e is 16-byte aligned.
template <class G>
__device__ __forceinline__ void for_each_store(float* __restrict__ out, long long lo,
                                               long long hi, G g) {
  const int mis = (int)(((uintptr_t)out >> 2) & 3);
  const long long a = min(hi, lo + ((4 - (int)((lo + mis) & 3)) & 3));
  const long long z = a + ((hi - a) & ~3LL);
  const int t = threadIdx.x, nt = blockDim.x;
  if (lo + t < a) out[lo + t] = g(lo + t);
  for (long long e = a + 4LL * t; e < z; e += 4LL * nt)
    *reinterpret_cast<float4*>(out + e) = make_float4(g(e), g(e + 1), g(e + 2), g(e + 3));
  if (z + t < hi) out[z + t] = g(z + t);
}

// element l of a sample (n^2 C floats, NHWC) -> channel c, row iy, column ix
struct Elem {
  int c, iy, ix;
};

__device__ __forceinline__ Elem split(unsigned l, int n, int channels,
                                      const FastDiv& fd_c, const FastDiv& fd_n) {
  const unsigned pix = fdiv(l, fd_c), iy = fdiv(pix, fd_n);
  return {(int)(l - pix * channels), (int)iy, (int)(pix - iy * n)};
}

bool shape_ok(int batch, int n, int channels) {
  return batch > 0 && channels > 0 && n > 0 && n <= kMaxN &&
         (long long)n * n * channels < (1LL << 31);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// kCta: one CTA per sample, its C planes in shared memory; kPer =
// ceil(n / 32), so that a line's unrolled loop issues no empty slots
template <int kPer>
__global__ void __launch_bounds__(kThreads)
warp_cta_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ params, int n, int channels,
                FastDiv fd_c, FastDiv fd_n) {
  extern __shared__ __align__(16) float planes[];  // C planes of n rows, ld apart
  const int ld = plane_ld(n), psz = n * ld;
  const float* p = params + 8 * (long long)blockIdx.x;
  const long long img = (long long)blockIdx.x * n * n * channels;
  const long long len = (long long)n * n * channels;
  const LoadMap lm = load_map(p, n, ld);
  for_each_load(x, img, img + len, [&](long long e, float v) {
    const Elem el = split((unsigned)(e - img), n, channels, fd_c, fd_n);
    planes[el.c * psz + lm.o0 + el.iy * lm.dy + el.ix * lm.dx] = v;
  });
  __syncthreads();
  run_passes<kPer>(planes, channels, n, ld, p, fd_n);
  for_each_store(out, img, img + len, [&](long long e) {
    const Elem el = split((unsigned)(e - img), n, channels, fd_c, fd_n);
    return planes[el.c * psz + el.iy * ld + el.ix];
  });
}

template <int kPer>
int launch_cta(const void* x, void* out, const void* params, int batch, int n,
               int channels, size_t smem, void* stream) {
  if (kPer * 32 < n) {
    if constexpr (kPer < kPerLane)
      return launch_cta<kPer + 1>(x, out, params, batch, n, channels, smem, stream);
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(warp_cta_kernel<kPer>, smem);
  if (err != cudaSuccess) return (int)err;
  warp_cta_kernel<kPer><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const float*)params, n, channels,
      make_fastdiv(channels), make_fastdiv(n));
  return (int)cudaGetLastError();
}

// The kCluster route's row stride: where n % 4 == 0 and the plane fits,
// the least ld >= n with ld = 4 (mod 8), so that each row starts 16-byte
// aligned (16-byte DSMEM moves) and a column's 32 lanes fall in 8 banks;
// else plane_ld(n) (4-byte DSMEM moves, conflict-free columns)
int cluster_ld(int n) {
  if (n % 4 == 0) {
    const int ld = n % 8 ? n : n + 4;
    if (sizeof(float) * (size_t)n * ld <= (size_t)kMaxSharedBytes) return ld;
  }
  return plane_ld(n);
}

// Four consecutive pixels of one row (group g, n % 4 == 0), all kC
// channels: kC 16-byte loads of the sample's NHWC floats; v[j * kC + c] is
// pixel j's channel c.
template <int kC>
__device__ __forceinline__ void load_group(const float* __restrict__ img, int g,
                                           float (&v)[4 * kC]) {
  const float4* src = reinterpret_cast<const float4*>(img) + (long long)g * kC;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const float4 f = src[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// Writes group g's values into each channel owner's plane at the load
// map's positions: one 16-byte DSMEM store per channel where the four
// pixels land side by side in a row (quarter-turns 0 and 2), else four
// 4-byte stores.
template <int kC>
__device__ __forceinline__ void scatter_group(cg::cluster_group& cluster, float* plane,
                                              int g, int n, const LoadMap& lm,
                                              const FastDiv& fd_n, const float (&v)[4 * kC]) {
  const int pix = 4 * g, iy = fdiv(pix, fd_n), ix = pix - iy * n;
  const int q = lm.o0 + iy * lm.dy + ix * lm.dx;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float* dst = cluster.map_shared_rank(plane, c);
    const float a0 = v[c], a1 = v[kC + c], a2 = v[2 * kC + c], a3 = v[3 * kC + c];
    if (lm.dx == 1) {
      *reinterpret_cast<float4*>(dst + q) = make_float4(a0, a1, a2, a3);
    } else if (lm.dx == -1) {
      *reinterpret_cast<float4*>(dst + q - 3) = make_float4(a3, a2, a1, a0);
    } else {
      dst[q] = a0;
      dst[q + lm.dx] = a1;
      dst[q + 2 * lm.dx] = a2;
      dst[q + 3 * lm.dx] = a3;
    }
  }
}

// Group g of the output: one 16-byte DSMEM load from each channel's plane,
// interleaved into kC 16-byte stores.
template <int kC>
__device__ __forceinline__ void store_group(cg::cluster_group& cluster, float* plane,
                                            float* __restrict__ out_img, int g, int n, int ld,
                                            const FastDiv& fd_n) {
  const int pix = 4 * g, iy = fdiv(pix, fd_n), ix = pix - iy * n;
  float w[kC][4];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float4 f =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(plane, c) + iy * ld + ix);
    w[c][0] = f.x;
    w[c][1] = f.y;
    w[c][2] = f.z;
    w[c][3] = f.w;
  }
  float4* dst = reinterpret_cast<float4*>(out_img) + (long long)g * kC;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int e = 4 * i;
    dst[i] = make_float4(w[e % kC][e / kC], w[(e + 1) % kC][(e + 1) / kC],
                         w[(e + 2) % kC][(e + 2) / kC], w[(e + 3) % kC][(e + 3) / kC]);
  }
}

// kCluster: a cluster of kC CTAs per sample, CTA c holding channel c. With
// `vec` (ld % 4 == 0, x and out 16-byte aligned) each thread moves groups
// of four pixels; else elements one by one.
template <int kC>
__global__ void __launch_bounds__(kThreads)
warp_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const float* __restrict__ params, int n, int ld, bool vec,
                    FastDiv fd_c, FastDiv fd_n) {
  extern __shared__ __align__(16) float plane[];  // n rows, ld apart
  // A CTA may write another's shared memory only once that CTA has started:
  // a cluster barrier before the first remote store, its arrive relaxed (it
  // orders no memory) and issued first, so that the set-up below overlaps it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kC;
  const float* p = params + 8 * (long long)b;
  const long long img = (long long)b * n * n * kC;
  const LoadMap lm = load_map(p, n, ld);
  const int groups = n * n / 4, g0 = rank * groups / kC, g1 = (rank + 1) * groups / kC;
  const int nt = blockDim.x;
  // this CTA's contiguous 1/kC of the sample
  const long long lo = img + (long long)rank * n * n, hi = lo + (long long)n * n;
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (vec) {
    // two groups in flight where their 8 kC values leave registers to
    // spare (kC <= 3; above, 64 registers a thread would spill)
    constexpr int kInFlight = kC <= 3 ? 2 : 1;
    for (int g = g0 + threadIdx.x; g < g1; g += kInFlight * nt) {
      float v[kInFlight][4 * kC];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (g + u * nt < g1) load_group<kC>(x + img, g + u * nt, v[u]);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (g + u * nt < g1) scatter_group<kC>(cluster, plane, g + u * nt, n, lm, fd_n, v[u]);
    }
  } else {
    for_each_load(x, lo, hi, [&](long long e, float v) {
      const Elem el = split((unsigned)(e - img), n, kC, fd_c, fd_n);
      cluster.map_shared_rank(plane, el.c)[lm.o0 + el.iy * lm.dy + el.ix * lm.dx] = v;
    });
  }
  cluster.sync();
  run_passes<kPerLane>(plane, 1, n, ld, p, fd_n);
  cluster.sync();
  if (vec) {
    for (int g = g0 + threadIdx.x; g < g1; g += nt)
      store_group<kC>(cluster, plane, out + img, g, n, ld, fd_n);
  } else {
    for_each_store(out, lo, hi, [&](long long e) {
      const Elem el = split((unsigned)(e - img), n, kC, fd_c, fd_n);
      return cluster.map_shared_rank(plane, el.c)[el.iy * ld + el.ix];
    });
  }
  cluster.sync();  // no CTA leaves while another still reads its plane
}

template <int kC>
int launch_cluster(const void* x, void* out, const void* params, int batch, int n,
                   int channels, void* stream) {
  if (channels != kC) {
    if constexpr (kC < kMaxCluster)
      return launch_cluster<kC + 1>(x, out, params, batch, n, channels, stream);
    return (int)cudaErrorInvalidValue;
  }
  const int ld = cluster_ld(n);
  const bool vec = ld % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const size_t smem = sizeof(float) * (size_t)n * ld;
  cudaError_t err = allow_smem(warp_cluster_kernel<kC>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, warp_cluster_kernel<kC>, (const float*)x, (float*)out,
                           (const float*)params, n, ld, vec, make_fastdiv(kC),
                           make_fastdiv(n));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// kPlane: the first design, one CTA per (sample, channel), strided loads
__global__ void __launch_bounds__(kPlaneThreads)
warp_plane_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ params, int n, int channels) {
  constexpr int kWarps = kPlaneThreads / 32;
  extern __shared__ __align__(16) float plane[];  // n rows of stride n + 1
  const int b = blockIdx.x / channels, c = blockIdx.x - b * channels;
  const float* p = params + 8 * (long long)b;
  const float alpha = p[0], beta = p[1], gamma = p[2], tx = p[3], ty = p[4];
  const int kq = ((int)p[5]) & 3;
  const bool flip = p[6] > 0.5f;
  const int ld = n + 1;
  const long long img = (long long)b * n * n * channels;

  // load with hflip, then quarter-turn, as an index map
  for (int idx = threadIdx.x; idx < n * n; idx += kPlaneThreads) {
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

  for (int idx = threadIdx.x; idx < n * n; idx += kPlaneThreads) {
    const int y = idx / n, xx = idx - y * n;
    out[img + (long long)idx * channels + c] = plane[y * ld + xx];
  }
}

}  // namespace

// kCta: a sample's C planes fit one CTA's shared memory
extern "C" int basd_warp_cta(const void* x, void* out, const void* params,
                             int batch, int n, int channels, void* stream) {
  const size_t smem = sizeof(float) * (size_t)channels * n * plane_ld(n);
  if (!shape_ok(batch, n, channels) || smem > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  return launch_cta<1>(x, out, params, batch, n, channels, smem, stream);
}

// kCluster: a cluster of 2 <= C <= 8 CTAs per sample, one plane each
extern "C" int basd_warp_cluster(const void* x, void* out, const void* params,
                                 int batch, int n, int channels, void* stream) {
  if (!shape_ok(batch, n, channels) || channels < 2 || channels > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  return launch_cluster<2>(x, out, params, batch, n, channels, stream);
}

// kPlane: one CTA per (sample, channel)
extern "C" int basd_warp_plane(const void* x, void* out, const void* params,
                               int batch, int n, int channels, void* stream) {
  const size_t smem = sizeof(float) * (size_t)n * (n + 1);
  if (!shape_ok(batch, n, channels)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(warp_plane_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  warp_plane_kernel<<<batch * channels, kPlaneThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const float*)params, n, channels);
  return (int)cudaGetLastError();
}
