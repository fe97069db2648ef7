// Softmax-free attention forward variants (K6), the timing probe of the
// attention forward's passes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel` of tools/probe_attn_internals.py
// and computes what it computes, on purpose without the 1/sqrt(hd) scale
// and without normalisation, on q, k, v in the probe's (B, H, N, hd = 64)
// bf16 layout:
//   s = q k^T accumulated in fp32, then per variant
//     full     e = bf16(exp(s - rowmax))
//     tilemax  e = bf16(exp(s - M)), M the max of s over the whole
//              (group, N, N) tile of `group` consecutive sequences of one
//              head (the Pallas grid block)
//     nomax    e = bf16(exp(s))
//     bf16exp  e = bf16(exp(bf16(s - rowmax)))
//     noexp    e = bf16(s)
//     mxonly   e = bf16(s) rounded as the scores are produced: no
//              elementwise pass over the score tile at all
//   and o = bf16(e v), accumulated in fp32.
// tilemax needs M before any exp, and M spans CTAs: it takes two launches.
// The first (variant `kMaxPass`) computes each CTA's score tile and writes
// its max to a (B, H, query blocks) scratch; the second reduces the
// group's maxima (group x query blocks floats) and runs the variant.
//
// What bounds it here: 4 B H N^2 hd flops (51.9 GFLOP at the teacher's
// (256, 12, 257, 64)) against 404 MB of q, k, v and o, so by the card's
// peaks the bytes bound it (0.121 ms against 0.053 ms of bf16 tensor-core
// time). This first version is the simple one: one CTA per (32-row query
// block, head, sequence) keeps its 32 x N score rows in shared memory as
// fp32 (66.6 KB at N = 257, three CTAs per SM), streams k and v through
// shared memory in 64-key chunks (from L2 after the first of the N/32
// query blocks of a head) and runs both products on the fp32 CUDA cores,
// each thread on a 4 x 4 register tile. The
// tensor-core version belongs to the attention redesign that this probe
// is the instrument for.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math: IEEE exp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // 8 x 16 threads, 4 x 4 tiles
constexpr int HD = 64;         // head_dim of every BASD ViT attention
constexpr int kBq = 32;        // query rows per CTA
constexpr int kBk = 64;        // keys per streamed chunk
constexpr int kMaxN = 1024;
constexpr int kMaxSharedBytes = 232448;

enum Variant {
  kFull = 0, kTileMax = 1, kNoMax = 2, kBf16Exp = 3, kNoExp = 4, kMxOnly = 5,
  kMaxPass = 6,
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// shared-memory layout, in floats: the q tile, one k chunk (HD x kBk+4)
// or v chunk (kBk x HD+4), and the kBq x padded-N score rows
constexpr int kQFloats = HD * kBq;
constexpr int kKVFloats = HD * (kBk + 4);
static_assert(kKVFloats >= kBk * (HD + 4), "a v chunk fits the k chunk's space");
size_t smem_bytes(int n) {
  const size_t padded = (n + kBk - 1) / kBk * kBk;
  return sizeof(float) * (kQFloats + kKVFloats + kBq * padded);
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
attn_probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ tile_max, int H, int N, int group) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads / 32];
  const int nqb = gridDim.x, qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * kBq, rows = min(kBq, N - q0);
  const int sld = (N + kBk - 1) / kBk * kBk;  // padded key count
  float* Qs = smem;                   // HD x kBq, transposed: Qs[d * kBq + r]
  float* KV = Qs + kQFloats;          // a k chunk or a v chunk
  float* S = KV + kKVFloats;          // kBq x sld: scores, then e
  const long long head = ((long long)b * H + h) * N * HD;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  // ---- s = q k^T: rows ty*4.., keys tx*4.. of each 64-key chunk ----
  for (int i = tid; i < kBq * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    Qs[d * kBq + r] = r < rows ? __bfloat162float(q[head + (long long)(q0 + r) * HD + d]) : 0.f;
  }
  constexpr int kld = kBk + 4;
  for (int k0 = 0; k0 < N; k0 += kBk) {
    const int kn = min(kBk, N - k0);
    __syncthreads();
    for (int i = tid; i < kBk * HD; i += kThreads) {
      const int j = i / HD, d = i - j * HD;
      KV[d * kld + j] = j < kn ? __bfloat162float(k[head + (long long)(k0 + j) * HD + d]) : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + d * kBq + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(KV + d * kld + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(qa[i], ka[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[c] = kVariant == kMxOnly ? round_bf16(acc[i][c]) : acc[i][c];
      *reinterpret_cast<float4*>(S + (ty * 4 + i) * sld + k0 + tx * 4) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
  __syncthreads();

  // ---- tilemax, first launch: this CTA's max over its valid scores ----
  if (kVariant == kMaxPass) {
    float mx = -INFINITY;
    for (int i = tid; i < rows * N; i += kThreads) {
      const int r = i / N, j = i - r * N;
      mx = fmaxf(mx, S[r * sld + j]);
    }
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, red[w]);
      tile_max[((long long)b * H + h) * nqb + qb] = mx;
    }
    return;
  }

  // ---- the variant's elementwise pass; keys past N and rows past `rows`
  // get e = 0 (mxonly has no pass: its padded scores are exact zeros) ----
  if (kVariant != kMxOnly) {
    float tmax = 0.f;
    if (kVariant == kTileMax) {
      const int b0 = b / group * group;
      tmax = -INFINITY;
      for (int bb = b0; bb < b0 + group; ++bb)
        for (int t = 0; t < nqb; ++t)
          tmax = fmaxf(tmax, tile_max[((long long)bb * H + h) * nqb + t]);
    }
    for (int r = warp; r < kBq; r += kThreads / 32) {
      float* row = S + r * sld;
      float m = tmax;
      if (kVariant == kFull || kVariant == kBf16Exp) {
        m = -INFINITY;
        for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
        m = warp_max(m);
      }
      for (int j = lane; j < sld; j += 32) {
        float e = 0.f;
        if (j < N && r < rows) {
          const float s = row[j];
          if (kVariant == kFull || kVariant == kTileMax) e = round_bf16(expf(s - m));
          else if (kVariant == kNoMax) e = round_bf16(expf(s));
          else if (kVariant == kBf16Exp) e = round_bf16(expf(round_bf16(s - m)));
          else e = round_bf16(s);  // kNoExp
        }
        row[j] = e;
      }
    }
  }

  // ---- o = e v: rows ty*4.., columns tx*TC.. ----
  constexpr int TC = HD / 16;  // 4
  constexpr int vld = HD + 4;
  float acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kBk) {
    const int kn = min(kBk, N - k0);
    __syncthreads();
    for (int i = tid; i < kBk * HD; i += kThreads) {
      const int j = i / HD, d = i - j * HD;
      KV[j * vld + d] = j < kn ? __bfloat162float(v[head + (long long)(k0 + j) * HD + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float ea[4], va[TC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ea[i] = S[(ty * 4 + i) * sld + k0 + j];
#pragma unroll
      for (int c = 0; c < TC; ++c) va[c] = KV[j * vld + tx * TC + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] = fmaf(ea[i], va[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < TC; ++c)
        o[head + (long long)(q0 + r) * HD + tx * TC + c] = __float2bfloat16_rn(acc[i][c]);
    }
  }
}

template <int kVariant>
int launch_one(const void* q, const void* k, const void* v, void* o,
               void* tile_max, int B, int H, int N, int group, void* stream) {
  const size_t smem = smem_bytes(N);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_probe_kernel<kVariant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kBq - 1) / kBq, H, B);
  attn_probe_kernel<kVariant><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
      (float*)tile_max, H, N, group);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of variant `variant` (0..5 as in the enum above; 6 is the
// tilemax first launch, which writes `tile_max` (B, H, ceil(N / 32)) and
// not `o`). q, k, v, o are contiguous (B, H, N, 64) bf16.
extern "C" int basd_attn_probe(const void* q, const void* k, const void* v,
                               void* o, void* tile_max, int B, int H, int N,
                               int hd, int group, int variant, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535 || N < 1 || N > kMaxN || hd != HD)
    return (int)cudaErrorInvalidValue;
  if ((variant == kTileMax || variant == kMaxPass) &&
      (tile_max == nullptr || group < 1 || B % group != 0))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kFull: return launch_one<kFull>(q, k, v, o, tile_max, B, H, N, group, stream);
    case kTileMax: return launch_one<kTileMax>(q, k, v, o, tile_max, B, H, N, group, stream);
    case kNoMax: return launch_one<kNoMax>(q, k, v, o, tile_max, B, H, N, group, stream);
    case kBf16Exp: return launch_one<kBf16Exp>(q, k, v, o, tile_max, B, H, N, group, stream);
    case kNoExp: return launch_one<kNoExp>(q, k, v, o, tile_max, B, H, N, group, stream);
    case kMxOnly: return launch_one<kMxOnly>(q, k, v, o, tile_max, B, H, N, group, stream);
    case kMaxPass: return launch_one<kMaxPass>(q, k, v, o, tile_max, B, H, N, group, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
