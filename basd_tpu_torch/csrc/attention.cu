// Whole-row multi-head attention, forward (K1) and backward (K2), for the
// BASD ViTs on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fused_fwd_kernel`
// (basd_tpu/ops/attention.py:84) and `_fused_bwd_kernel` (:114) and keeps
// their contract exactly:
//   * inputs in the native (B, N, D) layout with D = H * hd, heads major
//     (no transposes), q pre-scaled by hd^-0.5;
//   * scores s = q k^T accumulated in fp32, fp32 max m of the WHOLE row
//     taken before any exp; e = exp(s - m) ROUNDED to the compute type,
//     denom = fp32 sum of the rounded e, o = (e v) / denom accumulated in
//     fp32, stored in the compute type; m and denom written as (B, N, H)
//     fp32;
//   * backward from the saved (m, denom) and dd = rowsum(dO * O) per head
//     (computed outside): e recomputed, dO_s = round(dO / denom),
//     dv = e^T dO_s, ds = round(e * (dO_s v^T - dd / denom)),
//     dq = ds k, dk = ds^T q; every product takes operands in the compute
//     type and sums in fp32.
//
// What bounds it here: bytes, at every main-path shape. The work per
// (batch, head) is a few MFLOP at N = 5..257 tokens, hd = 64 (under 300
// FLOP per byte of q/k/v/o), and the (N, N) score tile never reaches
// device memory, so the least time is the q/k/v/o slabs over 3.35 TB/s.
//
// bf16 (the model's type) runs on the tensor cores:
//   * every product is mma.sync m16n8k16 (bf16 operands, fp32
//     accumulation: the contract's rounding points exactly, only the order
//     of the fp32 sums differs), fed by ldmatrix; V, dO_s, q and k enter
//     the transposed products through ldmatrix.trans. Each warp owns a
//     16-row tile (16 query rows, or 16 keys in the dk/dv launch): the
//     short sequences leave wgmma's 64-row tile mostly empty (59 of 64 rows
//     at N = 5), and mma.sync's rate is not the limit.
//   * operands move by 16-byte cp.async straight into bf16 shared memory,
//     rows padded by 8 elements (an odd number of 16-byte pieces per row,
//     so ldmatrix is free of bank conflicts); rows past N are zero-filled.
//     A CTA holds up to 8 warp tiles of one (batch, head), or up to 4
//     heads at N <= 16, so a head's K and V are read by ceil(N / 128)
//     CTAs, not N / 16 of them; each byte is loaded once per CTA.
//   * the whole-row max takes route (b), two passes over the keys: the
//     forward keeps the head's whole K in shared memory (up to 139 KB at
//     N = 512, hd = 128) and streams V in double-buffered 64-key chunks;
//     pass 1 takes the row max from the mma accumulators, pass 2
//     recomputes s (the same instructions on the same operands, so the
//     same bits) and goes on to e, denom and e v. Route (a), the scores
//     kept in registers, holds N / 2 fp32 per thread and stops near
//     N = 128, so it would need (b) beside it; (b) covers the whole gate
//     (N <= 512, hd <= 128) with one code path. Measured by chip_smoke.py
//     (PERF.md), (b) runs the student's forward within a few percent of
//     SDPA's device time; the recomputed s is a third of its products,
//     the most (a) could save. No online softmax: denom sums the e that
//     are rounded against the row's final max, as the TPU kernel's do.
//   * e is rounded to bf16 and packed from the score accumulators straight
//     into the A fragment of the e v product (the m16n8k16 C layout of two
//     n8 tiles is the A layout of one k16 step): e never goes through
//     shared memory. denom sums the rounded e across the quad with
//     __shfl_xor_sync. Keys past N are masked to s = -inf, so e = 0
//     exactly; rows past N are never stored.
//   * the backward is two launches with no atomics, deterministic: dk/dv
//     per 16-key warp tile (q, dO and the row stats streamed in 64-row
//     chunks), dq per 16-row warp tile (k and v streamed). dO_s is formed
//     in shared memory as each chunk lands. Both recompute s and dp on the
//     tensor cores with the same arithmetic.
// Inputs must be 16-byte aligned for cp.async: base pointer, batch and row
// strides (the wrapper checks and raises).
//
// fp32 stays on the CUDA cores (the first kernels below): tensor cores
// would take fp32 as TF32, which misses the 1e-5 tolerance. One CTA per
// 16 query rows (or keys) of one (batch, head), score rows in shared
// memory, fp32 FMAs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math: IEEE division and exp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

// ------------------------------------------------- fp32 on the CUDA cores

constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
// forward: query rows per CTA and keys per streamed chunk
constexpr int kFwdBq = 16;
constexpr int kFwdBk = 32;
// backward dk/dv: keys per CTA and query rows per streamed chunk
constexpr int kBwdBk = 16;
constexpr int kBwdBq = 32;
// backward dq: query rows per CTA and keys per streamed chunk
constexpr int kDqBq = 16;
constexpr int kDqBk = 32;
// accumulators per thread: block rows * kMaxHd / kThreads
constexpr int kAcc = 8;
static_assert(kFwdBq * kMaxHd <= kAcc * kThreads, "fwd accumulators");
static_assert(kBwdBk * kMaxHd <= kAcc * kThreads, "dkdv accumulators");
static_assert(kDqBq * kMaxHd <= kAcc * kThreads, "dq accumulators");

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [r0, r0 + rows) of one head of a strided (B, N, D) tensor into a
// float tile with leading dimension ld; rows past `rows` are zero
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long sn, int r0, int rows,
                                          int max_rows, int hd) {
  for (int i = threadIdx.x; i < max_rows * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    dst[r * ld + c] = r < rows ? src[(long long)(r0 + r) * sn + c] : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int hd) {
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ m_out, float* __restrict__ d_out, int N,
                int H, int hd, long long qsb, long long qsn, long long ksb,
                long long ksn, long long vsb, long long vsn) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kFwdBq, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kFwdBq, N - q0);
  const int ld = hd + 1;  // odd stride: conflict-free column walks
  float* qs = smem;                    // kFwdBq x ld
  float* ch = qs + kFwdBq * ld;        // kFwdBk x ld (K, then V chunks)
  float* S = ch + kFwdBk * ld;         // kFwdBq x N (scores, then e)
  float* rden = S + kFwdBq * N;        // kFwdBq
  const float* qb = q + b * qsb + h * hd;
  const float* kb = k + b * ksb + h * hd;
  const float* vb = v + b * vsb + h * hd;
  const int tid = threadIdx.x;

  load_tile(qs, ld, qb, qsn, q0, rows, kFwdBq, hd);
  for (int k0 = 0; k0 < N; k0 += kFwdBk) {
    const int kn = min(kFwdBk, N - k0);
    __syncthreads();
    load_tile(ch, ld, kb, ksn, k0, kn, kn, hd);
    __syncthreads();
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int r = i / kn, j = i - r * kn;
      S[r * N + k0 + j] = dot(qs + r * ld, ch + j * ld, hd);
    }
  }
  __syncthreads();

  // fp32 rowmax, e, denom = fp32 sum of e
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = S + r * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      rden[r] = sum;
      const long long at = ((long long)b * N + q0 + r) * H + h;
      m_out[at] = mx;
      d_out[at] = sum;
    }
  }

  float acc[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc[t] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kFwdBk) {
    const int kn = min(kFwdBk, N - k0);
    __syncthreads();
    load_tile(ch, ld, vb, vsn, k0, kn, kn, hd);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kAcc; ++t) {
      const int i = tid + t * kThreads;
      if (i < rows * hd) {
        const int r = i / hd, c = i - r * hd;
        const float* e = S + r * N + k0;
        float a = acc[t];
        for (int j = 0; j < kn; ++j) a = fmaf(e[j], ch[j * ld + c], a);
        acc[t] = a;
      }
    }
  }
  const int D = H * hd;
#pragma unroll
  for (int t = 0; t < kAcc; ++t) {
    const int i = tid + t * kThreads;
    if (i < rows * hd) {
      const int r = i / hd, c = i - r * hd;
      o[((long long)b * N + q0 + r) * D + h * hd + c] = acc[t] / rden[r];
    }
  }
}

// --------------------------------------------------------------- backward

// Shared per-query-row state of the backward: q and the scaled dO rows as
// float tiles, and m, 1/denom, dd/denom per row.
__device__ __forceinline__ void load_query_side(
    float* qs, float* dos, float* mrow, float* rdrow, float* ddrow, int ld,
    const float* qb, long long qsn, const float* db, long long dsn, const float* m,
    const float* denom, const float* dd, int b, int h, int N, int H, int r0,
    int rows, int max_rows, int hd) {
  for (int r = threadIdx.x; r < max_rows; r += kThreads) {
    if (r < rows) {
      const long long at = ((long long)b * N + r0 + r) * H + h;
      const float rd = 1.0f / denom[at];
      mrow[r] = m[at];
      rdrow[r] = rd;
      ddrow[r] = dd[at] * rd;
    } else {
      mrow[r] = 0.f;
      rdrow[r] = 0.f;
      ddrow[r] = 0.f;
    }
  }
  load_tile(qs, ld, qb, qsn, r0, rows, max_rows, hd);
  __syncthreads();  // rdrow is read below
  for (int i = threadIdx.x; i < max_rows * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    dos[r * ld + c] = r < rows ? db[(long long)(r0 + r) * dsn + c] * rdrow[r] : 0.f;
  }
}

// e and ds for one (query row, key) pair, identical in both launches
__device__ __forceinline__ void e_and_ds(const float* qrow, const float* dorow,
                                         const float* krow, const float* vrow,
                                         float m, float ddr, int hd, float* e_out,
                                         float* ds_out) {
  const float e = expf(dot(qrow, krow, hd) - m);
  const float dp = dot(dorow, vrow, hd);
  *e_out = e;
  *ds_out = e * (dp - ddr);
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ m, const float* __restrict__ denom,
                     const float* __restrict__ dd, float* __restrict__ dk,
                     float* __restrict__ dv, int N, int H, int hd, long long qsb,
                     long long qsn, long long ksb, long long ksn, long long vsb,
                     long long vsn, long long dsb, long long dsn) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kBwdBk, h = blockIdx.y, b = blockIdx.z;
  const int kn = min(kBwdBk, N - k0);
  const int ld = hd + 1;
  const int lp = kBwdBk + 1;
  float* ks = smem;                    // kBwdBk x ld
  float* vs = ks + kBwdBk * ld;        // kBwdBk x ld
  float* qs = vs + kBwdBk * ld;        // kBwdBq x ld
  float* dos = qs + kBwdBq * ld;       // kBwdBq x ld
  float* P = dos + kBwdBq * ld;        // kBwdBq x lp (e)
  float* DS = P + kBwdBq * lp;         // kBwdBq x lp (ds)
  float* mrow = DS + kBwdBq * lp;      // kBwdBq
  float* rdrow = mrow + kBwdBq;
  float* ddrow = rdrow + kBwdBq;
  const float* qb = q + b * qsb + h * hd;
  const float* kb = k + b * ksb + h * hd;
  const float* vb = v + b * vsb + h * hd;
  const float* db = dO + b * dsb + h * hd;
  const int tid = threadIdx.x;

  load_tile(ks, ld, kb, ksn, k0, kn, kBwdBk, hd);
  load_tile(vs, ld, vb, vsn, k0, kn, kBwdBk, hd);

  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc_k[t] = acc_v[t] = 0.f;

  for (int r0 = 0; r0 < N; r0 += kBwdBq) {
    const int rows = min(kBwdBq, N - r0);
    __syncthreads();
    load_query_side(qs, dos, mrow, rdrow, ddrow, ld, qb, qsn, db, dsn, m,
                    denom, dd, b, h, N, H, r0, rows, kBwdBq, hd);
    __syncthreads();
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int r = i / kn, j = i - r * kn;
      e_and_ds(qs + r * ld, dos + r * ld, ks + j * ld, vs + j * ld, mrow[r],
               ddrow[r], hd, P + r * lp + j, DS + r * lp + j);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kAcc; ++t) {
      const int i = tid + t * kThreads;
      if (i < kn * hd) {
        const int j = i / hd, c = i - j * hd;
        float ak = acc_k[t], av = acc_v[t];
        for (int r = 0; r < rows; ++r) {
          av = fmaf(P[r * lp + j], dos[r * ld + c], av);
          ak = fmaf(DS[r * lp + j], qs[r * ld + c], ak);
        }
        acc_k[t] = ak;
        acc_v[t] = av;
      }
    }
  }
  const int D = H * hd;
#pragma unroll
  for (int t = 0; t < kAcc; ++t) {
    const int i = tid + t * kThreads;
    if (i < kn * hd) {
      const int j = i / hd, c = i - j * hd;
      const long long at = ((long long)b * N + k0 + j) * D + h * hd + c;
      dk[at] = acc_k[t];
      dv[at] = acc_v[t];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ m, const float* __restrict__ denom,
                   const float* __restrict__ dd, float* __restrict__ dq, int N,
                   int H, int hd, long long qsb, long long qsn, long long ksb,
                   long long ksn, long long vsb, long long vsn, long long dsb,
                   long long dsn) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * kDqBq, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kDqBq, N - r0);
  const int ld = hd + 1;
  const int lp = kDqBk + 1;
  float* qs = smem;                    // kDqBq x ld
  float* dos = qs + kDqBq * ld;        // kDqBq x ld
  float* ks = dos + kDqBq * ld;        // kDqBk x ld
  float* vs = ks + kDqBk * ld;         // kDqBk x ld
  float* P = vs + kDqBk * ld;          // kDqBq x lp (e, unused after ds)
  float* DS = P + kDqBq * lp;          // kDqBq x lp
  float* mrow = DS + kDqBq * lp;       // kDqBq
  float* rdrow = mrow + kDqBq;
  float* ddrow = rdrow + kDqBq;
  const float* qb = q + b * qsb + h * hd;
  const float* kb = k + b * ksb + h * hd;
  const float* vb = v + b * vsb + h * hd;
  const float* db = dO + b * dsb + h * hd;
  const int tid = threadIdx.x;

  load_query_side(qs, dos, mrow, rdrow, ddrow, ld, qb, qsn, db, dsn, m,
                  denom, dd, b, h, N, H, r0, rows, kDqBq, hd);

  float acc[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc[t] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kDqBk) {
    const int kn = min(kDqBk, N - k0);
    __syncthreads();
    load_tile(ks, ld, kb, ksn, k0, kn, kn, hd);
    load_tile(vs, ld, vb, vsn, k0, kn, kn, hd);
    __syncthreads();
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int r = i / kn, j = i - r * kn;
      e_and_ds(qs + r * ld, dos + r * ld, ks + j * ld, vs + j * ld, mrow[r],
               ddrow[r], hd, P + r * lp + j, DS + r * lp + j);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kAcc; ++t) {
      const int i = tid + t * kThreads;
      if (i < rows * hd) {
        const int r = i / hd, c = i - r * hd;
        float a = acc[t];
        for (int j = 0; j < kn; ++j) a = fmaf(DS[r * lp + j], ks[j * ld + c], a);
        acc[t] = a;
      }
    }
  }
  const int D = H * hd;
#pragma unroll
  for (int t = 0; t < kAcc; ++t) {
    const int i = tid + t * kThreads;
    if (i < rows * hd) {
      const int r = i / hd, c = i - r * hd;
      dq[((long long)b * N + r0 + r) * D + h * hd + c] = acc[t];
    }
  }
}

size_t fwd_smem(int N, int hd) {
  const int ld = hd + 1;
  return sizeof(float) * ((kFwdBq + kFwdBk) * ld + kFwdBq * N + kFwdBq);
}

size_t dkdv_smem(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         (2 * kBwdBk * ld + 2 * kBwdBq * ld + 2 * kBwdBq * (kBwdBk + 1) + 3 * kBwdBq);
}

size_t dq_smem(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         (2 * kDqBq * ld + 2 * kDqBk * ld + 2 * kDqBq * (kDqBk + 1) + 3 * kDqBq);
}

// dynamic shared memory above the 48 KB default needs an explicit opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int launch_fwd(const void* q, const void* k, const void* v, void* o, void* m,
               void* denom, int B, int N, int H, int hd, long long qsb,
               long long qsn, long long ksb, long long ksn, long long vsb,
               long long vsn, cudaStream_t stream) {
  const size_t smem = fwd_smem(N, hd);
  cudaError_t err = allow_smem(attn_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kFwdBq - 1) / kFwdBq, H, B);
  attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)m, (float*)denom,
      N, H, hd, qsb, qsn, ksb, ksn, vsb, vsn);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dO,
               const void* m, const void* denom, const void* dd, void* dq,
               void* dk, void* dv, int B, int N, int H, int hd, long long qsb,
               long long qsn, long long ksb, long long ksn, long long vsb,
               long long vsn, long long dsb, long long dsn,
               cudaStream_t stream) {
  const size_t s1 = dkdv_smem(hd), s2 = dq_smem(hd);
  cudaError_t err = allow_smem(attn_bwd_dkdv_kernel, s1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attn_bwd_dq_kernel, s2);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((N + kBwdBk - 1) / kBwdBk, H, B);
  attn_bwd_dkdv_kernel<<<g1, kThreads, s1, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO, (const float*)m,
      (const float*)denom, (const float*)dd, (float*)dk, (float*)dv, N, H, hd, qsb,
      qsn, ksb, ksn, vsb, vsn, dsb, dsn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((N + kDqBq - 1) / kDqBq, H, B);
  attn_bwd_dq_kernel<<<g2, kThreads, s2, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO, (const float*)m,
      (const float*)denom, (const float*)dd, (float*)dq, N, H, hd, qsb, qsn, ksb,
      ksn, vsb, vsn, dsb, dsn);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16 on the tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 8;  // 16-row warp tiles per CTA
constexpr int kChunk = 64;    // rows per streamed chunk
constexpr int kPad = 8;       // bf16 of row padding (ldmatrix without conflicts)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` committed groups are still in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// c += a b for one m16n8k16 tile, bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two fp32 values rounded to bf16 (to nearest even) in one 32-bit register,
// lo first: a fragment register of an mma operand
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ldmatrix row addresses, as offsets into a tile of stride ld:
// A fragments (16 rows x 16 columns) and the trans-loaded B fragments of
// two n8 tiles (16 k rows x 16 columns) share one pattern ...
__device__ __forceinline__ int frag_a_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
// ... the B fragments of two n8 tiles from 16 rows stored n-major (k rows
// of a "col" operand, e.g. K for s = q k^T) take another
__device__ __forceinline__ int frag_b_off(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// the A fragments of a 16 x HD tile
template <int HD>
__device__ __forceinline__ void load_a(unsigned (&a)[HD / 16][4], const bf16* tile,
                                       int lane) {
  constexpr int ld = HD + kPad;
  const bf16* p = tile + frag_a_off(lane, ld);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// s = A rows^T for 16 rows of a (., HD) tile: two n8 tiles of columns
template <int HD>
__device__ __forceinline__ void scores16(float (&s)[2][4], const unsigned (&a)[HD / 16][4],
                                         const bf16* rows, int lane) {
  constexpr int ld = HD + kPad;
  const bf16* p = rows + frag_b_off(lane, ld);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    unsigned b[4];
    ldsm_x4(b, p + kk * 16);
    mma16816(s[0], a[kk], b[0], b[1]);
    mma16816(s[1], a[kk], b[2], b[3]);
  }
}

// acc (16 x HD) += p (16 x 16, as A fragments) times 16 rows of a (., HD)
// tile, the rows being the k dimension (loaded transposed)
template <int HD>
__device__ __forceinline__ void accumulate16(float (&acc)[HD / 8][4], const unsigned (&p)[4],
                                             const bf16* rows, int lane) {
  constexpr int ld = HD + kPad;
  const bf16* src = rows + frag_a_off(lane, ld);
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    unsigned b[4];
    ldsm_x4_trans(b, src + j * 16);
    mma16816(acc[2 * j], p, b[0], b[1]);
    mma16816(acc[2 * j + 1], p, b[2], b[3]);
  }
}

// the A fragment of a 16 x 16 block from the accumulators of its two n8
// tiles (values already bf16-exact)
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [r0, r0 + rows) of one head (HD columns at src) of a strided
// (B, N, D) tensor into a bf16 tile of stride HD + kPad by 16-byte
// cp.async, thread `tid` of `nthreads`; rows at or past n are zero-filled
template <int HD>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, long long sn, int r0,
                                        int rows, int n, int tid, int nthreads) {
  constexpr int kVec = HD / 8, ld = HD + kPad;
  for (int i = tid; i < rows * kVec; i += nthreads) {
    const int r = i / kVec, c = i - r * kVec;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * ld + c * 8, ok ? src + (long long)(r0 + r) * sn + c * 8 : src, ok);
  }
}

// a warp's 16 x HD fp32 tile, rounded to bf16, to rows [r0, r0 + 16) of a
// contiguous (., D) output (rows at or past n dropped), staged through the
// warp's own smem tile for 16-byte stores
template <int HD>
__device__ __forceinline__ void store_tile(bf16* stage, const float (&acc)[HD / 8][4],
                                           bf16* dst, int D, int r0, int n, int lane) {
  constexpr int kVec = HD / 8, ld = HD + kPad;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    *reinterpret_cast<unsigned*>(stage + g * ld + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * ld + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = i / kVec, c = i - r * kVec;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ld + c * 8);
  }
  __syncwarp();
}

// K1, bf16. Grid (query blocks, H / hg, B), tq * hg warps: warp w owns
// head slot w / tq and the 16-row query tile blockIdx.x * tq + w % tq.
// Shared memory: the slots' whole K (np rows), V chunks (1 or 2 stages),
// one q tile per warp (later its output staging).
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ m_out, float* __restrict__ d_out, int N, int H,
             int hg, int tq, long long qsb, long long qsn, long long ksb,
             long long ksn, long long vsb, long long vsn) {
  constexpr int ld = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int np = (N + 15) & ~15;  // keys padded to the mma's k step
  const int vrows = min(kChunk, np), nch = (np + kChunk - 1) / kChunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h0 = blockIdx.y * hg;
  const int slot = warp / tq, q0 = (blockIdx.x * tq + warp % tq) * 16;
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);     // hg x np x ld
  bf16* vs = ks + hg * np * ld;                      // stages x hg x vrows x ld
  bf16* qs = vs + (nch > 1 ? 2 : 1) * hg * vrows * ld + warp * 16 * ld;
  const int D = H * HD;
  auto load_v = [&](int c) {
    const int rows = min(kChunk, np - c * kChunk);
    for (int s = 0; s < hg; ++s)
      cp_rows<HD>(vs + ((c & 1) * hg + s) * vrows * ld, v + b * vsb + (h0 + s) * HD,
                  vsn, c * kChunk, rows, N, tid, blockDim.x);
  };

  for (int s = 0; s < hg; ++s)
    cp_rows<HD>(ks + s * np * ld, k + b * ksb + (h0 + s) * HD, ksn, 0, np, N, tid,
                blockDim.x);
  cp_rows<HD>(qs, q + b * qsb + (h0 + slot) * HD, qsn, q0, 16, N, lane, 32);
  cp_async_commit();
  load_v(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  unsigned qa[HD / 16][4];
  load_a<HD>(qa, qs, lane);
  const bf16* kw = ks + slot * np * ld;
  // keys at or past N score -inf: e = 0 exactly
  auto score = [&](float (&s)[2][4], int kb) {
    scores16<HD>(s, qa, kw + kb * ld, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kb + nt * 8 + 2 * t + (i & 1) >= N) s[nt][i] = -INFINITY;
  };

  // pass 1: the fp32 max of the whole row (rows g and g + 8 of the tile)
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int kb = 0; kb < np; kb += 16) {
    float s[2][4];
    score(s, kb);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);

  // pass 2: e rounded to bf16, denom from the rounded e, acc += e v
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float den0 = 0.f, den1 = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_v(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* vw = vs + ((c & 1) * hg + slot) * vrows * ld;
    const int rows = min(kChunk, np - c * kChunk);
    for (int j = 0; j < rows; j += 16) {
      float e[2][4];
      score(e, c * kChunk + j);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        e[nt][0] = bf16_round(expf(e[nt][0] - mx0));
        e[nt][1] = bf16_round(expf(e[nt][1] - mx0));
        e[nt][2] = bf16_round(expf(e[nt][2] - mx1));
        e[nt][3] = bf16_round(expf(e[nt][3] - mx1));
        den0 += e[nt][0] + e[nt][1];
        den1 += e[nt][2] + e[nt][3];
      }
      unsigned ea[4];
      pack_a(ea, e);
      accumulate16<HD>(acc, ea, vw + j * ld, lane);
    }
    __syncthreads();
  }
  den0 = quad_sum(den0);
  den1 = quad_sum(den1);

#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[j][0] /= den0;
    acc[j][1] /= den0;
    acc[j][2] /= den1;
    acc[j][3] /= den1;
  }
  const int h = h0 + slot;
  store_tile<HD>(qs, acc, o + (long long)b * N * D + h * HD, D, q0, N, lane);
  if (t == 0) {
    const long long at = ((long long)b * N + q0 + g) * H + h;
    if (q0 + g < N) {
      m_out[at] = mx0;
      d_out[at] = den0;
    }
    if (q0 + g + 8 < N) {
      m_out[at + 8LL * H] = mx1;
      d_out[at + 8LL * H] = den1;
    }
  }
}

// Per-row state of the backward for rows [r0, r0 + rows) of one head:
// m, 1/denom and dd/denom (fp32, as the float kernels form them); rows at
// or past n get m = +inf, so their e is exactly 0.
__device__ __forceinline__ void load_row_stats(float* st, int stride, const float* m,
                                               const float* denom, const float* dd,
                                               long long at0, int H, int r0, int rows,
                                               int n) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    if (r0 + r < n) {
      const long long at = at0 + (long long)(r0 + r) * H;
      const float rd = 1.0f / denom[at];
      st[r] = m[at];
      st[stride + r] = rd;
      st[2 * stride + r] = dd[at] * rd;
    } else {
      st[r] = INFINITY;
      st[stride + r] = 0.f;
      st[2 * stride + r] = 0.f;
    }
  }
}

// dO_s = round(dO * (1/denom)) in place on a landed bf16 tile of `rows` rows
template <int HD>
__device__ __forceinline__ void scale_rows(bf16* tile, const float* rd, int rows) {
  constexpr int kVec = HD / 8, ld = HD + kPad;
  for (int i = threadIdx.x; i < rows * kVec; i += blockDim.x) {
    const int r = i / kVec, c = i - r * kVec;
    uint4* p = reinterpret_cast<uint4*>(tile + r * ld + c * 8);
    uint4 x = *p;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      h2[j] = __floats2bfloat162_rn(f.x * rd[r], f.y * rd[r]);
    }
    *p = x;
  }
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// K2 dk/dv, bf16. Grid (key blocks, H, B), tk warps: warp w owns the 16
// keys (blockIdx.x * tk + w) * 16. Shared memory: the CTA's K and V rows,
// then q, dO_s (1 or 2 stages of 64 rows) and their row stats.
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dO,
              const float* __restrict__ m, const float* __restrict__ denom,
              const float* __restrict__ dd, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int N, int H, long long qsb, long long qsn,
              long long ksb, long long ksn, long long vsb, long long vsn,
              long long dsb, long long dsn) {
  constexpr int ld = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int np = (N + 15) & ~15;
  const int crows = min(kChunk, np), nch = (np + kChunk - 1) / kChunk;
  const int stages = nch > 1 ? 2 : 1;
  const int nwarps = blockDim.x >> 5, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kc0 = blockIdx.x * nwarps * 16, k0 = kc0 + warp * 16;
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);  // nwarps*16 x ld
  bf16* vs = ks + nwarps * 16 * ld;               // nwarps*16 x ld
  bf16* qs = vs + nwarps * 16 * ld;               // stages x crows x ld
  bf16* os = qs + stages * crows * ld;            // stages x crows x ld (dO_s)
  float* st = reinterpret_cast<float*>(os + stages * crows * ld);  // stages x 3 x crows
  const bf16* qb = q + b * qsb + h * HD;
  const bf16* db = dO + b * dsb + h * HD;
  const long long at0 = (long long)b * N * H + h;
  auto load_chunk = [&](int c) {
    const int rows = min(kChunk, np - c * kChunk), s = c & 1;
    cp_rows<HD>(qs + s * crows * ld, qb, qsn, c * kChunk, rows, N, tid, blockDim.x);
    cp_rows<HD>(os + s * crows * ld, db, dsn, c * kChunk, rows, N, tid, blockDim.x);
    load_row_stats(st + s * 3 * crows, crows, m, denom, dd, at0, H, c * kChunk, rows, N);
  };

  cp_rows<HD>(ks, k + b * ksb + h * HD, ksn, kc0, nwarps * 16, N, tid, blockDim.x);
  cp_rows<HD>(vs, v + b * vsb + h * HD, vsn, kc0, nwarps * 16, N, tid, blockDim.x);
  load_chunk(0);
  cp_async_commit();

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
  zero_acc<HD>(acc_k);
  zero_acc<HD>(acc_v);
  const bf16* kw = ks + warp * 16 * ld;
  const bf16* vw = vs + warp * 16 * ld;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_chunk(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = c & 1, rows = min(kChunk, np - c * kChunk);
    bf16* qc = qs + s * crows * ld;
    bf16* oc = os + s * crows * ld;
    const float* mq = st + s * 3 * crows;
    const float* ddq = mq + 2 * crows;
    scale_rows<HD>(oc, mq + crows, rows);
    __syncthreads();
    for (int j = 0; j < rows; j += 16) {
      // s^T and dp^T for the warp's 16 keys x 16 query rows j..j+15
      float sT[2][4], dpT[2][4];
      {
        unsigned a[HD / 16][4];
        load_a<HD>(a, kw, lane);
        scores16<HD>(sT, a, qc + j * ld, lane);
        load_a<HD>(a, vw, lane);
        scores16<HD>(dpT, a, oc + j * ld, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = j + nt * 8 + 2 * t + (i & 1);  // query row in the chunk
          const float e = bf16_round(expf(sT[nt][i] - mq[r]));
          sT[nt][i] = e;
          dpT[nt][i] = bf16_round(e * (dpT[nt][i] - ddq[r]));
        }
      unsigned ea[4], dsa[4];
      pack_a(ea, sT);
      pack_a(dsa, dpT);
      accumulate16<HD>(acc_v, ea, oc + j * ld, lane);   // dv += e^T dO_s
      accumulate16<HD>(acc_k, dsa, qc + j * ld, lane);  // dk += ds^T q
    }
    __syncthreads();
  }
  const long long ob = (long long)b * N * H * HD + h * HD;
  store_tile<HD>(ks + warp * 16 * ld, acc_k, dk + ob, H * HD, k0, N, lane);
  store_tile<HD>(vs + warp * 16 * ld, acc_v, dv + ob, H * HD, k0, N, lane);
}

// K2 dq, bf16. Grid (query blocks, H, B), tq warps: warp w owns the 16
// query rows (blockIdx.x * tq + w) * 16. Shared memory: the CTA's q and
// dO_s rows and their stats, then K and V (1 or 2 stages of 64 keys).
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dO,
            const float* __restrict__ m, const float* __restrict__ denom,
            const float* __restrict__ dd, bf16* __restrict__ dq, int N, int H,
            long long qsb, long long qsn, long long ksb, long long ksn,
            long long vsb, long long vsn, long long dsb, long long dsn) {
  constexpr int ld = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int np = (N + 15) & ~15;
  const int crows = min(kChunk, np), nch = (np + kChunk - 1) / kChunk;
  const int stages = nch > 1 ? 2 : 1;
  const int nwarps = blockDim.x >> 5, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int rc0 = blockIdx.x * nwarps * 16, r0 = rc0 + warp * 16;
  const int rows_cta = nwarps * 16;
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // rows_cta x ld
  bf16* os = qs + rows_cta * ld;                  // rows_cta x ld (dO_s)
  bf16* ks = os + rows_cta * ld;                  // stages x crows x ld
  bf16* vs = ks + stages * crows * ld;            // stages x crows x ld
  float* st = reinterpret_cast<float*>(vs + stages * crows * ld);  // 3 x rows_cta
  const bf16* kb = k + b * ksb + h * HD;
  const bf16* vb = v + b * vsb + h * HD;
  auto load_chunk = [&](int c) {
    const int rows = min(kChunk, np - c * kChunk), s = c & 1;
    cp_rows<HD>(ks + s * crows * ld, kb, ksn, c * kChunk, rows, N, tid, blockDim.x);
    cp_rows<HD>(vs + s * crows * ld, vb, vsn, c * kChunk, rows, N, tid, blockDim.x);
  };

  cp_rows<HD>(qs, q + b * qsb + h * HD, qsn, rc0, rows_cta, N, tid, blockDim.x);
  cp_rows<HD>(os, dO + b * dsb + h * HD, dsn, rc0, rows_cta, N, tid, blockDim.x);
  load_row_stats(st, rows_cta, m, denom, dd, (long long)b * N * H + h, H, rc0,
                 rows_cta, N);
  load_chunk(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  scale_rows<HD>(os, st + rows_cta, rows_cta);
  __syncthreads();

  unsigned qa[HD / 16][4], oa[HD / 16][4];
  load_a<HD>(qa, qs + warp * 16 * ld, lane);
  load_a<HD>(oa, os + warp * 16 * ld, lane);
  const float m0 = st[warp * 16 + g], m1 = st[warp * 16 + g + 8];
  const float dd0 = st[2 * rows_cta + warp * 16 + g];
  const float dd1 = st[2 * rows_cta + warp * 16 + g + 8];

  float acc[HD / 8][4];
  zero_acc<HD>(acc);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_chunk(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = c & 1, rows = min(kChunk, np - c * kChunk);
    const bf16* kc = ks + s * crows * ld;
    const bf16* vc = vs + s * crows * ld;
    for (int j = 0; j < rows; j += 16) {
      float sc[2][4], dp[2][4];
      scores16<HD>(sc, qa, kc + j * ld, lane);
      scores16<HD>(dp, oa, vc + j * ld, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool valid = c * kChunk + j + nt * 8 + 2 * t + (i & 1) < N;
          const float e = valid ? bf16_round(expf(sc[nt][i] - (i < 2 ? m0 : m1))) : 0.f;
          dp[nt][i] = bf16_round(e * (dp[nt][i] - (i < 2 ? dd0 : dd1)));
        }
      unsigned dsa[4];
      pack_a(dsa, dp);
      accumulate16<HD>(acc, dsa, kc + j * ld, lane);  // dq += ds k
    }
    __syncthreads();
  }
  store_tile<HD>(qs + warp * 16 * ld, acc, dq + (long long)b * N * H * HD + h * HD,
                 H * HD, r0, N, lane);
}

// How a launch covers N rows in 16-row warp tiles: `blocks` CTAs of `tiles`
// tiles each (at most kMaxWarps, balanced), and at N <= 16 up to 4 heads
// per CTA (`heads`, a divisor of H), one warp each.
struct Tiling {
  int blocks, tiles, heads;
};

Tiling tiling(int N, int H) {
  const int tiles = (N + 15) / 16;
  if (tiles == 1) {
    int hg = 4;
    while (H % hg) --hg;
    return {1, 1, hg};
  }
  const int blocks = (tiles + kMaxWarps - 1) / kMaxWarps;
  return {blocks, (tiles + blocks - 1) / blocks, 1};
}

enum MmaKernel { kFwd, kDkDv, kDq };

// the shared-memory layouts of the three bf16 kernels, in bytes
size_t mma_smem(MmaKernel kernel, int N, int hd, const Tiling& tl) {
  const int np = (N + 15) & ~15, crows = std::min(kChunk, np);
  const int stages = np > kChunk ? 2 : 1;
  const size_t row = sizeof(bf16) * (hd + kPad);
  const int warps = tl.tiles * tl.heads;
  if (kernel == kFwd)  // whole K, V chunks, q tiles
    return row * (tl.heads * np + stages * tl.heads * crows + warps * 16);
  if (kernel == kDkDv)  // K, V; q and dO_s chunks and their row stats
    return row * (2 * warps * 16 + 2 * stages * crows) + sizeof(float) * stages * 3 * crows;
  // q, dO_s and their row stats; K and V chunks
  return row * (2 * warps * 16 + 2 * stages * crows) + sizeof(float) * 3 * warps * 16;
}

template <int HD>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* m,
                   void* denom, int B, int N, int H, long long qsb, long long qsn,
                   long long ksb, long long ksn, long long vsb, long long vsn,
                   cudaStream_t stream) {
  const Tiling tl = tiling(N, H);
  const size_t smem = mma_smem(kFwd, N, HD, tl);
  cudaError_t err = allow_smem(attn_fwd_mma<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_mma<HD><<<dim3(tl.blocks, H / tl.heads, B), 32 * tl.tiles * tl.heads, smem,
                     stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                               (float*)m, (float*)denom, N, H, tl.heads, tl.tiles, qsb,
                               qsn, ksb, ksn, vsb, vsn);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* dO,
                   const void* m, const void* denom, const void* dd, void* dq,
                   void* dk, void* dv, int B, int N, int H, long long qsb,
                   long long qsn, long long ksb, long long ksn, long long vsb,
                   long long vsn, long long dsb, long long dsn, cudaStream_t stream) {
  const Tiling tl = tiling(N, 1);
  const size_t s1 = mma_smem(kDkDv, N, HD, tl), s2 = mma_smem(kDq, N, HD, tl);
  cudaError_t err = allow_smem(attn_dkdv_mma<HD>, s1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attn_dq_mma<HD>, s2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tl.blocks, H, B);
  attn_dkdv_mma<HD><<<grid, 32 * tl.tiles, s1, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)m,
      (const float*)denom, (const float*)dd, (bf16*)dk, (bf16*)dv, N, H, qsb, qsn, ksb,
      ksn, vsb, vsn, dsb, dsn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_dq_mma<HD><<<grid, 32 * tl.tiles, s2, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)m,
      (const float*)denom, (const float*)dd, (bf16*)dq, N, H, qsb, qsn, ksb, ksn, vsb,
      vsn, dsb, dsn);
  return (int)cudaGetLastError();
}

// the bf16 kernels are compiled for each head_dim of the gate (16..128)
#define BASD_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

}  // namespace

extern "C" int basd_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* m, void* denom, int B, int N,
                                  int H, int hd, long long qsb, long long qsn,
                                  long long ksb, long long ksn, long long vsb,
                                  long long vsn, int is_bf16, void* stream) {
  if (hd > kMaxHd || hd <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (!is_bf16)
    return launch_fwd(q, k, v, o, m, denom, B, N, H, hd, qsb, qsn, ksb,
                             ksn, vsb, vsn, s);
  switch (hd) {
#define BASD_FWD(HD)                                                          \
  case HD:                                                                    \
    return launch_fwd_mma<HD>(q, k, v, o, m, denom, B, N, H, qsb, qsn, ksb, ksn, \
                              vsb, vsn, s);
    BASD_HEAD_DIMS(BASD_FWD)
#undef BASD_FWD
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int basd_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* dO, const void* m,
                                  const void* denom, const void* dd, void* dq,
                                  void* dk, void* dv, int B, int N, int H,
                                  int hd, long long qsb, long long qsn,
                                  long long ksb, long long ksn, long long vsb,
                                  long long vsn, long long dsb, long long dsn,
                                  int is_bf16, void* stream) {
  if (hd > kMaxHd || hd <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (!is_bf16)
    return launch_bwd(q, k, v, dO, m, denom, dd, dq, dk, dv, B, N, H, hd,
                             qsb, qsn, ksb, ksn, vsb, vsn, dsb, dsn, s);
  switch (hd) {
#define BASD_BWD(HD)                                                          \
  case HD:                                                                    \
    return launch_bwd_mma<HD>(q, k, v, dO, m, denom, dd, dq, dk, dv, B, N, H,  \
                              qsb, qsn, ksb, ksn, vsb, vsn, dsb, dsn, s);
    BASD_HEAD_DIMS(BASD_BWD)
#undef BASD_BWD
  }
  return (int)cudaErrorInvalidValue;
}
