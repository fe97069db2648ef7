// Whole-row multi-head attention, forward (K1) and backward (K2), for the
// BASD ViTs on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fused_fwd_kernel` and
// `_fused_bwd_kernel` of basd_tpu/ops/attention.py and keeps their
// contract exactly:
//   * inputs in the native (B, N, D) layout with D = H * hd, heads major
//     (no transposes), q pre-scaled by hd^-0.5;
//   * scores s = q k^T accumulated in fp32, fp32 rowmax m;
//     e = exp(s - m) ROUNDED to the compute type, denom = fp32 sum of the
//     rounded e, o = (e v) / denom accumulated in fp32, stored in the
//     compute type; m and denom written as (B, N, H) fp32;
//   * backward from the saved (m, denom) and dd = rowsum(dO * O) per head
//     (computed outside): e recomputed, dO_s = round(dO / denom),
//     dv = e^T dO_s, ds = round(e * (dO_s v^T - dd / denom)),
//     dq = ds k, dk = ds^T q.
//
// What bounds it here: at the BASD shapes (N = 5..65 tokens, hd = 64) the
// work is a few MFLOP per (batch, head) and the bytes are the q/k/v/o
// slabs, so the card's limit is memory traffic plus launch latency; the
// (N, N) score tile never reaches device memory. Design: one CTA per
// (query or key block, head, batch) -- thousands of CTAs at the main-path
// shapes, enough to fill 132 SMs -- with the score rows of its block in
// shared memory as fp32 and the other operand streamed through shared
// memory in key chunks, so the whole `supports_fused` gate (N <= 512,
// hd <= 128) fits in the 227 KB a CTA may use. Products run on the fp32
// CUDA cores from bf16-rounded operands (exact products, fp32 sums); the
// tensor-core (wgmma) version is later work. The backward is two launches
// with no atomics: one per key block for dk and dv, one per query block
// for dq; both recompute e and ds with the same arithmetic, so they agree
// bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math: IEEE division and exp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an fp32 value to the compute type and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

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
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long sn, int r0, int rows,
                                          int max_rows, int hd) {
  for (int i = threadIdx.x; i < max_rows * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    dst[r * ld + c] = r < rows ? to_f<T>(src[(long long)(r0 + r) * sn + c]) : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int hd) {
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + b * qsb + h * hd;
  const T* kb = k + b * ksb + h * hd;
  const T* vb = v + b * vsb + h * hd;
  const int tid = threadIdx.x;

  load_tile<T>(qs, ld, qb, qsn, q0, rows, kFwdBq, hd);
  for (int k0 = 0; k0 < N; k0 += kFwdBk) {
    const int kn = min(kFwdBk, N - k0);
    __syncthreads();
    load_tile<T>(ch, ld, kb, ksn, k0, kn, kn, hd);
    __syncthreads();
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int r = i / kn, j = i - r * kn;
      S[r * N + k0 + j] = dot(qs + r * ld, ch + j * ld, hd);
    }
  }
  __syncthreads();

  // fp32 rowmax, e rounded to T, denom = fp32 sum of the rounded e
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = S + r * N;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = round_to<T>(expf(row[j] - mx));
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
    load_tile<T>(ch, ld, vb, vsn, k0, kn, kn, hd);
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
      o[((long long)b * N + q0 + r) * D + h * hd + c] = from_f<T>(acc[t] / rden[r]);
    }
  }
}

// --------------------------------------------------------------- backward

// Shared per-query-row state of the backward: q and the scaled dO rows as
// float tiles, and m, 1/denom, dd/denom per row.
template <typename T>
__device__ __forceinline__ void load_query_side(
    float* qs, float* dos, float* mrow, float* rdrow, float* ddrow, int ld,
    const T* qb, long long qsn, const T* db, long long dsn, const float* m,
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
  load_tile<T>(qs, ld, qb, qsn, r0, rows, max_rows, hd);
  __syncthreads();  // rdrow is read below
  for (int i = threadIdx.x; i < max_rows * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    dos[r * ld + c] = r < rows
        ? round_to<T>(to_f<T>(db[(long long)(r0 + r) * dsn + c]) * rdrow[r])
        : 0.f;
  }
}

// e and ds for one (query row, key) pair, identical in both launches
template <typename T>
__device__ __forceinline__ void e_and_ds(const float* qrow, const float* dorow,
                                         const float* krow, const float* vrow,
                                         float m, float ddr, int hd, float* e_out,
                                         float* ds_out) {
  const float e = round_to<T>(expf(dot(qrow, krow, hd) - m));
  const float dp = dot(dorow, vrow, hd);
  *e_out = e;
  *ds_out = round_to<T>(e * (dp - ddr));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ m, const float* __restrict__ denom,
                     const float* __restrict__ dd, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int H, int hd, long long qsb,
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
  const T* qb = q + b * qsb + h * hd;
  const T* kb = k + b * ksb + h * hd;
  const T* vb = v + b * vsb + h * hd;
  const T* db = dO + b * dsb + h * hd;
  const int tid = threadIdx.x;

  load_tile<T>(ks, ld, kb, ksn, k0, kn, kBwdBk, hd);
  load_tile<T>(vs, ld, vb, vsn, k0, kn, kBwdBk, hd);

  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc_k[t] = acc_v[t] = 0.f;

  for (int r0 = 0; r0 < N; r0 += kBwdBq) {
    const int rows = min(kBwdBq, N - r0);
    __syncthreads();
    load_query_side<T>(qs, dos, mrow, rdrow, ddrow, ld, qb, qsn, db, dsn, m,
                       denom, dd, b, h, N, H, r0, rows, kBwdBq, hd);
    __syncthreads();
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int r = i / kn, j = i - r * kn;
      e_and_ds<T>(qs + r * ld, dos + r * ld, ks + j * ld, vs + j * ld, mrow[r],
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
      dk[at] = from_f<T>(acc_k[t]);
      dv[at] = from_f<T>(acc_v[t]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dO,
                   const float* __restrict__ m, const float* __restrict__ denom,
                   const float* __restrict__ dd, T* __restrict__ dq, int N,
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
  const T* qb = q + b * qsb + h * hd;
  const T* kb = k + b * ksb + h * hd;
  const T* vb = v + b * vsb + h * hd;
  const T* db = dO + b * dsb + h * hd;
  const int tid = threadIdx.x;

  load_query_side<T>(qs, dos, mrow, rdrow, ddrow, ld, qb, qsn, db, dsn, m,
                     denom, dd, b, h, N, H, r0, rows, kDqBq, hd);

  float acc[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc[t] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kDqBk) {
    const int kn = min(kDqBk, N - k0);
    __syncthreads();
    load_tile<T>(ks, ld, kb, ksn, k0, kn, kn, hd);
    load_tile<T>(vs, ld, vb, vsn, k0, kn, kn, hd);
    __syncthreads();
    for (int i = tid; i < rows * kn; i += kThreads) {
      const int r = i / kn, j = i - r * kn;
      e_and_ds<T>(qs + r * ld, dos + r * ld, ks + j * ld, vs + j * ld, mrow[r],
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
      dq[((long long)b * N + r0 + r) * D + h * hd + c] = from_f<T>(acc[t]);
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

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* m,
               void* denom, int B, int N, int H, int hd, long long qsb,
               long long qsn, long long ksb, long long ksn, long long vsb,
               long long vsn, cudaStream_t stream) {
  const size_t smem = fwd_smem(N, hd);
  cudaError_t err = allow_smem(attn_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kFwdBq - 1) / kFwdBq, H, B);
  attn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)m, (float*)denom,
      N, H, hd, qsb, qsn, ksb, ksn, vsb, vsn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dO,
               const void* m, const void* denom, const void* dd, void* dq,
               void* dk, void* dv, int B, int N, int H, int hd, long long qsb,
               long long qsn, long long ksb, long long ksn, long long vsb,
               long long vsn, long long dsb, long long dsn,
               cudaStream_t stream) {
  const size_t s1 = dkdv_smem(hd), s2 = dq_smem(hd);
  cudaError_t err = allow_smem(attn_bwd_dkdv_kernel<T>, s1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attn_bwd_dq_kernel<T>, s2);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((N + kBwdBk - 1) / kBwdBk, H, B);
  attn_bwd_dkdv_kernel<T><<<g1, kThreads, s1, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, (const float*)m,
      (const float*)denom, (const float*)dd, (T*)dk, (T*)dv, N, H, hd, qsb,
      qsn, ksb, ksn, vsb, vsn, dsb, dsn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((N + kDqBq - 1) / kDqBq, H, B);
  attn_bwd_dq_kernel<T><<<g2, kThreads, s2, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, (const float*)m,
      (const float*)denom, (const float*)dd, (T*)dq, N, H, hd, qsb, qsn, ksb,
      ksn, vsb, vsn, dsb, dsn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int basd_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* m, void* denom, int B, int N,
                                  int H, int hd, long long qsb, long long qsn,
                                  long long ksb, long long ksn, long long vsb,
                                  long long vsn, int is_bf16, void* stream) {
  if (hd > kMaxHd || hd <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, o, m, denom, B, N, H, hd,
                                             qsb, qsn, ksb, ksn, vsb, vsn, s)
                 : launch_fwd<float>(q, k, v, o, m, denom, B, N, H, hd, qsb,
                                     qsn, ksb, ksn, vsb, vsn, s);
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
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(q, k, v, dO, m, denom, dd, dq, dk, dv,
                                         B, N, H, hd, qsb, qsn, ksb, ksn, vsb,
                                         vsn, dsb, dsn, s)
             : launch_bwd<float>(q, k, v, dO, m, denom, dd, dq, dk, dv, B, N, H,
                                 hd, qsb, qsn, ksb, ksn, vsb, vsn, dsb, dsn, s);
}
