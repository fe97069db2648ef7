// Axial 2-D rotary positions (DINOv3's RoPE) on the q and k of a packed
// qkv, in one pass: out_q = round(rot(q) * scale), out_k = round(rot(k)) on
// the patch rows, out_q = round(q * scale), out_k = k on the prefix rows
// (CLS and registers), for qkv rows (B * N, 3D) with q at [0, D) and k at
// [D, 2D) of each row, heads of hd major in D.
//
// rot is rotate_half's rotation of each head's two halves x1 | x2 (h2 =
// hd / 2 each) by the angles of the row's patch: x1 c - x2 s | x2 c + x1 s,
// where (c, s) is the row's entry of the table (patches, h2) of cos and sin
// (the same h2 angles serve both halves: the published layout tiles them
// twice). Every product, sum and difference is rounded to fp32 on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: no contraction into an FMA) in the
// order the plain version's torch ops round them
// (`ops/rope.py:rope_qk_plain`), and the result is rounded once to the
// output dtype, so the kernel gives the plain version's bits.
//
// One CTA a token row. Route "vec": each thread moves 16 bytes of x1, 16 of
// x2 of q and of k a step (8 bf16 or 4 fp32 values of one head's half),
// where h2 is a multiple of that width and every pointer and row stride is
// 16-byte aligned. Route "scalar": the same loop one value at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// the rotated pair (x1, x2) -> (x1 c - x2 s, x2 c + x1 s), each op rounded
__device__ __forceinline__ void rotate(float x1, float x2, float c, float s, float* o1,
                                       float* o2) {
  *o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  *o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

// kPer consecutive values, aligned to their whole width (one 16-byte
// vector on the vec route)
template <typename T, int kPer>
struct alignas(sizeof(T) * kPer) Chunk {
  T v[kPer];
};

template <typename T, int kPer>
__device__ __forceinline__ void rope_chunk(const T* q1, const T* q2, const T* k1, const T* k2,
                                           const float* cs, const float* sn, T* oq1, T* oq2,
                                           T* ok1, T* ok2, float scale, bool patch) {
  using C = Chunk<T, kPer>;
  const C a1 = *reinterpret_cast<const C*>(q1);
  const C a2 = *reinterpret_cast<const C*>(q2);
  const C b1 = *reinterpret_cast<const C*>(k1);
  const C b2 = *reinterpret_cast<const C*>(k2);
  C r1, r2, s1, s2;
  if (patch) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float c = cs[i], s = sn[i];
      float u1, u2, w1, w2;
      rotate(to_float(a1.v[i]), to_float(a2.v[i]), c, s, &u1, &u2);
      rotate(to_float(b1.v[i]), to_float(b2.v[i]), c, s, &w1, &w2);
      r1.v[i] = from_float<T>(__fmul_rn(u1, scale));
      r2.v[i] = from_float<T>(__fmul_rn(u2, scale));
      s1.v[i] = from_float<T>(w1);
      s2.v[i] = from_float<T>(w2);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      r1.v[i] = from_float<T>(__fmul_rn(to_float(a1.v[i]), scale));
      r2.v[i] = from_float<T>(__fmul_rn(to_float(a2.v[i]), scale));
    }
    s1 = b1;
    s2 = b2;
  }
  *reinterpret_cast<C*>(oq1) = r1;
  *reinterpret_cast<C*>(oq2) = r2;
  *reinterpret_cast<C*>(ok1) = s1;
  *reinterpret_cast<C*>(ok2) = s2;
}

// one CTA a row of qkv (3D wide); kPer values of a half a thread a step
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
rope_qk_kernel(const T* __restrict__ qkv, const float* __restrict__ table, T* __restrict__ oq,
               T* __restrict__ ok, int n, int prefix, int patches, int D, int hd, float scale) {
  const long long row = blockIdx.x;
  const int tok = static_cast<int>(row % n) - prefix;
  const bool patch = tok >= 0;
  const int h2 = hd / 2;
  const int per_head = h2 / kPer;
  const T* q = qkv + row * 3 * D;
  const T* k = q + D;
  T* orow_q = oq + row * D;
  T* orow_k = ok + row * D;
  const float* cos_row = table + (patch ? tok : 0) * h2;
  const float* sin_row = cos_row + static_cast<long long>(patches) * h2;
  for (int v = threadIdx.x; v < D / (2 * kPer); v += kThreads) {
    const int head = v / per_head;
    const int j = (v - head * per_head) * kPer;
    const int at1 = head * hd + j, at2 = at1 + h2;
    rope_chunk<T, kPer>(q + at1, q + at2, k + at1, k + at2, cos_row + j, sin_row + j,
                        orow_q + at1, orow_q + at2, orow_k + at1, orow_k + at2, scale, patch);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* qkv, const float* table, void* oq, void* ok, long long rows, int n,
           int prefix, int heads, int hd, float scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int D = heads * hd;
  const int patches = n - prefix;
  const bool vec = (hd / 2) % kVec == 0 && (D * sizeof(T)) % 16 == 0 && aligned16(qkv) &&
                   aligned16(oq) && aligned16(ok);
  const unsigned grid = static_cast<unsigned>(rows);
  if (vec) {
    rope_qk_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(qkv), table, static_cast<T*>(oq), static_cast<T*>(ok), n, prefix,
        patches, D, hd, scale);
  } else {
    rope_qk_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(qkv), table, static_cast<T*>(oq), static_cast<T*>(ok), n, prefix,
        patches, D, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv (rows, 3 heads hd) contiguous, rows = B N; table (2, N - prefix,
// hd / 2) fp32, cos then sin; q_out and k_out (rows, heads hd) contiguous;
// is_bf16 picks bf16, else fp32. Returns the launch's cudaGetLastError.
int basd_rope_qk(const void* qkv, const float* table, void* q_out, void* k_out,
                 long long rows, int n, int prefix, int heads, int hd, float scale,
                 int is_bf16, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL || n <= 0 || prefix < 0 || prefix >= n || heads <= 0 || hd <= 0 ||
      hd % 2 || rows % n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(qkv, table, q_out, k_out, rows, n, prefix, heads, hd,
                                         scale, s)
                 : launch<float>(qkv, table, q_out, k_out, rows, n, prefix, heads, hd, scale,
                                 s);
}
}  // extern "C"
