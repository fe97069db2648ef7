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
// The first (variant `kMaxPass`) computes each CTA's scores and writes
// their max to a (B, H, query blocks) scratch; the second reduces the
// group's maxima (group x query blocks floats) and runs the variant.
//
// What bounds it here: 4 B H N^2 hd flops (51.9 GFLOP at the teacher's
// (256, 12, 257, 64)) against 404 MB of q, k, v and o, so by the card's
// peaks the bytes bound it (0.121 ms against 0.053 ms of bf16 tensor-core
// time). Both products run on the tensor cores, as K1's do
// (csrc/attention.cu, whose pieces are copied here: each library is one
// source file): mma.sync m16n8k16 with bf16 operands and fp32 sums, fed by
// ldmatrix (v through ldmatrix.trans), operands moved by 16-byte cp.async
// into bf16 shared memory with rows padded by 8 elements (conflict-free
// ldmatrix). One CTA per (64 query rows, head, sequence), 4 warps of 16
// query rows, any 1 <= N <= 1024, laid out as K1's bf16 forward route
// (b): the head's whole k in shared memory (147 KB at N = 1024) and v
// streamed in double-buffered 64-key chunks. A first pass over the keys
// takes the row max (full, bf16exp) or the CTA's max (the tilemax first
// launch); a second recomputes s with the same instructions on the same
// operands (so the same bits), packs e straight into the bf16 A fragments
// of the e v product (the m16n8k16 C layout of two n8 tiles is the A
// layout of one k16 step; mxonly packs the accumulators themselves) and
// goes on to e v. 80 registers a thread and 66.8 KB of shared memory at
// N = 257 let three CTAs share an SM.
// Keys past N get e = 0 and are left out of every max; rows past N are
// never stored. The sums of s run in another order than a cuBLAS fp32
// product's, so a bf16 e may land on the neighbouring value of the plain
// version's: chip_smoke.py holds each output within one bf16 ulp of its
// row's max |o|.
//
// Measured on an H100 (80GB HBM3, 700 W; PERF.md §6, chip_smoke.py), device
// ms at (256, 12, 257, 64) against a 0.1207 ms bound (bytes): full 0.6625,
// tilemax 0.9070, nomax 0.5630, bf16exp 0.7168, noexp 0.3391, mxonly 0.2905
// (the CUDA-core kernel it replaces: 3.97-6.86). Holding a warp's 16 x 272
// scores in its accumulators instead (one pass over the keys, 164-212
// registers a thread, two CTAs an SM) read slower for four of the six
// variants (full 0.7859) and was dropped.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math: IEEE exp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;          // head_dim of every BASD ViT attention
constexpr int kPad = 8;         // bf16 of row padding (ldmatrix without conflicts)
constexpr int LD = HD + kPad;   // shared-memory row stride, in bf16
constexpr int kWarps = 4;       // 16-row warp tiles per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kBq = 16 * kWarps;  // query rows per CTA
constexpr int kChunk = 64;      // keys per v chunk
constexpr int kMaxN = 1024;
constexpr int kMaxSharedBytes = 232448;

enum Variant {
  kFull = 0, kTileMax = 1, kNoMax = 2, kBf16Exp = 3, kNoExp = 4, kMxOnly = 5,
  kMaxPass = 6,
};

// ---- pieces of csrc/attention.cu's bf16 kernels ----

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

// ldmatrix row addresses, as offsets into a tile of stride ld: A fragments
// and the trans-loaded B fragments of two n8 tiles share one pattern, the
// B fragments of two n8 tiles from rows stored n-major (k for s = q k^T)
// take another
__device__ __forceinline__ int frag_a_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int frag_b_off(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// the A fragments of a 16 x HD tile
__device__ __forceinline__ void load_a(unsigned (&a)[HD / 16][4], const bf16* tile, int lane) {
  const bf16* p = tile + frag_a_off(lane, LD);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// s = q rows^T for 16 rows of a (., HD) tile: two n8 tiles of keys
__device__ __forceinline__ void scores16(float (&s)[2][4], const unsigned (&a)[HD / 16][4],
                                         const bf16* rows, int lane) {
  const bf16* p = rows + frag_b_off(lane, LD);
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
__device__ __forceinline__ void accumulate16(float (&acc)[HD / 8][4], const unsigned (&p)[4],
                                             const bf16* rows, int lane) {
  const bf16* src = rows + frag_a_off(lane, LD);
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    unsigned b[4];
    ldsm_x4_trans(b, src + j * 16);
    mma16816(acc[2 * j], p, b[0], b[1]);
    mma16816(acc[2 * j + 1], p, b[2], b[3]);
  }
}

// the A fragment of a 16 x 16 block from the accumulators of its two n8
// tiles, each rounded to bf16
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

// rows [r0, r0 + rows) of one head's contiguous (N, HD) slab into a bf16
// tile of stride LD by 16-byte cp.async, thread `tid` of `nthreads`; rows
// at or past n are zero-filled
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int r0, int rows, int n,
                                        int tid, int nthreads) {
  constexpr int kVec = HD / 8;
  for (int i = tid; i < rows * kVec; i += nthreads) {
    const int r = i / kVec, c = i - r * kVec;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * LD + c * 8, ok ? src + (long long)(r0 + r) * HD + c * 8 : src, ok);
  }
}

// a warp's 16 x HD fp32 tile, rounded to bf16, to rows [r0, r0 + 16) of one
// head's (N, HD) slab (rows at or past n dropped), staged through the
// warp's own smem tile for 16-byte stores
__device__ __forceinline__ void store_tile(bf16* stage, const float (&acc)[HD / 8][4],
                                           bf16* dst, int r0, int n, int lane) {
  constexpr int kVec = HD / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    *reinterpret_cast<unsigned*>(stage + g * LD + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * LD + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = i / kVec, c = i - r * kVec;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

// ---- the probe ----

// e of one score s, m the row max (full, bf16exp) or the tile max (tilemax)
template <int kVariant>
__device__ __forceinline__ float probe_e(float s, float m) {
  if constexpr (kVariant == kFull || kVariant == kTileMax) return bf16_round(expf(s - m));
  if constexpr (kVariant == kNoMax) return bf16_round(expf(s));
  if constexpr (kVariant == kBf16Exp) return bf16_round(expf(bf16_round(s - m)));
  return bf16_round(s);  // kNoExp
}

__host__ __device__ constexpr bool needs_row_max(int variant) { return variant == kFull || variant == kBf16Exp; }

// the A fragment of e for one 16-key tile of scores (keys from key0; row
// maxima m0, m1 of rows g and g + 8): e of each valid key, 0 past N;
// mxonly packs the scores themselves (its keys past N score exactly 0,
// since their k rows are zero-filled)
template <int kVariant>
__device__ __forceinline__ void e_fragment(unsigned (&ea)[4], float (&s)[2][4], int key0,
                                           int N, int t, float m0, float m1) {
  if constexpr (kVariant != kMxOnly) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[nt][i] = key0 + nt * 8 + 2 * t + (i & 1) < N ? probe_e<kVariant>(s[nt][i], i < 2 ? m0 : m1)
                                                       : 0.f;
  }
  pack_a(ea, s);
}

// the max of one 16-key tile's scores over valid keys, for rows g (x0) and
// g + 8 (x1)
__device__ __forceinline__ void tile_row_max(const float (&s)[2][4], int key0, int N, int t,
                                             float& x0, float& x1) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (key0 + nt * 8 + 2 * t + j < N) {
        x0 = fmaxf(x0, s[nt][j]);
        x1 = fmaxf(x1, s[nt][2 + j]);
      }
}

// the tilemax first launch: the CTA's max over its valid rows (warp tile
// rows g, g + 8 from q0) to tile_max[(b, h, query block)]
__device__ __forceinline__ void write_cta_max(float x0, float x1, int q0, int g, int N,
                                              float* red, float* tile_max, long long at) {
  float mx = fmaxf(q0 + g < N ? x0 : -INFINITY, q0 + g + 8 < N ? x1 : -INFINITY);
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
    tile_max[at] = mx;
  }
}

// the max over the group's tile maxima, M of tilemax's second launch
__device__ __forceinline__ float group_max(const float* tile_max, int b, int h, int H,
                                           int nqb, int group) {
  const int b0 = b / group * group;
  float m = -INFINITY;
  for (int bb = b0; bb < b0 + group; ++bb)
    for (int t = 0; t < nqb; ++t) m = fmaxf(m, tile_max[((long long)bb * H + h) * nqb + t]);
  return m;
}

// Grid (query blocks of kBq rows, H, B), kWarps warps: warp w owns the 16
// query rows blockIdx.x * kBq + 16 w. Shared memory: k (N rows padded to
// 16), v (two kChunk-row stages), one q tile per warp (later its output
// staging). Pass 1 takes the maxima, pass 2 s again, e and e v by chunks.
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
attn_probe_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ tile_max, int H, int N, int group) {
  extern __shared__ __align__(16) unsigned char smem_probe[];
  __shared__ float red[kWarps];
  const int nqb = gridDim.x, qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = (N + 15) & ~15;  // keys padded to the mma's k step
  const int nch = (np + kChunk - 1) / kChunk;
  const int q0 = qb * kBq + warp * 16;
  const long long head = ((long long)b * H + h) * N * HD;
  const long long at = ((long long)b * H + h) * nqb + qb;
  bf16* ks = reinterpret_cast<bf16*>(smem_probe);
  bf16* vs = ks + np * LD;
  bf16* qs = vs + 2 * kChunk * LD + warp * 16 * LD;
  auto load_v = [&](int c) {  // chunk c into stage c & 1
    cp_rows(vs + (c & 1) * kChunk * LD, v + head, c * kChunk, min(kChunk, np - c * kChunk), N,
            tid, kThreads);
  };

  // k and the warps' q tiles first, then v's first chunk
  cp_rows(ks, k + head, 0, np, N, tid, kThreads);
  cp_rows(qs, q + head, q0, 16, N, lane, 32);
  cp_async_commit();
  if (kVariant != kMaxPass) load_v(0);
  cp_async_commit();
  const float tmax = kVariant == kTileMax ? group_max(tile_max, b, h, H, nqb, group) : 0.f;
  cp_async_wait<1>();
  __syncthreads();

  unsigned qa[HD / 16][4];
  load_a(qa, qs, lane);
  float m0 = tmax, m1 = tmax;
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  if constexpr (kVariant == kMaxPass || needs_row_max(kVariant)) {
    float x0 = -INFINITY, x1 = -INFINITY;
    for (int kb = 0; kb < np; kb += 16) {
      float s[2][4];
      scores16(s, qa, ks + kb * LD, lane);
      tile_row_max(s, kb, N, t, x0, x1);
    }
    if constexpr (kVariant == kMaxPass) {
      write_cta_max(x0, x1, q0, g, N, red, tile_max, at);
      return;
    }
    m0 = quad_max(x0);
    m1 = quad_max(x1);
  }
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_v(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* vw = vs + (c & 1) * kChunk * LD;
    const int rows = min(kChunk, np - c * kChunk);
    if (q0 < N)
      for (int j = 0; j < rows; j += 16) {
        float s[2][4];
        scores16(s, qa, ks + (c * kChunk + j) * LD, lane);
        unsigned ea[4];
        e_fragment<kVariant>(ea, s, c * kChunk + j, N, t, m0, m1);
        accumulate16(acc, ea, vw + j * LD, lane);
      }
    __syncthreads();
  }
  store_tile(qs, acc, o + head, q0, N, lane);
}

size_t smem_bytes(int n) {
  const size_t np = (n + 15) & ~15;
  return sizeof(bf16) * (np + 2 * kChunk + kBq) * LD;
}

template <int kVariant>
int launch_one(const void* q, const void* k, const void* v, void* o, void* tile_max, int B,
               int H, int N, int group, void* stream) {
  const size_t smem = smem_bytes(N);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_probe_mma<kVariant>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kBq - 1) / kBq, H, B);
  attn_probe_mma<kVariant><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)tile_max, H, N, group);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of variant `variant` (0..5 as in the enum above; 6 is the
// tilemax first launch, which writes `tile_max` (B, H, ceil(N / 64)) and
// not `o`). q, k, v, o are contiguous (B, H, N, 64) bf16, 16-byte aligned,
// 1 <= N <= 1024.
extern "C" int basd_attn_probe(const void* q, const void* k, const void* v, void* o,
                               void* tile_max, int B, int H, int N, int hd, int group,
                               int variant, void* stream) {
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
