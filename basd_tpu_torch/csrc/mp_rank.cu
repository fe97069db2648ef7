// Marchenko-Pastur rank of a batch of symmetric fp32 Grams in one launch,
// for the BASD selector on Hopper (sm_90a): Householder reduction to
// tridiagonal form, then multi-shift Sturm bisection of the two middle
// eigenvalues and one count above lambda_+.
//
// Replaces no TPU kernel. The JAX package writes the MP rank as
// `lax.fori_loop`s (basd_tpu/spectral/tridiag.py) that XLA compiles into
// the step's one program; the port's plain version,
// basd_tpu_torch/spectral/tridiag.py:mp_rank_sturm, runs each iteration of
// those loops as a chain of PyTorch kernels, about 15,000 at (12, 192, 192)
// and 30,000 at (24, 384, 384) a call, each too small for the card. This
// kernel runs the same sequence of operations, with the same arithmetic:
//   1. cov = gram / m, symmetrised as (cov + cov^T) * 0.5
//      (`marchenko_pastur_rank_gram`; `householder_tridiag`'s second
//      symmetrisation leaves a symmetric matrix unchanged);
//   2. for k = 0 .. n - 3 the reflector of column k: x its entries below
//      the diagonal, alpha = -sign(x_{k+1}) |x| (sign +1 at 0),
//      v = x - alpha e_{k+1}, tau = 2 / v^T v (0 where v^T v = 0),
//      p = tau A v, k2 = 0.5 tau p^T v, u = p - k2 v and the symmetric
//      rank-2 update A <- (A - v u^T) - u v^T, element by element as the
//      plain version's three torch ops round it, on the full (not
//      symmetric-packed) matrix;
//   3. the multi-shift bracket of the eigenvalues of order (n - 1) / 2 and
//      n / 2: the Gershgorin interval widened by 1% and 1e-30, 128 shifts
//      at (s + 1) / 129 of it, 7 rounds (the JAX package runs 3, which
//      leave the bracket 5e-7 of the span wide: far wider than the
//      median's fp32 spacing where the top eigenvalue lies 1e3 times the
//      median or more, as an uncentered Gram's does; 129^7 = 2^49 reaches
//      that spacing up to 2^26 times); each shift's count from the LDL^T
//      recurrence d_i = (a_i - x) - b_{i-1}^2 / d_{i-1}, |d| kept at least
//      sqrt(fp32 tiny) * max|a_i|, sign kept;
//   4. sigma^2 the mean of the two, lambda_+ = sigma^2 (1 + sqrt(n / m))^2
//      (the factor computed by the wrapper in float64 and rounded once, as
//      torch rounds a Python scalar), rank = n - count(lambda_+).
// fp32 throughout; elementwise formulas rounded op by op (__fmul_rn,
// __fadd_rn, __fsub_rn, IEEE __fdiv_rn and __fsqrt_rn, no FMA contraction),
// so only the order of the sums (x^T x, A v, p^T v) differs from the plain
// version's reductions. Besides the (B,) int32 ranks it writes the
// tridiagonal's diagonal (B, n) and squared off-diagonal (B, n - 1).
//
// What bounds it here: neither bytes (one read of the Gram: 0.53 us at
// (12, 192, 192) at 3.35 TB/s) nor FLOPs (4/3 n^3 a matrix, A v and the
// symmetric update of one triangle: 1.7 us at 67 TFLOP/s fp32), but the
// chain of n - 2 dependent reflector steps and then 8 dependent Sturm
// passes of n steps, each reflector step behind two barriers, its work a
// few hundred dependent shared-memory accesses a warp. So the design keeps each matrix
// on chip for the whole reduction and a step's barriers to two:
//   * the matrix lives in shared memory, rows dealt round-robin over a
//     thread-block cluster of C CTAs (row i in CTA i % C; the wrapper picks
//     the least power of two whose slice fits: C = 1 to n = 238, 4 at
//     n = 384, 8 to n = 659, basd_tpu_torch/spectral/mp_rank_kernel.py:
//     cluster_size), so every CTA keeps a share of the shrinking trailing
//     block;
//   * every CTA holds the whole column x (double-buffered by the parity of
//     k) and the whole p; a CTA's rows' entries reach the others through
//     distributed shared memory, each writer storing into every CTA, so
//     each exchange costs one cluster barrier and no reads across SMs;
//   * the step's scalars (|x|^2, tau, p^T v) are reduced again by every
//     warp of every CTA from those copies, in one fixed order, so all
//     threads hold the same bits without a barrier to broadcast them;
//   * a warp takes four rows at once, its lanes over the columns j > k
//     (consecutive addresses: no bank conflicts), so u_j and v_j are
//     loaded once per four entries; the lane that updates column k + 1
//     hands the next step's x (or the next diagonal entry) to the others;
//   * the Sturm phase runs in CTA 0 once the diagonal and off-diagonal
//     are in its shared memory: one thread per shift (2 x 128), each round
//     a block reduction of the new bracket.
// One launch per call: grid (batch * C), 512 threads, one CTA per SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;               // rows a warp updates at once
constexpr int kShifts = 128;
constexpr int kRounds = 7;  // spectral/tridiag.py:BRACKET_ROUNDS
constexpr int kMinN = 8;
constexpr size_t kSmemLimit = 232448;   // a CTA's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;
// sqrt(1.1754944e-38) rounded to fp32, as torch rounds the plain version's
// Python scalar
constexpr float kSqrtTiny = 1.0842021724855044e-19f;

constexpr int kScratch = 96;             // floats of the reductions' scratch

// floats of shared memory a CTA uses: its rows of A, x twice, p, the
// diagonal, b^2 and the reductions' scratch
__host__ __device__ size_t smem_floats(int n, int c) {
  const size_t rows = (size_t)(n + c - 1) / c;
  return rows * n + 5 * (size_t)n + kScratch;
}

template <int kC>
__device__ __forceinline__ void sync_all() {
  if constexpr (kC == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// a butterfly sum: every lane ends with the same bits (fp addition
// commutes), so warps that reduce the same values agree
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

__device__ __forceinline__ float warp_max(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s = fmaxf(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

__device__ __forceinline__ float warp_min(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s = fminf(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// #eigenvalues < x of the tridiagonal (dg, b2), b2[0] = 0: `sturm_count`
__device__ int sturm_count(const float* dg, const float* b2, int n, float x, float dmin) {
  float d = 1.0f;
  int count = 0;
  for (int i = 0; i < n; ++i) {
    const float t = __fsub_rn(__fsub_rn(dg[i], x), __fdiv_rn(b2[i], d));
    const float m = fabsf(t);
    const float safe = m != m ? m : fmaxf(m, dmin);  // torch.maximum keeps NaN
    d = t >= 0.0f ? safe : -safe;
    count += d < 0.0f;
  }
  return count;
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
mp_rank_kernel(const float* __restrict__ gram, int* __restrict__ ranks,
               float* __restrict__ diag_out, float* __restrict__ off2_out, int n, float m,
               float edge) {
  extern __shared__ __align__(16) float smem[];
  const int rows = (n + kC - 1) / kC;
  float* a = smem;                      // local row r is row r * kC + c
  float* xbuf = a + (size_t)rows * n;   // x of step k at (k & 1) * n
  float* pbuf = xbuf + 2 * n;
  float* dg = pbuf + n;                 // the diagonal (CTA 0's is read)
  float* b2 = dg + n;                   // b2[i] = off[i - 1]^2, b2[0] = 0
  float* red = b2 + n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c = 0;
  // lane q < kC holds CTA q's copies of x and p, every lane CTA 0's
  // diagonal and b2: a warp stores a value into every CTA at once
  float* q_x = xbuf;
  float* q_p = pbuf;
  float* dg0 = dg;
  float* b20 = b2;
  if constexpr (kC > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    c = (int)cluster.block_rank();
    const int q = lane < kC ? lane : 0;
    q_x = cluster.map_shared_rank(xbuf, q);
    q_p = cluster.map_shared_rank(pbuf, q);
    dg0 = cluster.map_shared_rank(dg, 0);
    b20 = cluster.map_shared_rank(b2, 0);
    cluster.sync();  // every CTA has started before the first remote store
  }
  const int b = blockIdx.x / kC;
  const int my_rows = (n - c + kC - 1) / kC;  // local rows with r * kC + c < n
  const float* g = gram + (size_t)b * n * n;
  float* diag_b = diag_out + (size_t)b * n;
  float* off2_b = off2_out + (size_t)b * (n - 1);
  auto put = [&](float* q_base, int i, float value) {  // warp-uniform value
    if (lane < kC) q_base[i] = value;
  };

  // 1. A = ((g / m) + (g^T / m)) * 0.5; column 0 becomes step 0's x
  for (int r = warp; r < my_rows; r += kWarps) {
    const int i = r * kC + c;
    float first = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float y = __fmul_rn(
          __fadd_rn(__fdiv_rn(g[(size_t)i * n + j], m), __fdiv_rn(g[(size_t)j * n + i], m)),
          0.5f);
      a[(size_t)r * n + j] = y;
      if (j == 0) first = y;
    }
    first = __shfl_sync(kFull, first, 0);
    if (i == 0) {
      if (lane == 0) {
        dg[0] = first;  // CTA 0 owns row 0
        b2[0] = 0.0f;
        diag_b[0] = first;
      }
    } else {
      put(q_x, i, first);
    }
  }
  sync_all<kC>();

  // 2. the n - 2 reflector steps
  for (int k = 0; k < n - 2; ++k) {
    const float* x = xbuf + (k & 1) * n;
    const int next = ((k + 1) & 1) * n;
    const int j0 = k + 1;
    // the step's scalars, in every warp
    float s = 0.0f;
    for (int i = k + 2 + lane; i < n; i += 32) s = __fadd_rn(s, __fmul_rn(x[i], x[i]));
    s = warp_sum(s);
    const float head = x[j0];
    const float xnorm = __fsqrt_rn(__fadd_rn(s, __fmul_rn(head, head)));
    const float alpha = (head >= 0.0f ? -1.0f : 1.0f) * xnorm;
    const float vk1 = __fsub_rn(head, alpha);  // v_{k+1}; v_i = x_i below it
    const float vtv = __fadd_rn(s, __fmul_rn(vk1, vk1));
    const float tau = vtv > 0.0f ? __fdiv_rn(2.0f, vtv) : 0.0f;

    // p_i = tau (A v)_i for the rows i >= k (row k gives u_k, the
    // off-diagonal's)
    const int r_p = k > c ? (k - c + kC - 1) / kC : 0;
    for (int rb = r_p + warp * kGroup; rb < my_rows; rb += kWarps * kGroup) {
      float acc[kGroup] = {};
      for (int j = j0 + lane; j < n; j += 32) {
        const float vj = j == j0 ? vk1 : x[j];
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (rb + q < my_rows) acc[q] = fmaf(a[(size_t)(rb + q) * n + j], vj, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) acc[q] = warp_sum(acc[q]);
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (rb + q < my_rows) put(q_p, (rb + q) * kC + c, __fmul_rn(tau, acc[q]));
    }
    sync_all<kC>();

    // k2 = 0.5 tau p^T v, in every warp
    float t = 0.0f;
    for (int i = j0 + lane; i < n; i += 32)
      t = __fadd_rn(t, __fmul_rn(pbuf[i], i == j0 ? vk1 : x[i]));
    t = warp_sum(t);
    const float k2 = __fmul_rn(__fmul_rn(0.5f, tau), t);

    // A <- (A - v u^T) - u v^T on the rows and columns > k
    const int r_u = j0 > c ? (j0 - c + kC - 1) / kC : 0;
    for (int rb = r_u + warp * kGroup; rb < my_rows; rb += kWarps * kGroup) {
      float vi[kGroup], ui[kGroup], first[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const int i = min(rb + q, my_rows - 1) * kC + c;
        vi[q] = i == j0 ? vk1 : x[i];
        ui[q] = __fsub_rn(pbuf[i], __fmul_rn(k2, vi[q]));
        first[q] = 0.0f;
      }
      for (int j = j0 + lane; j < n; j += 32) {
        const float vj = j == j0 ? vk1 : x[j];
        const float uj = __fsub_rn(pbuf[j], __fmul_rn(k2, vj));
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (rb + q < my_rows) {
            float* e = a + (size_t)(rb + q) * n + j;
            const float y = __fsub_rn(__fsub_rn(*e, __fmul_rn(vi[q], uj)), __fmul_rn(ui[q], vj));
            *e = y;
            if (j == j0) first[q] = y;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (rb + q < my_rows) {
          const int i = (rb + q) * kC + c;
          const float y = __shfl_sync(kFull, first[q], 0);  // A[i][k + 1]
          if (i == j0) {
            if (lane == 0) {
              dg0[j0] = y;  // final: later steps leave row and column k + 1
              diag_b[j0] = y;
            }
          } else {
            put(q_x + next, i, y);
          }
        }
      }
    }
    // off[k] = A[k + 1][k], updated as the plain version updates it
    // (v_k = 0, u_k = p_k); nothing else reads column k again
    if (threadIdx.x == 0 && j0 % kC == c) {
      const float uk = __fsub_rn(pbuf[k], __fmul_rn(k2, 0.0f));
      const float uk1 = __fsub_rn(pbuf[j0], __fmul_rn(k2, vk1));
      const float off = __fsub_rn(
          __fsub_rn(a[(size_t)(j0 / kC) * n + k], __fmul_rn(vk1, uk)), __fmul_rn(uk1, 0.0f));
      const float o2 = __fmul_rn(off, off);
      b20[j0] = o2;
      off2_b[k] = o2;
    }
    sync_all<kC>();
  }
  // the last row's diagonal and off-diagonal, final after step n - 3
  if (threadIdx.x == 0 && (n - 1) % kC == c) {
    const float* row = a + (size_t)((n - 1) / kC) * n;
    const float o2 = __fmul_rn(row[n - 2], row[n - 2]);
    dg0[n - 1] = row[n - 1];
    b20[n - 1] = o2;
    diag_b[n - 1] = row[n - 1];
    off2_b[n - 2] = o2;
  }
  sync_all<kC>();
  if (c != 0) return;

  // 3. CTA 0: scale and Gershgorin bounds (`sturm_count`, `_kth_pair_bracket`)
  float mx = 0.0f, lo = __int_as_float(0x7f800000), hi = -lo;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d = dg[i];
    const float r_left = i > 0 ? fabsf(__fsqrt_rn(b2[i])) : 0.0f;       // r_{i-1}
    const float r_right = i < n - 1 ? fabsf(__fsqrt_rn(b2[i + 1])) : 0.0f;  // r_i
    const float radius = __fadd_rn(r_right, r_left);
    mx = fmaxf(mx, fabsf(d));
    lo = fminf(lo, __fsub_rn(d, radius));
    hi = fmaxf(hi, __fadd_rn(d, radius));
  }
  mx = warp_max(mx);
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    red[warp] = mx;
    red[kWarps + warp] = lo;
    red[2 * kWarps + warp] = hi;
  }
  __syncthreads();
  mx = red[0];
  lo = red[kWarps];
  hi = red[2 * kWarps];
  for (int w = 1; w < kWarps; ++w) {
    mx = fmaxf(mx, red[w]);
    lo = fminf(lo, red[kWarps + w]);
    hi = fmaxf(hi, red[2 * kWarps + w]);
  }
  const float dmin = __fmul_rn(kSqrtTiny, fmaxf(mx, 1e-30f));
  const float span = __fsub_rn(hi, lo);
  lo = __fsub_rn(__fsub_rn(lo, __fmul_rn(0.01f, span)), 1e-30f);
  hi = __fadd_rn(__fadd_rn(hi, __fmul_rn(0.01f, span)), 1e-30f);

  // the bracket of the middle pair: thread t < 256 is shift t % 128 of
  // order statistic t / 128 (group 0 the lower), four warps a group
  float lo0 = lo, hi0 = hi, lo1 = lo, hi1 = hi;
  const bool upper = (threadIdx.x / kShifts) & 1;
  const int order = upper ? n / 2 : (n - 1) / 2;
  const float grid = __fdiv_rn((float)(threadIdx.x % kShifts) + 1.0f, (float)kShifts + 1.0f);
  constexpr int kGroupWarps = kShifts / 32;
  for (int rnd = 0; rnd < kRounds; ++rnd) {
    // 4 kGroupWarps floats a round, by the round's parity: a thread still
    // reading one round's never meets the next round's stores
    float* part = red + 3 * kWarps + 4 * kGroupWarps * (rnd & 1);
    if (threadIdx.x < 2 * kShifts) {
      const float l = upper ? lo1 : lo0, h = upper ? hi1 : hi0;
      const float x = __fadd_rn(l, __fmul_rn(__fsub_rn(h, l), grid));
      const bool le = sturm_count(dg, b2, n, x, dmin) <= order;
      const float lo_c = warp_max(le ? x : l);
      const float hi_c = warp_min(le ? h : x);
      if (lane == 0) {
        part[warp] = lo_c;
        part[2 * kGroupWarps + warp] = hi_c;
      }
    }
    __syncthreads();
    lo0 = part[0];
    lo1 = part[kGroupWarps];
    hi0 = part[2 * kGroupWarps];
    hi1 = part[3 * kGroupWarps];
    for (int w = 1; w < kGroupWarps; ++w) {
      lo0 = fmaxf(lo0, part[w]);
      lo1 = fmaxf(lo1, part[kGroupWarps + w]);
      hi0 = fminf(hi0, part[2 * kGroupWarps + w]);
      hi1 = fminf(hi1, part[3 * kGroupWarps + w]);
    }
  }

  // 4. sigma^2, lambda_+ and the count below it
  if (threadIdx.x == 0) {
    const float pair0 = __fmul_rn(0.5f, __fadd_rn(lo0, hi0));
    const float pair1 = __fmul_rn(0.5f, __fadd_rn(lo1, hi1));
    const float sigma2 = __fmul_rn(0.5f, __fadd_rn(pair0, pair1));
    const float lambda_plus = __fmul_rn(sigma2, edge);
    ranks[b] = n - sturm_count(dg, b2, n, lambda_plus, dmin);
  }
}

template <int kC>
int launch(const float* gram, int* ranks, float* diag, float* off2, int batch, int n, float m,
           float edge, cudaStream_t stream) {
  const size_t smem = smem_floats(n, kC) * sizeof(float);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mp_rank_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kC == 1) {
    mp_rank_kernel<1><<<batch, kThreads, smem, stream>>>(gram, ranks, diag, off2, n, m, edge);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * kC);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, mp_rank_kernel<kC>, gram, ranks, diag, off2, n, m, edge);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// gram (batch, n, n) fp32, ranks (batch,) int32, diag (batch, n) and off2
// (batch, n - 1) fp32; `cluster` CTAs a matrix (1, 2, 4 or 8, the least
// whose slice fits a CTA's shared memory); m the sample count, edge the
// fp32 (1 + sqrt(n / m))^2. Returns the launch's cudaGetLastError.
extern "C" int basd_mp_rank(const void* gram, void* ranks, void* diag, void* off2, int batch,
                            int n, int cluster, float m, float edge, void* stream) {
  if (batch <= 0 || n < kMinN) return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gram;
  int* r = (int*)ranks;
  float* d = (float*)diag;
  float* o = (float*)off2;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cluster) {
    case 1: return launch<1>(g, r, d, o, batch, n, m, edge, s);
    case 2: return launch<2>(g, r, d, o, batch, n, m, edge, s);
    case 4: return launch<4>(g, r, d, o, batch, n, m, edge, s);
    case 8: return launch<8>(g, r, d, o, batch, n, m, edge, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
