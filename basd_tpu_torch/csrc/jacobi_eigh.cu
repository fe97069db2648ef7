// Batch-parallel cyclic Jacobi eigendecomposition (K3) and eigenvalues-only
// variant (K5) of small symmetric fp32 matrices, for the BASD selector and
// the spectral tools on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_jacobi_kernel` (K3) and
// `_jacobi_eigvals_kernel` (K5) of basd_tpu/spectral/pallas_jacobi.py
// (step math in basd_tpu/spectral/jacobi.py) and runs the same sequence of
// rotations: positions are paired (i, i + n/2); each step computes the n/2
// rotations (c, s) with `pair_rotations`' formula (including its 1e-30
// guard), applies A <- J^T A J (rows first, then columns), rotates
// V^T <- J^T V^T (K3 only), and then applies the half-shift round-robin
// permutation
//     new = [x_0, x_h, x_1..x_{h-2}, x_{h+1}..x_{n-1}, x_{h-1}]
// to the positions. After (n - 1) * sweeps steps the diagonal holds the
// eigenvalues and V^T the eigenvectors, both written in logical order;
// sorting and stripping an odd-n pad stay in the wrapper.
//
// What bounds it here: the work is tiny (about 9 n^2 flops per step with
// V, 3 n (n + 2) without, on the upper block triangle of the symmetric A)
// and the bytes are one read of A and one write of w and
// V^T, but the (n - 1) * sweeps steps form a chain of dependent phases
// (282 steps at n = 48, six sweeps; 1,719 at n = 192, nine sweeps), each
// ending in a block-wide barrier. So it is bound by the latency of one
// step, not by bytes or operations: one CTA per matrix, so every matrix
// of the batch runs at once on its own SM, A resident in shared memory
// for the whole run, and as little as possible on each step's critical
// path. Three routes; the wrapper picks K3's by n
// (basd_tpu_torch/spectral/jacobi_kernel.py:eigh_route) and calls its entry
// points, which refuse an n that it was not built for or that does not fit
// a CTA's 227 KB of shared memory:
//   * kPingPong (K3, `basd_jacobi_eigh_pingpong`, even n <= 96: the
//     selector's gate 16 <= n <= 96 and the main path's n = 48), one
//     instantiation per even n: A and V^T in logical order, each in two
//     ping-pong buffers (4 n ld floats, rows ld >= n apart so that a warp's
//     blocks fall in 32 banks: 42 KB at n = 48, 168 KB at n = 96). A block
//     thread reads the 2x2 block (ri, ci) of A, rows {ri, ri + h} x
//     columns {ci, ci + h}, and V^T's rows {ri, ri + h} at columns
//     {ci, ci + h} from the current buffers, and writes the rotated values
//     to the other buffers at the next step's positions dst(.), the inverse
//     of the half-shift (basd_tpu_torch/spectral/jacobi.py:halfshift_dst,
//     in closed form below; `pingpong_step` there is this step in torch).
//     So there is no index map and no permutation phase, and every address
//     is a register fixed before the loop plus an immediate (n at run
//     time, with the offsets in registers, made the step 22% longer at
//     n = 48 on an H100; PERF.md §6). The step's critical path is the
//     rotation's chain of five dependent IEEE divisions and square roots,
//     so it runs beside the blocks' work instead of before it: the
//     rotation warps' lane k computes pair k's rotation a step ahead, from
//     the entries that the blocks rotate into its next a_kk, a_{k+h,k+h}
//     and a_{k,k+h}, rotated by the lane itself
//     (`jacobi.py:pingpong_pair_inputs`), and the block threads read the
//     step's rotations from shared memory. One barrier per step, and up to
//     n = 60 a one-way named barrier that lets the rotation lanes' loads
//     go first. Threads: one rotation lane per pair in whole warps, and the
//     fewest blocks per block thread that the rest of 1024 threads allow
//     (1 to n = 62, 2 to n = 86, 3 to n = 96). A is rotated in full, as in
//     the plain version (its fp32 rounding is not symmetric), and every
//     product, sum and difference is rounded on its own, as torch's
//     elementwise ops round them (no FMA contraction), so the route
//     returns the plain version's bits;
//   * kPackedLog (K3, even 96 < n <= 238): two launches. The first,
//     `basd_jacobi_eigh_packed_log`, is K5's packed kernel below with a
//     rotation log (kLog): A alone on one SM as its upper block triangle,
//     and each step's h rotations (c, s) stored by the rotation lanes that
//     compute them to a log in device memory, so its eigenvalues are K5's
//     bits. V^T, which does not fit beside two packed buffers (296 KB at
//     n = 192 against 227), is not on that chain: V^T <- J^T V^T acts on
//     each of its columns alone, so the second launch,
//     `basd_jacobi_eigh_vt_replay`, replays the log onto V^T column-parallel
//     (see the note above `jacobi_vt_replay_kernel`);
//   * kPacked (K5, `basd_jacobi_eigvals_packed`, even n <= 238, n at run
//     time, or the same kernel instantiated for the tuner's n = 192,
//     kFixedN, which the entry point picks itself): see the note above
//     `jacobi_packed_kernel` below.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math: IEEE division and sqrt).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxNPingPong = 96;
constexpr int kPingPongMaxThreads = 1024;
constexpr int kMaxNLoadsFirst = 60;

// `pair_rotations`' (c, s) for one pair (p, q) from a_pp, a_qq, a_pq
__device__ __forceinline__ void pair_rotation(float app, float aqq, float apq,
                                              float& c, float& s) {
  const bool safe = fabsf(apq) > 1e-30f;
  const float tau = (aqq - app) / (safe ? 2.0f * apq : 1.0f);
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  const float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  const float cc = 1.0f / sqrtf(1.0f + t * t);
  c = safe ? cc : 1.0f;
  s = safe ? t * cc : 0.0f;
}

// The kPingPong route rounds every product, sum and difference on its own,
// as torch's elementwise ops in the plain version do (no FMA contraction),
// so it returns the plain version's bits. The packed routes keep the
// contracted form above: this one made the first design's position-map
// routes slower on an H100 (by 2.7-7.9%) and K5 by 1.3% at (12, 192, 192),
// and `/` and sqrtf in its place made the ping-pong route 5% slower at
// n = 48 (PERF.md §6, basd_tpu_torch/tools/time_jacobi.py).
__device__ __forceinline__ void pair_rotation_rn(float app, float aqq, float apq,
                                                 float& c, float& s) {
  const bool safe = fabsf(apq) > 1e-30f;
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), safe ? __fmul_rn(2.0f, apq) : 1.0f);
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  const float t = __fdiv_rn(
      sgn, __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
  const float cc = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  c = safe ? cc : 1.0f;
  s = safe ? __fmul_rn(t, cc) : 0.0f;
}

// c x - s y and s x + c y, rounded as the plain version rounds them
__device__ __forceinline__ float rot_lo(float c, float s, float x, float y) {
  return __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
}
__device__ __forceinline__ float rot_hi(float c, float s, float x, float y) {
  return __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
}

// the position that the half-shift moves position p to
// (basd_tpu_torch/spectral/jacobi.py:halfshift_dst)
__device__ __forceinline__ int halfshift_dst(int p, int n) {
  const int h = n / 2;
  if (p == 0) return 0;
  if (p == h) return 1;
  if (p == h - 1) return n - 1;
  return p < h - 1 ? p + 1 : p - 1;
}

// the position that the half-shift moves to position k, the inverse of
// halfshift_dst (basd_tpu_torch/spectral/jacobi.py:halfshift_src)
__device__ __forceinline__ int halfshift_src(int k, int n) {
  const int h = n / 2;
  if (k == 0) return 0;
  if (k == 1) return h;
  if (k == n - 1) return h - 1;
  return k < h ? k - 1 : k + 1;
}

// The kPingPong route at one even n (see the note at the top); every
// size is a compile-time constant, so each address is a register fixed
// before the loop plus an immediate.
template <int kN>
struct PingPong {
  static constexpr int kH = kN / 2;
  // the row stride: the least ld >= n with ld = h (mod 32). Entry (ri, ci)
  // of the h x h grid then sits in bank (ri * h + ci) mod 32, so the 32
  // consecutive blocks of a warp, which span two or three rows of the
  // grid, read and write 32 different banks (at ld = n = 48 two rows of
  // one warp collide)
  static constexpr int kLd = kN + (32 - kH % 32) % 32;
  static constexpr int kSz = kN * kLd;  // floats per matrix buffer
  // threads: the block threads, then the rotation warps, whose lane k
  // computes pair k's rotation
  static constexpr int kRotWarps = (kH + 31) / 32;
  static constexpr int kBlocks = kH * kH;
  static constexpr int kMaxBlockThreads = kPingPongMaxThreads - 32 * kRotWarps;
  static constexpr int kPer = (kBlocks + kMaxBlockThreads - 1) / kMaxBlockThreads;
  static constexpr int kBlockThreads = ((kBlocks + kPer - 1) / kPer + 31) / 32 * 32;
  static constexpr int kThreads = kBlockThreads + 32 * kRotWarps;
  // Where the rotation lanes' chain sets the step's length (to n = 60),
  // the block warps wait on a one-way named barrier until the rotation
  // warps have issued their loads, so that those are not queued behind
  // the blocks' loads; above, the blocks' own work sets it and the wait
  // would only delay them
  static constexpr bool kLoadsFirst = kN <= kMaxNLoadsFirst;
  // A0, VT0, A1, VT1, then the rotations (c[h], s[h]) CS0, CS1
  static constexpr size_t kSmemBytes = sizeof(float) * (4 * kSz + 4 * kH);
};

// A block thread's part of one step, from the buffers of parity kPar to the
// others: its 2x2 blocks rotated with this step's rotations, which the
// rotation warps wrote in the step before, and scattered to the next step's
// positions.
template <int kN, int kPar>
__device__ __forceinline__ void block_step(
    float* smem, const bool (&live)[PingPong<kN>::kPer],
    const int (&ri)[PingPong<kN>::kPer], const int (&ci)[PingPong<kN>::kPer],
    const int (&src)[PingPong<kN>::kPer], const int (&da)[PingPong<kN>::kPer][4],
    const int (&dv)[PingPong<kN>::kPer][2]) {
  using P = PingPong<kN>;
  constexpr int h = P::kH, hn = P::kH * P::kLd;
  const float* A = smem + kPar * 2 * P::kSz;
  const float* VT = A + P::kSz;
  const float* cs = smem + 4 * P::kSz + kPar * 2 * h;
  float* An = smem + (1 - kPar) * 2 * P::kSz;
  float* VTn = An + P::kSz;
  if constexpr (P::kLoadsFirst) asm volatile("bar.sync 1, %0;" ::"n"(P::kThreads) : "memory");
#pragma unroll
  for (int j = 0; j < P::kPer; ++j) {
    if (!live[j]) continue;
    const int o = src[j];
    const float a[4] = {A[o], A[o + h], A[o + hn], A[o + hn + h]};
    const float v[4] = {VT[o], VT[o + h], VT[o + hn], VT[o + hn + h]};
    // the rotations of the row pair ri and the column pair ci
    const float cr = cs[ri[j]], sr = cs[h + ri[j]], cc = cs[ci[j]], sc = cs[h + ci[j]];
    // rows first (apply_rows), then columns (apply_cols)
    const float t0 = rot_lo(cr, sr, a[0], a[2]), t1 = rot_lo(cr, sr, a[1], a[3]);
    const float b0 = rot_hi(cr, sr, a[0], a[2]), b1 = rot_hi(cr, sr, a[1], a[3]);
    An[da[j][0]] = rot_lo(cc, sc, t0, t1);
    An[da[j][1]] = rot_hi(cc, sc, t0, t1);
    An[da[j][2]] = rot_lo(cc, sc, b0, b1);
    An[da[j][3]] = rot_hi(cc, sc, b0, b1);
    // V^T <- J^T V^T: rows ri, ri + h move, columns ci, ci + h stay
    VTn[dv[j][0]] = rot_lo(cr, sr, v[0], v[2]);
    VTn[dv[j][1]] = rot_hi(cr, sr, v[0], v[2]);
    VTn[dv[j][0] + h] = rot_lo(cr, sr, v[1], v[3]);
    VTn[dv[j][1] + h] = rot_hi(cr, sr, v[1], v[3]);
  }
}

// A rotation lane's part of one step: pair k's rotation for the next step,
// from the three entries that the blocks rotate into its a_kk, a_{k+h,k+h}
// and a_{k,k+h}, rotated here from this step's A and rotations as the
// blocks rotate them (`jacobi.py:pingpong_pair_inputs`). An entry in a
// block's bottom row or right column is taken as the top or left one with
// its operands swapped and s negated, which gives the same bits
// (s x + c y = c y - (-s) x in IEEE arithmetic). ea[e] holds the four
// operands' offsets in that order for a_kk, a_{k+h,k+h} and a_{k,k+h};
// their rows take the rotation of pair r1, r2, r1 and their columns that
// of r1, r2, r2, with s times g1 or g2 (-1 for a bottom row or right
// column).
template <int kN, int kPar>
__device__ __forceinline__ void rotation_step(float* smem, int k, int r1, int r2,
                                              float g1, float g2,
                                              const int (&ea)[3][4]) {
  using P = PingPong<kN>;
  constexpr int h = P::kH;
  const float* A = smem + kPar * 2 * P::kSz;
  const float* cs = smem + 4 * P::kSz + kPar * 2 * h;
  float* csn = smem + 4 * P::kSz + (1 - kPar) * 2 * h;
  float in[3][4];
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) in[e][q] = A[ea[e][q]];
  const float c1 = cs[r1], c2 = cs[r2];
  float s1 = cs[h + r1], s2 = cs[h + r2];
  if constexpr (P::kLoadsFirst) asm volatile("bar.arrive 1, %0;" ::"n"(P::kThreads) : "memory");
  s1 = __fmul_rn(g1, s1);
  s2 = __fmul_rn(g2, s2);
  float x[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float cr = e == 1 ? c2 : c1, sr = e == 1 ? s2 : s1;
    const float cc = e == 0 ? c1 : c2, sc = e == 0 ? s1 : s2;
    const float tl = rot_lo(cr, sr, in[e][0], in[e][1]);
    const float tr = rot_lo(cr, sr, in[e][2], in[e][3]);
    x[e] = rot_lo(cc, sc, tl, tr);
  }
  float c, s;
  pair_rotation_rn(x[0], x[1], x[2], c, s);
  if (k < h) {
    csn[k] = c;
    csn[h + k] = s;
  }
}

// Shared memory: A0, VT0, A1, VT1, kSz floats each, logical order, rows
// kLd apart, then the rotations CS0, CS1. Block thread t < kBlockThreads
// takes the 2x2 blocks t + j * kBlockThreads, j < kPer, of the h x h grid;
// the rotation warps' lanes k < h compute pair k's rotation a step ahead,
// so the blocks' work and the rotations' chain of divisions and square
// roots run side by side between two barriers. The loop runs two steps per
// trip, 0 -> 1 and 1 -> 0, so the buffers' offsets are constants.
template <int kN>
__global__ void __launch_bounds__(PingPong<kN>::kThreads)
jacobi_pingpong_kernel(const float* __restrict__ a_in, float* __restrict__ w_out,
                       float* __restrict__ vt_out, int steps) {
  using P = PingPong<kN>;
  constexpr int n = kN, h = P::kH, ld = P::kLd, sz = P::kSz;
  extern __shared__ float smem[];
  const long long base = (long long)blockIdx.x * n * n;
  const int tid = threadIdx.x;
  const bool rot = tid >= P::kBlockThreads;  // whole warps

  for (int i = tid; i < n * n; i += P::kThreads) {
    const int r = i / n, c = i - r * n;
    smem[r * ld + c] = a_in[base + i];
    smem[sz + r * ld + c] = r == c ? 1.f : 0.f;
  }
  // a block thread's blocks: its row and column pair, its top-left entry,
  // where its four rotated entries of A go (rows dst(ri), dst(ri + h),
  // columns dst(ci), dst(ci + h)) and where its V^T entries go (rows
  // dst(ri), dst(ri + h); columns stay)
  bool live[P::kPer];
  int ri[P::kPer], ci[P::kPer], src[P::kPer], da[P::kPer][4], dv[P::kPer][2];
#pragma unroll
  for (int j = 0; j < P::kPer; ++j) {
    const int idx = tid + j * P::kBlockThreads;
    live[j] = !rot && idx < h * h;
    ri[j] = live[j] ? idx / h : 0;
    ci[j] = live[j] ? idx - ri[j] * h : 0;
    src[j] = ri[j] * ld + ci[j];
    const int rows[2] = {halfshift_dst(ri[j], n), halfshift_dst(ri[j] + h, n)};
    const int cols[2] = {halfshift_dst(ci[j], n), halfshift_dst(ci[j] + h, n)};
#pragma unroll
    for (int q = 0; q < 4; ++q) da[j][q] = rows[q / 2] * ld + cols[q % 2];
    dv[j][0] = rows[0] * ld + ci[j];
    dv[j][1] = rows[1] * ld + ci[j];
  }
  // a rotation lane's pair k (clamped into the grid) and the entries that
  // land on its a_kk, a_{k+h,k+h}, a_{k,k+h}: positions p1 = src(k) and
  // p2 = src(k + h), in the pairs r1, r2 of the halves g1, g2
  const int k = rot ? tid - P::kBlockThreads : 0;
  const int kk = k < h ? k : 0;
  const int p1 = halfshift_src(kk, n), p2 = halfshift_src(kk + h, n);
  const int r1 = p1 < h ? p1 : p1 - h, r2 = p2 < h ? p2 : p2 - h;
  const float g1 = p1 < h ? 1.f : -1.f, g2 = p2 < h ? 1.f : -1.f;
  int ea[3][4];
  {
    // entry e: rows {p, the other row of its pair} x columns {q, the other}
    const int pr[3] = {p1, p2, p1}, pc[3] = {p1, p2, p2};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int u = pr[e], w = u < h ? u + h : u - h;
      const int l = pc[e], r = l < h ? l + h : l - h;
      ea[e][0] = u * ld + l;
      ea[e][1] = w * ld + l;
      ea[e][2] = u * ld + r;
      ea[e][3] = w * ld + r;
    }
  }
  if (rot) {  // the first step's rotations, from the input
    float c, s;
    pair_rotation_rn(a_in[base + kk * (n + 1)], a_in[base + (kk + h) * (n + 1)],
                     a_in[base + kk * n + kk + h], c, s);
    if (k < h) {
      smem[4 * sz + k] = c;
      smem[4 * sz + h + k] = s;
    }
  }
  __syncthreads();

  for (int step = 0; step + 1 < steps; step += 2) {
    if (rot) rotation_step<kN, 0>(smem, k, r1, r2, g1, g2, ea);
    else block_step<kN, 0>(smem, live, ri, ci, src, da, dv);
    __syncthreads();
    if (rot) rotation_step<kN, 1>(smem, k, r1, r2, g1, g2, ea);
    else block_step<kN, 1>(smem, live, ri, ci, src, da, dv);
    __syncthreads();
  }
  if (steps % 2) {
    if (rot) rotation_step<kN, 0>(smem, k, r1, r2, g1, g2, ea);
    else block_step<kN, 0>(smem, live, ri, ci, src, da, dv);
    __syncthreads();
  }

  const float* A = smem + (steps % 2) * 2 * sz;
  const float* VT = A + sz;
  for (int i = tid; i < n; i += P::kThreads)
    w_out[(long long)blockIdx.x * n + i] = A[i * (ld + 1)];
  for (int i = tid; i < n * n; i += P::kThreads) {
    const int r = i / n, c = i - r * n;
    vt_out[base + i] = VT[r * ld + c];
  }
}

template <int kN>
int launch_pingpong_at(const void* a, void* w, void* vt, int batch, int steps,
                       void* stream) {
  using P = PingPong<kN>;
  if (P::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_pingpong_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  jacobi_pingpong_kernel<kN><<<batch, P::kThreads, P::kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)a, (float*)w, (float*)vt, steps);
  return (int)cudaGetLastError();
}

// the instantiation for n, one per even n from kN to kMaxNPingPong
template <int kN>
int launch_pingpong(const void* a, void* w, void* vt, int batch, int n,
                    int steps, void* stream) {
  if (n == kN) return launch_pingpong_at<kN>(a, w, vt, batch, steps, stream);
  if constexpr (kN < kMaxNPingPong)
    return launch_pingpong<kN + 2>(a, w, vt, batch, n, steps, stream);
  return (int)cudaErrorInvalidValue;
}

constexpr int kMaxSharedBytes = 232448;  // 227 KB, sm_90

// ---------------------------------------------------------------------------
// kPacked, K5 (eigenvalues only) at even n <= 238: kPingPong's step
// carried to large n on the upper block triangle of A.
//
// What bounded the route it replaces (the first design's position-map loop
// with A alone, one CTA per matrix, 1,719 dependent steps at (12, 192, 192),
// sweeps 9):
// each step computed the h rotations through a position map in front of
// the block work (a chain of five dependent IEEE divisions and square
// roots), took two barriers, made four map loads per 2x2 block and
// permuted the map: 4.08 us a step, 7.0 ms a launch on an H100 (PERF.md
// §6). The ping-pong route of K3 takes all of that off the step, but two
// full buffers at n = 192 need 294,912 B, more than a CTA's 232,448.
//
// Here A, which is symmetric, is held as the blocks (R, C), R <= C, of
// the h x h grid of 2x2 blocks (rows {R, R + h} x columns {C, C + h}),
// h (h + 1) / 2 of them in row-major order, in four planes TL, TR, BL, BR
// of m = h (h + 1) / 2 floats each: 74,496 B a buffer at n = 192, two
// buffers in ping-pong (228,512 B with the rotations at n = 238, the
// largest n that fits). An entry (p, q) is held once, in its canonical
// slot: that of the block (pair(p), pair(q)) when pair(p) < pair(q), of
// (pair(q), pair(p)) when pair(p) > pair(q); in a diagonal block (R, R)
// the planes TL, TR and BR hold a_RR, a_{R,R+h} and a_{R+h,R+h}, and a
// read of its BL is one of TR (so the BL slot is never read). A block
// thread rotates its blocks with this step's rotations (rows by pair R,
// columns by pair C) and writes each rotated entry to the canonical slot
// of its next position (dst(p), dst(q)) in the other buffer, transposed
// where that falls below the diagonal: dst is a bijection, so each slot of
// the next buffer is written exactly once (the rotated BL of a diagonal
// block, whose canonical slot is its TR's, goes to a dummy slot at the end
// of the buffer). Rotation warps compute each pair's next rotation a step
// ahead from the three canonical entries that land on its a_kk,
// a_{k+h,k+h} and a_{k,k+h}, rotated by the lane exactly as the block
// threads rotate them (basd_tpu_torch/spectral/jacobi.py:packed_step and
// packed_pair_inputs are this step in torch). So one barrier a step, no
// position map, no permutation phase, and half the block work of the full
// matrix. The products are contracted into FMAs in one fixed form
// (rot_lo_fma, rot_hi_fma) that the block threads and the rotation lanes
// share, so a lane's inputs are the bits that the blocks write. Since the
// plain version rotates the full, not exactly symmetric, A, the route
// cannot return its bits: it is held within 1e-4 of max|w| of it.
//
// n is a run-time argument (kPacked): the kernel is instantiated per 2x2
// blocks per block thread (kPer, 1 to 8), and each thread keeps its
// blocks' source, rotation and destination offsets in registers, two
// 16-bit offsets to a register (at n = 238, 8 blocks a thread in a CTA of
// 1,024 threads, 64 registers each). For the spectral tuner's n = 192 the
// same kernel is instantiated with n and the thread split as constants
// (kFixedN, which `basd_jacobi_eigvals_packed` launches at that n; the n
// is named once, kPackedFixedN): 6.0% less device time there, 2.1125 against 2.2463 ms at
// (12, 192, 192) and sweeps 9 on an H100, where the position-map loop
// it replaces took 7.0055 ms (PERF.md §6,
// basd_tpu_torch/tools/time_jacobi.py). One step at n = 192 is 392
// instructions per warp: 52 shared loads, 25 stores, one barrier. An
// alternative that lost: a cluster of two CTAs per matrix, each holding
// the full ping-pong A's rows of half the pairs, rotated with the plain
// version's rounding, rows that move to the other half written over
// distributed shared memory, one cluster barrier a step: 7.19 ms against
// 2.10 in the same call (4.18 us a step), though it used 24 SMs.
// ---------------------------------------------------------------------------

constexpr int kMaxNPacked = 238;
constexpr int kPackedMaxThreads = 1024;
constexpr int kPackedMaxPer = 8;
// the one n with an instantiation of its own (kFixedN): the spectral
// tuner's D_s, Table-3's student width
constexpr int kPackedFixedN = 192;

// c x - s y and s x + c y, each one FMUL and one FFMA in this fixed form,
// so that rot_hi_fma(c, s, x, y) == rot_lo_fma(c, -s, y, x) bit for bit
__device__ __forceinline__ float rot_lo_fma(float c, float s, float x, float y) {
  return __fmaf_rn(c, x, -__fmul_rn(s, y));
}
__device__ __forceinline__ float rot_hi_fma(float c, float s, float x, float y) {
  return __fmaf_rn(c, y, __fmul_rn(s, x));
}

// the launch shape of the packed route at even n
struct PackedShape {
  int h, m, buf, block_threads, threads, per;
  size_t smem;
};

__host__ __device__ constexpr PackedShape packed_shape(int n) {
  PackedShape p{};
  p.h = n / 2;
  p.m = p.h * (p.h + 1) / 2;
  p.buf = 4 * p.m + 4;  // four planes and the dummy slot, 16 B aligned
  const int rot_threads = 32 * ((p.h + 31) / 32);
  const int max_block_threads = kPackedMaxThreads - rot_threads;
  p.per = (p.m + max_block_threads - 1) / max_block_threads;
  p.block_threads = ((p.m + p.per - 1) / p.per + 31) / 32 * 32;
  p.threads = p.block_threads + rot_threads;
  // two buffers, then the rotations (c, s) of two steps
  p.smem = sizeof(float) * (2 * (size_t)p.buf + 4 * (size_t)p.h);
  return p;
}

// float2 per step of K3's rotation log: h rounded up to even, so that
// every step's row starts 16-byte aligned (spectral/jacobi_kernel.py:log_pairs)
__host__ __device__ constexpr int log_pairs(int n) { return (n / 2 + 1) / 2 * 2; }

// block (R, C), R <= C, in row-major order of the upper triangle
__device__ __forceinline__ int packed_block(int r, int c, int h) {
  return r * h - r * (r - 1) / 2 + c - r;
}

// the canonical slot of entry (p, q), either order
__device__ __forceinline__ int packed_slot(int p, int q, int h, int m) {
  int r = p < h ? p : p - h, c = q < h ? q : q - h;
  if (r > c || (r == c && p > q)) {
    const int t = p; p = q; q = t;
    const int u = r; r = c; c = u;
  }
  return (2 * (p >= h) + (q >= h)) * m + packed_block(r, c, h);
}

// the slot read for (plane (i, j)) of block (r, c): a diagonal block's BL
// is its TR
__device__ __forceinline__ int packed_read(int r, int c, int i, int j, int h, int m) {
  const int plane = (r == c && i == 1 && j == 0) ? 1 : 2 * i + j;
  return plane * m + packed_block(r, c, h);
}

template <int kPer>
__device__ __forceinline__ void packed_block_step(
    const float* __restrict__ A, const float2* __restrict__ cs, float* __restrict__ An,
    int m, const unsigned (&src)[kPer], const unsigned (&rc)[kPer],
    const unsigned (&d01)[kPer], const unsigned (&d23)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (src[j] == ~0u) continue;
    const int b = src[j] & 0xffff, bl = src[j] >> 16;
    const float a00 = A[b], a01 = A[m + b], a10 = A[bl], a11 = A[3 * m + b];
    const float2 r = cs[rc[j] & 0xffff], c = cs[rc[j] >> 16];
    // rows first (apply_rows), then columns (apply_cols)
    const float t0 = rot_lo_fma(r.x, r.y, a00, a10), t1 = rot_lo_fma(r.x, r.y, a01, a11);
    const float b0 = rot_hi_fma(r.x, r.y, a00, a10), b1 = rot_hi_fma(r.x, r.y, a01, a11);
    An[d01[j] & 0xffff] = rot_lo_fma(c.x, c.y, t0, t1);
    An[d01[j] >> 16] = rot_hi_fma(c.x, c.y, t0, t1);
    An[d23[j] & 0xffff] = rot_lo_fma(c.x, c.y, b0, b1);
    An[d23[j] >> 16] = rot_hi_fma(c.x, c.y, b0, b1);
  }
}

// A rotation lane's part of one step: pair k's next rotation from the
// three canonical entries that land on its a_kk, a_{k+h,k+h}, a_{k,k+h}.
// Entry e is plane (i, j) of block (R, C); ea[e] holds the slots of planes
// (i, j), (1 - i, j), (i, 1 - j), (1 - i, 1 - j), its rows take pair
// er[e]'s rotation with s times gr (-1 for i = 1) and its columns pair
// ec[e]'s with s times gc (-1 for j = 1): a bottom row or right column
// taken as the top or left one with the operands swapped, which gives the
// block threads' bits (rot_hi_fma(c, s, x, y) == rot_lo_fma(c, -s, y, x)).
// With kLog the lane also stores the rotation to `logrow` (the next step's
// row of the rotation log) unless it is null (no step follows).
template <bool kLog>
__device__ __forceinline__ void packed_rotation_step(
    const float* __restrict__ A, const float2* __restrict__ cs, float2* __restrict__ csn,
    int k, int h, const int (&ea)[3][4], const int (&er)[3], const int (&ec)[3],
    const float (&gr)[3], const float (&gc)[3], float2* __restrict__ logrow) {
  float in[3][4];
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) in[e][q] = A[ea[e][q]];
  float x[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float2 r = cs[er[e]], c = cs[ec[e]];
    const float sr = gr[e] * r.y, sc = gc[e] * c.y;
    x[e] = rot_lo_fma(c.x, sc, rot_lo_fma(r.x, sr, in[e][0], in[e][1]),
                      rot_lo_fma(r.x, sr, in[e][2], in[e][3]));
  }
  float c, s;
  pair_rotation(x[0], x[1], x[2], c, s);
  if (k < h) {
    csn[k] = make_float2(c, s);
    if constexpr (kLog)
      if (logrow != nullptr) logrow[k] = make_float2(c, s);
  }
}

// Shared memory: buffers A0, A1 (4 planes of m floats and a dummy slot
// each), then the rotations CS0, CS1 (h float2 each). Block thread
// t < block_threads takes the blocks t + j * block_threads, j < kPer;
// rotation lane k < h computes pair k's rotation a step ahead. kN > 0
// makes n and the thread split compile-time constants (kFixedN). kLog
// (K3's kPackedLog route) also writes every step's rotations to `log`,
// (batch, steps, log_pairs(n)) float2, step t's row holding the rotations
// that step t applies; nothing else changes, so w is the kLog-free
// kernel's bits.
template <int kPer, int kN = 0, bool kLog = false>
__global__ void __launch_bounds__(kPackedMaxThreads)
jacobi_packed_kernel(const float* __restrict__ a_in, float* __restrict__ w_out,
                     float2* __restrict__ log, int n, int steps, int block_threads) {
  if constexpr (kN != 0) {
    n = kN;
    block_threads = packed_shape(kN).block_threads;
  }
  extern __shared__ __align__(16) float packed_smem[];
  const int h = n / 2, m = h * (h + 1) / 2, buf = 4 * m + 4;
  float* A0 = packed_smem;
  float* A1 = packed_smem + buf;
  float2* CS0 = reinterpret_cast<float2*>(packed_smem + 2 * buf);
  float2* CS1 = CS0 + h;
  const long long base = (long long)blockIdx.x * n * n;
  const int tid = threadIdx.x;
  const bool rot = tid >= block_threads;  // whole warps
  const int lp = log_pairs(n);
  float2* logb = log + (kLog ? (long long)blockIdx.x * steps * lp : 0);

  // A's canonical entries into the packed buffer 0 (the wrapper passes
  // a symmetric A)
  for (int i = tid; i < n * n; i += blockDim.x) {
    const int p = i / n, q = i - p * n;
    const int r = p < h ? p : p - h, c = q < h ? q : q - h;
    if (r < c || (r == c && p <= q)) A0[packed_slot(p, q, h, m)] = a_in[base + i];
  }

  // a block thread's blocks: the slots it reads (TL's block index, and its
  // BL's slot), its row and column pairs (the rotations' indices), and the
  // slots of the next buffer that its four rotated entries go to
  unsigned src[kPer], rc[kPer], d01[kPer], d23[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = tid + j * block_threads;
    src[j] = ~0u;
    rc[j] = d01[j] = d23[j] = 0;
    if (rot || idx >= m) continue;
    int r = 0, start = 0;
    while (idx >= start + h - r) start += h - r++;
    const int c = r + idx - start;
    src[j] = (unsigned)idx | (unsigned)packed_read(r, c, 1, 0, h, m) << 16;
    rc[j] = (unsigned)r | (unsigned)c << 16;
    unsigned d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = q / 2, jj = q % 2;
      d[q] = (r == c && i == 1 && jj == 0)
                 ? 4 * m  // the dummy slot
                 : packed_slot(halfshift_dst(r + i * h, n), halfshift_dst(c + jj * h, n), h, m);
    }
    d01[j] = d[0] | d[1] << 16;
    d23[j] = d[2] | d[3] << 16;
  }
  // a rotation lane's pair k (clamped into the grid): the positions
  // p1 = src(k), p2 = src(k + h) whose rotated entries land on its next
  // a_kk, a_{k+h,k+h} and a_{k,k+h}, each entry's canonical block and plane
  const int k = rot ? tid - block_threads : 0;
  const int kk = k < h ? k : 0;
  int ea[3][4], er[3], ec[3];
  float gr[3], gc[3];
  {
    const int p1 = halfshift_src(kk, n), p2 = halfshift_src(kk + h, n);
    const int ps[3] = {p1, p2, p1}, qs[3] = {p1, p2, p2};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      int p = ps[e], q = qs[e];
      int r = p < h ? p : p - h, c = q < h ? q : q - h;
      if (r > c || (r == c && p > q)) {
        const int t = p; p = q; q = t;
        const int u = r; r = c; c = u;
      }
      const int i = p >= h, j = q >= h;
      ea[e][0] = packed_read(r, c, i, j, h, m);
      ea[e][1] = packed_read(r, c, 1 - i, j, h, m);
      ea[e][2] = packed_read(r, c, i, 1 - j, h, m);
      ea[e][3] = packed_read(r, c, 1 - i, 1 - j, h, m);
      er[e] = r;
      ec[e] = c;
      gr[e] = i ? -1.f : 1.f;
      gc[e] = j ? -1.f : 1.f;
    }
  }
  if (rot) {  // the first step's rotations, from the input
    float c, s;
    pair_rotation(a_in[base + kk * (n + 1)], a_in[base + (kk + h) * (n + 1)],
                  a_in[base + kk * n + kk + h], c, s);
    if (k < h) {
      CS0[k] = make_float2(c, s);
      if constexpr (kLog)
        if (steps > 0) logb[k] = make_float2(c, s);
    }
  }
  __syncthreads();

  // the log's row of step t, for the rotations computed in step t - 1
  auto log_row = [&](int t) -> float2* {
    return kLog && t < steps ? logb + (long long)t * lp : nullptr;
  };
  for (int step = 0; step + 1 < steps; step += 2) {
    if (rot) packed_rotation_step<kLog>(A0, CS0, CS1, k, h, ea, er, ec, gr, gc, log_row(step + 1));
    else packed_block_step<kPer>(A0, CS0, A1, m, src, rc, d01, d23);
    __syncthreads();
    if (rot) packed_rotation_step<kLog>(A1, CS1, CS0, k, h, ea, er, ec, gr, gc, log_row(step + 2));
    else packed_block_step<kPer>(A1, CS1, A0, m, src, rc, d01, d23);
    __syncthreads();
  }
  if (steps % 2) {
    if (!rot) packed_block_step<kPer>(A0, CS0, A1, m, src, rc, d01, d23);
    __syncthreads();
  }

  // the diagonal: a_ii is TL (i < h) or BR (i >= h) of the block (i mod h)
  const float* A = steps % 2 ? A1 : A0;
  for (int i = tid; i < n; i += blockDim.x) {
    const int r = i < h ? i : i - h;
    w_out[(long long)blockIdx.x * n + i] = A[(i < h ? 0 : 3 * m) + packed_block(r, r, h)];
  }
}

template <int kPer, bool kLog>
int launch_packed_at(const void* a, void* w, void* log, int batch, int n, int steps,
                     const PackedShape& p, void* stream) {
  if (p.per != kPer) {
    if constexpr (kPer < kPackedMaxPer)
      return launch_packed_at<kPer + 1, kLog>(a, w, log, batch, n, steps, p, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_packed_kernel<kPer, 0, kLog>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  jacobi_packed_kernel<kPer, 0, kLog><<<batch, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const float*)a, (float*)w, (float2*)log, n, steps, p.block_threads);
  return (int)cudaGetLastError();
}

// the kFixedN route at n = kN
template <int kN, bool kLog>
int launch_packed_fixed(const void* a, void* w, void* log, int batch, int steps,
                        void* stream) {
  constexpr PackedShape p = packed_shape(kN);
  static_assert(p.smem <= kMaxSharedBytes && p.per <= kPackedMaxPer, "kFixedN shape");
  const cudaError_t err = cudaFuncSetAttribute(
      jacobi_packed_kernel<p.per, kN, kLog>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  jacobi_packed_kernel<p.per, kN, kLog><<<batch, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const float*)a, (float*)w, (float2*)log, kN, steps, p.block_threads);
  return (int)cudaGetLastError();
}

template <bool kLog>
int launch_packed(const void* a, void* w, void* log, int batch, int n, int steps,
                  void* stream) {
  if (n < 4 || n > kMaxNPacked || n % 2 != 0 || batch <= 0 ||
      (kLog && steps > 0 && log == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == kPackedFixedN)
    return launch_packed_fixed<kPackedFixedN, kLog>(a, w, log, batch, steps, stream);
  const PackedShape p = packed_shape(n);
  if (p.smem > kMaxSharedBytes || p.threads > kPackedMaxThreads)
    return (int)cudaErrorInvalidValue;
  return launch_packed_at<1, kLog>(a, w, log, batch, n, steps, p, stream);
}

// ---------------------------------------------------------------------------
// kPackedLog's second launch: V^T rebuilt from the rotation log.
//
// V^T starts as the identity, and step t maps rows (k, k + h) of every
// column to c x - s y and s x + c y (rot_lo_fma, rot_hi_fma: the packed
// route's fixed contracted form) with step t's rotation k, and moves each
// row to its next position halfshift_dst, exactly as the ping-pong route
// moves V^T: so V^T ends in the position order of the diagonal that the
// first launch writes, with no position map, and the wrapper's `finish`
// sorts it. A column's steps touch that column alone, so the grid is
// (column tiles, batch): a CTA holds kReplayCols columns of V^T (lane l of
// every warp owns column l of the tile, so a warp's loads and stores of a
// row fall in 32 banks) in two ping-pong shared-memory buffers (24.6 KB
// each at n = 192), warp w rotates the pairs w, w + kReplayWarps, ..., and
// one barrier a step makes a step's rows visible to the next. Each step's
// rotations come from the log (768 B at n = 192, read from L2 or device
// memory) by 16-byte cp.async into a ring of kReplayRing steps in shared
// memory, issued kReplayRing - 1 steps ahead, so the barrier's step never
// waits on a load. A warp loads a group of kReplayGroup pairs before it
// stores them: the two buffers' offsets are run-time values, so the
// compiler keeps each load behind every earlier store, and pair by pair a
// step was twelve shared-memory round trips at n = 192; all of a step's
// loads at once took so many registers that only two CTAs fit an SM.
//
// What bounds it: the work is h n 2x2 column rotations a step (3 n^2
// flops), each reading and writing 16 B of shared memory, 16 GB at
// (48, 192, 192) and sweeps 6, which at 128 B a clock per SM is about
// 0.55 ms spread over all 132 SMs, 0.75 ms on the SMs that hold three of
// the 288 CTAs. Measured on an H100 (80GB HBM3, 700 W; PERF.md §6,
// basd_tpu_torch/tools/time_jacobi.py), the two launches together:
// 2.4534 ms there (K5's kernel alone 1.406; the first design's
// position-map route 10.56), 0.7640 ms at (4, 128, 128) (3.01).
// ---------------------------------------------------------------------------

constexpr int kReplayCols = 32;  // one column per lane
constexpr int kReplayWarps = 8;
constexpr int kReplayThreads = kReplayWarps * 32;
constexpr int kReplayGroup = 6;      // pairs whose loads go before their stores
constexpr int kReplayCtasPerSm = 3;  // the register budget: 85 a thread
constexpr int kReplayRing = 8;
constexpr int kReplayMaxPairs = (kMaxNPacked / 2 + kReplayWarps - 1) / kReplayWarps;
static_assert(kReplayCols == 32, "lane l of every warp owns column l of the tile");

size_t replay_smem(int n) {
  return sizeof(float) * 2 * (size_t)n * kReplayCols +
         sizeof(float2) * kReplayRing * (size_t)log_pairs(n);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kReplayThreads, kReplayCtasPerSm)
jacobi_vt_replay_kernel(const float2* __restrict__ log, float* __restrict__ vt_out, int n,
                        int steps) {
  extern __shared__ __align__(16) float replay_smem_buf[];
  const int h = n / 2, lp = log_pairs(n);
  float* B0 = replay_smem_buf;
  float* B1 = B0 + n * kReplayCols;
  float2* ring = reinterpret_cast<float2*>(B1 + n * kReplayCols);
  const int col0 = blockIdx.x * kReplayCols, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float2* logb = log + (long long)b * steps * lp;
  // step t's lp rotations, lp / 2 16-byte pieces, into ring slot t mod R
  auto fetch = [&](int t) {
    if (t < steps)
      for (int i = tid; i < lp / 2; i += kReplayThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(ring + (t % kReplayRing) * lp + 2 * i)),
                     "l"(logb + (long long)t * lp + 2 * i)
                     : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int t = 0; t < kReplayRing - 1; ++t) fetch(t);

  for (int i = tid; i < n * kReplayCols; i += kReplayThreads) {
    const int r = i / kReplayCols;
    B0[i] = r == col0 + (i - r * kReplayCols) ? 1.f : 0.f;
  }
  // this warp's pairs k = warp + j * kReplayWarps, j < npairs: lane's
  // column of rows k and k + h is read at tid + j * kReplayThreads (and
  // h kReplayCols on), and its rotated rows go to rows dst(k), dst(k + h)
  const int npairs = (h - warp + kReplayWarps - 1) / kReplayWarps;
  const int hoff = h * kReplayCols;
  int dst[kReplayMaxPairs][2];
#pragma unroll
  for (int j = 0; j < kReplayMaxPairs; ++j) {
    const int k = j < npairs ? warp + j * kReplayWarps : 0;
    dst[j][0] = halfshift_dst(k, n) * kReplayCols + lane;
    dst[j][1] = halfshift_dst(k + h, n) * kReplayCols + lane;
  }

  for (int t = 0; t < steps; ++t) {
    // step t's rotations have landed (at most R - 2 later steps in
    // flight), and every warp has finished step t - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kReplayRing - 2) : "memory");
    __syncthreads();
    fetch(t + kReplayRing - 1);  // into the slot that step t - 1 read
    const float* cur = t & 1 ? B1 : B0;
    float* nxt = t & 1 ? B0 : B1;
    const float2* cs = ring + (t % kReplayRing) * lp + warp;
    // a group's loads before its stores: the compiler cannot tell the two
    // buffers apart, so a store keeps every later load behind it; groups
    // of kReplayGroup pairs keep the registers within three CTAs an SM
#pragma unroll
    for (int j0 = 0; j0 < kReplayMaxPairs; j0 += kReplayGroup) {
      if (j0 >= npairs) break;
      float2 r[kReplayGroup];
      float x[kReplayGroup], y[kReplayGroup];
#pragma unroll
      for (int i = 0; i < kReplayGroup; ++i) {
        const int j = j0 + i;
        if (j < kReplayMaxPairs && j < npairs) {
          r[i] = cs[j * kReplayWarps];
          x[i] = cur[tid + j * kReplayThreads];
          y[i] = cur[hoff + tid + j * kReplayThreads];
        }
      }
#pragma unroll
      for (int i = 0; i < kReplayGroup; ++i) {
        const int j = j0 + i;
        if (j < kReplayMaxPairs && j < npairs) {
          nxt[dst[j][0]] = rot_lo_fma(r[i].x, r[i].y, x[i], y[i]);
          nxt[dst[j][1]] = rot_hi_fma(r[i].x, r[i].y, x[i], y[i]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float* V = steps & 1 ? B1 : B0;
  const int cols = min(kReplayCols, n - col0);
  for (int i = tid; i < n * kReplayCols; i += kReplayThreads) {
    const int r = i / kReplayCols, l = i - r * kReplayCols;
    if (l < cols) vt_out[(long long)b * n * n + (long long)r * n + col0 + l] = V[i];
  }
}

int launch_replay(const void* log, void* vt, int batch, int n, int steps, void* stream) {
  if (n < 4 || n > kMaxNPacked || n % 2 != 0 || batch <= 0 || batch > 65535 ||
      (steps > 0 && log == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = replay_smem(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_vt_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kReplayCols - 1) / kReplayCols, batch);
  jacobi_vt_replay_kernel<<<grid, kReplayThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)log, (float*)vt, n, steps);
  return (int)cudaGetLastError();
}

}  // namespace

// K3, the kPingPong route at even n <= 96.
extern "C" int basd_jacobi_eigh_pingpong(const void* a, void* w, void* vt, int batch,
                                         int n, int steps, void* stream) {
  if (n < 4 || n > kMaxNPingPong || n % 2 != 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_pingpong<4>(a, w, vt, batch, n, steps, stream);
}

// K3, the kPackedLog route at even n <= 238, first launch: the eigenvalues
// (K5's kernel and bits) and the rotation log, (batch, steps,
// log_pairs(n)) float2 that the wrapper allocates.
extern "C" int basd_jacobi_eigh_packed_log(const void* a, void* w, void* log, int batch,
                                           int n, int steps, void* stream) {
  return launch_packed<true>(a, w, log, batch, n, steps, stream);
}

// K3, the kPackedLog route, second launch: V^T from the first launch's log.
extern "C" int basd_jacobi_eigh_vt_replay(const void* log, void* vt, int batch, int n,
                                          int steps, void* stream) {
  return launch_replay(log, vt, batch, n, steps, stream);
}

// K5, eigenvalues only: the kPacked route at even n <= 238, n at run time
// except at kPackedFixedN, which has an instantiation of its own.
extern "C" int basd_jacobi_eigvals_packed(const void* a, void* w, int batch, int n,
                                          int steps, void* stream) {
  return launch_packed<false>(a, w, nullptr, batch, n, steps, stream);
}
