// Batch-parallel cyclic Jacobi eigendecomposition (K3) and eigenvalues-only
// variant (K5) of small symmetric fp32 matrices, for the BASD selector and
// the spectral tools on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_jacobi_kernel` (K3) and
// `_jacobi_eigvals_kernel` (K5) of basd_tpu/spectral/pallas_jacobi.py
// (step math in basd_tpu/spectral/jacobi.py) and runs the same sequence of
// rotations: positions are paired (i, i + n/2); each step computes the n/2
// rotations (c, s) with `pair_rotations`' formula (including its 1e-30
// guard), applies A <- J^T A J, rotates V^T <- J^T V^T (K3 only), and then
// applies the half-shift round-robin permutation
//     new = [x_0, x_h, x_1..x_{h-2}, x_{h+1}..x_{n-1}, x_{h-1}]
// to the positions. Here the permutation is an index map (logical
// position -> row of the shared-memory matrix) instead of a data move; the
// rotations and their order are unchanged. After (n - 1) * sweeps steps the
// diagonal holds the eigenvalues and V^T the eigenvectors, both written in
// logical order; sorting and stripping an odd-n pad stay in the wrapper.
//
// What bounds it here: the work is tiny (about 9 n^2 flops per step with
// V, 6 n^2 without) and the bytes are one read of A and one write of w and
// V^T, but the (n - 1) * sweeps steps form a chain of dependent phases
// (282 steps at n = 48, six sweeps; 1,719 at n = 192, nine sweeps), each
// ending in a block-wide barrier. So it is latency-bound: one CTA per
// matrix so every matrix of the batch runs at once on its own SM, A
// resident in shared memory for the whole run, and two barriers per step.
// Each thread updates whole 2x2 blocks {p, q} x {r, s} of A in place, so
// the row and column rotations need no second buffer and no extra barrier.
// Three routes by what fits in a CTA's 227 KB of shared memory:
//   * kVtShared (K3, n <= 168): A and V^T both in shared memory (2 n^2);
//   * kVtGlobal (K3, 168 < n <= 238): A in shared memory, V^T in a
//     device-memory scratch of n^2 per matrix that the wrapper allocates;
//     its rows are rotated in place through L2 (7 MB at (48, 192, 192)),
//     and the final logical-order copy goes to vt_out;
//   * kNoVt (K5, n <= 238): A alone, no eigenvector accumulator.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math: IEEE division and sqrt).

#include <cuda_runtime.h>

namespace {

enum Route { kVtShared = 0, kVtGlobal = 1, kNoVt = 2 };

// the shared-memory route keeps K3's original 512 threads; the A-only
// routes run n = 192 (18 2x2 blocks per thread at 512) with 1024
template <int kRoute>
__host__ __device__ constexpr int threads_of() { return kRoute == kVtShared ? 512 : 1024; }

constexpr int kMaxSharedBytes = 232448;  // 227 KB, sm_90

template <int kRoute>
size_t smem_bytes(int n) {
  const size_t mats = kRoute == kVtShared ? 2 : 1;
  return sizeof(float) * (mats * (size_t)n * n + n) + sizeof(int) * 2 * (size_t)n;
}

template <int kRoute>
__global__ void __launch_bounds__(threads_of<kRoute>())
jacobi_kernel(const float* __restrict__ a_in, float* __restrict__ w_out,
              float* __restrict__ vt_out, float* __restrict__ vt_scratch,
              int n, int steps) {
  constexpr int kThreads = threads_of<kRoute>();
  extern __shared__ float smem[];
  const int h = n / 2;
  const long long base = (long long)blockIdx.x * n * n;
  float* A = smem;                                        // n x n, physical
  float* VT = kRoute == kVtShared ? A + n * n             // n x n, physical
            : kRoute == kVtGlobal ? vt_scratch + base : nullptr;
  float* cs = A + (kRoute == kVtShared ? 2 : 1) * n * n;  // h
  float* sn = cs + h;                                     // h
  int* pos = (int*)(sn + h);  // 2 x n: logical -> physical, double buffer
  const int tid = threadIdx.x;

  for (int i = tid; i < n * n; i += kThreads) {
    A[i] = a_in[base + i];
    if (kRoute != kNoVt) {
      const int r = i / n;
      VT[i] = (r == i - r * n) ? 1.f : 0.f;
    }
  }
  for (int i = tid; i < n; i += kThreads) pos[i] = i;
  __syncthreads();

  int cur = 0;
  for (int step = 0; step < steps; ++step) {
    const int* P = pos + cur * n;
    int* Pn = pos + (1 - cur) * n;

    // (c, s) for the logical pairs (i, i + h): pair_rotations
    for (int i = tid; i < h; i += kThreads) {
      const int p = P[i], q = P[i + h];
      const float app = A[p * n + p];
      const float aqq = A[q * n + q];
      const float apq = A[p * n + q];
      const bool safe = fabsf(apq) > 1e-30f;
      const float tau = (aqq - app) / (safe ? 2.0f * apq : 1.0f);
      const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
      const float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
      const float c = 1.0f / sqrtf(1.0f + t * t);
      const float s = t * c;
      cs[i] = safe ? c : 1.0f;
      sn[i] = safe ? s : 0.0f;
    }
    __syncthreads();

    // A <- J^T A J, one 2x2 block per thread: rows first (apply_rows),
    // then columns (apply_cols)
    for (int idx = tid; idx < h * h; idx += kThreads) {
      const int ri = idx / h, ci = idx - ri * h;
      const int r0 = P[ri], r1 = P[ri + h], c0 = P[ci], c1 = P[ci + h];
      const float a00 = A[r0 * n + c0], a01 = A[r0 * n + c1];
      const float a10 = A[r1 * n + c0], a11 = A[r1 * n + c1];
      const float cr = cs[ri], sr = sn[ri], cc = cs[ci], sc = sn[ci];
      const float t0 = cr * a00 - sr * a10, t1 = cr * a01 - sr * a11;
      const float b0 = sr * a00 + cr * a10, b1 = sr * a01 + cr * a11;
      A[r0 * n + c0] = cc * t0 - sc * t1;
      A[r0 * n + c1] = sc * t0 + cc * t1;
      A[r1 * n + c0] = cc * b0 - sc * b1;
      A[r1 * n + c1] = sc * b0 + cc * b1;
    }
    // V^T <- J^T V^T on the logical row pairs (the barrier below makes the
    // scratch's global writes visible to the whole block, as for shared)
    if (kRoute != kNoVt) {
      for (int idx = tid; idx < h * n; idx += kThreads) {
        const int i = idx / n, col = idx - i * n;
        const int r0 = P[i], r1 = P[i + h];
        const float top = VT[r0 * n + col], bot = VT[r1 * n + col];
        const float c = cs[i], s = sn[i];
        VT[r0 * n + col] = c * top - s * bot;
        VT[r1 * n + col] = s * top + c * bot;
      }
    }
    // half-shift permutation of the logical positions
    for (int j = tid; j < n; j += kThreads) {
      int src;
      if (j == 0) src = 0;
      else if (j == 1) src = h;
      else if (j < h) src = j - 1;
      else if (j < n - 1) src = j + 1;
      else src = h - 1;
      Pn[j] = P[src];
    }
    __syncthreads();
    cur ^= 1;
  }

  const int* P = pos + cur * n;
  for (int i = tid; i < n; i += kThreads) {
    const int p = P[i];
    w_out[(long long)blockIdx.x * n + i] = A[p * n + p];
  }
  if (kRoute != kNoVt) {
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, col = idx - i * n;
      vt_out[base + idx] = VT[P[i] * n + col];
    }
  }
}

template <int kRoute>
int launch(const void* a, void* w, void* vt, void* scratch, int batch, int n,
           int steps, void* stream) {
  const size_t smem = smem_bytes<kRoute>(n);
  if (n < 4 || n % 2 != 0 || batch <= 0 || smem > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_kernel<kRoute>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  jacobi_kernel<kRoute><<<batch, threads_of<kRoute>(), smem, (cudaStream_t)stream>>>(
      (const float*)a, (float*)w, (float*)vt, (float*)scratch, n, steps);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: eigenvalues and V^T. `scratch` is null when A and V^T fit in shared
// memory together (n <= 168); above that it holds batch x n x n floats.
extern "C" int basd_jacobi_eigh(const void* a, void* w, void* vt,
                                void* scratch, int batch, int n, int steps,
                                void* stream) {
  if (scratch == nullptr)
    return launch<kVtShared>(a, w, vt, nullptr, batch, n, steps, stream);
  return launch<kVtGlobal>(a, w, vt, scratch, batch, n, steps, stream);
}

// K5: eigenvalues only.
extern "C" int basd_jacobi_eigvals(const void* a, void* w, int batch, int n,
                                   int steps, void* stream) {
  return launch<kNoVt>(a, w, nullptr, nullptr, batch, n, steps, stream);
}
