// The Cholesky layout study: four alternative layouts of the batched SPD
// factor and solve, float32, the counterparts of the experiment kernels in
// experiments/. None is on a fit or resolve path; each computes the function
// of a production kernel (chol_lane.cu) in another layout, so that the two
// can be timed against each other at the fit's shape.
//
//   experiments/pallas_chol_lane_blocked.py::chol_factor_solve_lane_blocked
//       -> chol_factor_solve_lane_blocked_f32   (#1's function and contract)
//   experiments/pallas_chol_column.py::chol_solve_batched
//       -> chol_solve_batched_f32               (x only, zero-pivot contract)
//   experiments/pallas_chol_blocked.py::chol_solve_blocked
//       -> chol_solve_blocked_f32               (x only, zero-pivot contract)
//   experiments/vmem_sol.py::main.sol
//       -> smem_sol_f32                         (speed-of-light probe)
//
// The TPU kernels padded the batch to its 128 lanes or to their tile and n
// to 128 with a decoupled identity block; neither padding is ported, since
// it changes no result. Every kernel here keeps each matrix in shared memory
// with the odd row stride ld = n | 1 (lane_common.cuh), reads it from device
// memory once and writes each output once.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s float32) at B=8192,
// n=93: device memory, by a wide margin: 0.1710 ms for the factor-solve
// (read A and b, write L and x), 0.0864 ms for the two solves (read A and b,
// write x), 0.169 ms for the probe (read A, write the result), against about
// 0.04 ms for the n^3/6 multiply-adds. The lane kernels run at 5-16 % of
// that bound; the layouts here test three answers to the question of what
// holds them back (block barriers, one matrix per block, the per-column
// read-modify-write of the trailing block), and the probe measures the
// access pattern and barriers of the production factor without its math.
//
// Each launcher returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.

#include "lane_common.cuh"

namespace {

using namespace hybdrt_lane;

constexpr int kMaxPanel = 32;      // a diagonal block is factored by one warp
constexpr int kMaxWarps = 32;      // matrices per block of the warp layouts
constexpr float kSolScale = 0.999f;

// ---------------------------------------------------------------------------
// chol_factor_solve_lane_blocked: panel-blocked factor, then both solves.
//
// The TPU kernel factored each kb-column panel column by column and then
// applied the panel's kb rank-1 terms to the trailing block in one fused
// pass. Here one block per matrix (as chol_lane.cu), three block barriers
// per panel instead of two per column (about 36 against 186 at n=93, kb=8):
//   1. warp 0 factors the panel's kb x kb diagonal block (warp barriers
//      only) and keeps the refined inverse pivots;
//   2. one thread per row below the panel finishes its kb panel entries by
//      substitution against that block (the same products, in the same
//      order, as the right-looking column loop);
//   3. the trailing lower triangle is updated once per panel, each element
//      read once and written once, its kb products summed in a register.
// The contract is chol_factor_solve_lane's: refined rsqrt, NaN from a
// non-positive pivot on, only the lower triangle of L valid (the upper one
// keeps the input; the TPU kernel left other leftovers there).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
factor_solve_blocked_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            float* __restrict__ x, float* __restrict__ l, int n, int ld,
                            int kb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);
  float* w = s + n * ld;
  float* dinv = w + n;
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  load_matrix(a + m_off, s, n, ld);
  for (int i = threadIdx.x; i < n; i += blockDim.x) w[i] = b[v_off + i];
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += kb) {
    const int j1 = min(j0 + kb, n);
    const int width = j1 - j0;
    if (warp == 0) {
      // lane c owns row j0 + c of the diagonal block
      const int r = j0 + lane;
      for (int k = 0; k < width; ++k) {
        const int j = j0 + k;
        const float ajj = s[j * ld + j];
        const float inv = refined_rsqrt(ajj);
        __syncwarp();
        if (lane == k) {
          s[j * ld + j] = ajj * inv;
          dinv[k] = inv;
        } else if (lane > k && lane < width) {
          s[r * ld + j] *= inv;
        }
        __syncwarp();
        if (lane > k && lane < width) {
          const float lr = s[r * ld + j];
          for (int c = j + 1; c <= r; ++c) s[r * ld + c] -= lr * s[c * ld + j];
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int r = j1 + threadIdx.x; r < n; r += blockDim.x) {
      float* row = s + r * ld;
      for (int k = 0; k < width; ++k) {
        const int j = j0 + k;
        const float v = row[j] * dinv[k];
        row[j] = v;
        for (int c = j + 1; c < j1; ++c) row[c] -= v * s[c * ld + j];
      }
    }
    __syncthreads();
    if (j1 < n) {
      for (int r = j1 + warp; r < n; r += n_warps) {
        const float* lr = s + r * ld + j0;
        for (int c = j1 + lane; c <= r; c += 32) {
          const float* lc = s + c * ld + j0;
          float acc = 0.f;
          for (int k = 0; k < width; ++k) acc += lr[k] * lc[k];
          s[r * ld + c] -= acc;
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x < 32) substitute_warp(s, w, n, ld);
  store_matrix(s, l + m_off, n, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[v_off + i] = w[i];
}

// ---------------------------------------------------------------------------
// The warp layouts: chol_solve_batched and chol_solve_blocked.
//
// Several matrices per block, one warp per matrix, no block barrier at all:
// each warp loads its matrix, factors it, solves and stores x, synchronised
// by __syncwarp only. block_batch warps share a block; shared memory bounds
// it (6 matrices of n=93 in float32, 209,808 bytes).
//
// Their contract is the TPU experiments', not the lane kernels': the pivot
// is a plain rsqrt, a non-positive pivot gives an inverse of 0 and so a zero
// column and no update, and the substitutions divide by 1 where L_jj = 0. A
// failed lane thus returns finite numbers (x = b where every pivot fails).
// ---------------------------------------------------------------------------
__device__ __forceinline__ float zero_pivot_inv(float ajj) {
  return ajj > 0.f ? rsqrtf(fmaxf(ajj, 1e-30f)) : 0.f;
}

__device__ __forceinline__ float pivot_guard(float ljj) { return ljj != 0.f ? ljj : 1.f; }

__device__ __forceinline__ void load_matrix_warp(const float* __restrict__ g, float* s, int n,
                                                 int ld, int lane) {
  for (int idx = lane; idx < n * n; idx += 32) {
    const int r = idx / n;
    s[r * ld + idx - r * n] = g[idx];
  }
}

// Column j of the right-looking loop on the warp's matrix, first half:
// scale column j (rows j..n-1) by the inverse pivot.
__device__ __forceinline__ void scale_column_warp(float* s, int j, int n, int ld, int lane) {
  const float inv = zero_pivot_inv(s[j * ld + j]);
  __syncwarp();
  for (int i = j + lane; i < n; i += 32) s[i * ld + j] *= inv;
  __syncwarp();
}

// Second half, the unblocked loop's: subtract column j's rank-1 term from
// the trailing lower triangle (r, c), j < c <= r, the lanes across a row.
__device__ __forceinline__ void update_trailing_warp(float* s, int j, int n, int ld,
                                                     int lane) {
  for (int r = j + 1; r < n; ++r) {
    const float lr = s[r * ld + j];
    for (int c = j + 1 + lane; c <= r; c += 32) s[r * ld + c] -= lr * s[c * ld + j];
  }
  __syncwarp();
}

// Second half, the blocked loop's: the same within the panel's columns
// (c < j1) only, a lane per row, since a panel is narrower than a warp.
__device__ __forceinline__ void update_panel_warp(float* s, int j, int j1, int n, int ld,
                                                  int lane) {
  for (int r = j + 1 + lane; r < n; r += 32) {
    const float lr = s[r * ld + j];
    const int ce = min(r + 1, j1);
    for (int c = j + 1; c < ce; ++c) s[r * ld + c] -= lr * s[c * ld + j];
  }
  __syncwarp();
}

// The blocked layout's trailing update A22 -= U U^T, U = L[j1:, j0:j1], on
// the lower triangle of rows and columns j1..n-1: one lane per 4 x 4 tile of
// the output, the tile's 16 sums in registers over the panel's columns.
__device__ void panel_product_warp(float* s, int j0, int j1, int n, int ld, int lane) {
  const int tiles = (n - j1 + 3) / 4;
  const int n_tiles = tiles * (tiles + 1) / 2;
  for (int t = lane; t < n_tiles; t += 32) {
    // t = ti (ti + 1) / 2 + tj with tj <= ti
    int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (ti * (ti + 1) / 2 > t) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int r0 = j1 + 4 * ti;
    const int c0 = j1 + 4 * (t - ti * (ti + 1) / 2);
    float acc[4][4] = {};
    for (int k = j0; k < j1; ++k) {
      float ur[4], uc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ur[i] = r0 + i < n ? s[(r0 + i) * ld + k] : 0.f;
        uc[i] = c0 + i < n ? s[(c0 + i) * ld + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += ur[i] * uc[q];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + i, c = c0 + q;
        if (r < n && c <= r) s[r * ld + c] -= acc[i][q];
      }
  }
  __syncwarp();
}

// (L L^T) x = w in place with the division guard, on the warp's matrix.
__device__ void substitute_guarded_warp(const float* l, float* w, int n, int ld, int lane) {
  for (int j = 0; j < n; ++j) {
    const float yj = w[j] / pivot_guard(l[j * ld + j]);
    __syncwarp();
    if (lane == 0) w[j] = yj;
    for (int i = j + 1 + lane; i < n; i += 32) w[i] -= yj * l[i * ld + j];
    __syncwarp();
  }
  for (int j = n - 1; j >= 0; --j) {
    const float xj = w[j] / pivot_guard(l[j * ld + j]);
    __syncwarp();
    if (lane == 0) w[j] = xj;
    const float* row = l + j * ld;
    for (int i = lane; i < j; i += 32) w[i] -= row[i] * xj;
    __syncwarp();
  }
}

// nb = 0: the unblocked column loop (chol_solve_batched); nb > 0: panels of
// nb columns, each factored column by column within the panel and then
// applied to the trailing block as one product (chol_solve_blocked).
__global__ void __launch_bounds__(kMaxWarps * 32)
warp_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ x, int batch, int n, int ld, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= batch) return;  // whole warps leave; nothing below waits for them
  float* s = reinterpret_cast<float*>(smem_raw) + warp * (n * ld + n);
  float* w = s + n * ld;
  const size_t m_off = static_cast<size_t>(m) * n * n;
  const size_t v_off = static_cast<size_t>(m) * n;
  load_matrix_warp(a + m_off, s, n, ld, lane);
  for (int i = lane; i < n; i += 32) w[i] = b[v_off + i];
  __syncwarp();
  if (nb == 0) {
    for (int j = 0; j < n; ++j) {
      scale_column_warp(s, j, n, ld, lane);
      update_trailing_warp(s, j, n, ld, lane);
    }
  } else {
    for (int j0 = 0; j0 < n; j0 += nb) {
      const int j1 = min(j0 + nb, n);
      for (int j = j0; j < j1; ++j) {
        scale_column_warp(s, j, n, ld, lane);
        update_panel_warp(s, j, j1, n, ld, lane);
      }
      if (j1 < n) panel_product_warp(s, j0, j1, n, ld, lane);
    }
  }
  substitute_guarded_warp(s, w, n, ld, lane);
  for (int i = lane; i < n; i += 32) x[v_off + i] = w[i];
}

// ---------------------------------------------------------------------------
// smem_sol: the speed-of-light probe of the lane factor.
//
// The grid, block size, shared memory (the same bytes), column loop and the
// two __syncthreads per column of the shared-memory column factor that the
// lane kernels ran before their register-tiled design (lane_regs.cuh), and
// the same elements touched: column j from the diagonal down, then the
// trailing lower triangle. Each touched element is only scaled by 0.999
// (one read, one multiply, one write), so element (r, c) of the lower
// triangle comes out scaled by 0.999^(c+1). The TPU probe also scaled the
// upper part of each trailing block, because its factor updated it; the
// port's factor updates the lower triangle only, and so does its probe. Its
// time over chol_factor_lane's is the share of the factor's time that is
// access pattern and barriers rather than arithmetic.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sol_kernel(const float* __restrict__ a, float* __restrict__ o, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  load_matrix(a + m_off, s, n, ld);
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    for (int i = j + threadIdx.x; i < n; i += blockDim.x) s[i * ld + j] *= kSolScale;
    __syncthreads();
    for (int r = j + 1 + warp; r < n; r += n_warps) {
      float* row = s + r * ld;
      for (int c = j + 1 + lane; c <= r; c += 32) row[c] *= kSolScale;
    }
    __syncthreads();
  }
  store_matrix(s, o + m_off, n, ld);
}

inline size_t lane_matrix_floats(int n) {
  return static_cast<size_t>(n) * row_stride(n) + n;
}

int launch_factor_solve_blocked(const void* a, const void* b, void* x, void* l, int batch,
                                int n, int kb, void* stream) {
  if (batch == 0) return 0;
  if (kb < 1 || kb > kMaxPanel) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * (lane_matrix_floats(n) + kMaxPanel);
  int err = allow_smem(factor_solve_blocked_kernel, bytes);
  if (err) return err;
  factor_solve_blocked_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(x),
      static_cast<float*>(l), n, row_stride(n), kb);
  return static_cast<int>(cudaGetLastError());
}

int launch_warp_solve(const void* a, const void* b, void* x, int batch, int n,
                      int block_batch, int nb, void* stream) {
  if (batch == 0) return 0;
  if (block_batch < 1 || block_batch > kMaxWarps || nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * block_batch * lane_matrix_floats(n);
  int err = allow_smem(warp_solve_kernel, bytes);
  if (err) return err;
  const int blocks = (batch + block_batch - 1) / block_batch;
  warp_solve_kernel<<<blocks, 32 * block_batch, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(x), batch,
      n, row_stride(n), nb);
  return static_cast<int>(cudaGetLastError());
}

int launch_sol(const void* a, void* o, int batch, int n, void* stream) {
  if (batch == 0) return 0;
  // chol_factor_lane's bytes (matrix and its column vector), so that the
  // probe runs at the factor's occupancy
  const size_t bytes = sizeof(float) * (lane_matrix_floats(n) + n);
  int err = allow_smem(sol_kernel, bytes);
  if (err) return err;
  sol_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(o), n, row_stride(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int chol_factor_solve_lane_blocked_f32(const void* a, const void* b, void* x, void* l,
                                       int batch, int n, int kb, void* stream) {
  return launch_factor_solve_blocked(a, b, x, l, batch, n, kb, stream);
}
int chol_solve_batched_f32(const void* a, const void* b, void* x, int batch, int n,
                           int block_batch, void* stream) {
  return launch_warp_solve(a, b, x, batch, n, block_batch, 0, stream);
}
int chol_solve_blocked_f32(const void* a, const void* b, void* x, int batch, int n,
                           int block_batch, int nb, void* stream) {
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_warp_solve(a, b, x, batch, n, block_batch, nb, stream);
}
int smem_sol_f32(const void* a, void* o, int batch, int n, void* stream) {
  return launch_sol(a, o, batch, n, stream);
}
}  // extern "C"
