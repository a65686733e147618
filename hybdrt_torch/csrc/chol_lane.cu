// Batched small-matrix Cholesky kernels for the interior-point QP solves.
//
// Replaces the four TPU kernels of hybdrt_tpu/ops/pallas_chol_lane.py:
//   chol_factor_solve_lane   (:277) -> chol_factor_solve_lane_{f32,f64}
//   chol_solve_factored_lane (:208) -> chol_solve_factored_lane_{f32,f64}
//   chol_solve_lane          (:95)  -> chol_solve_lane_{f32,f64}
//   chol_factor_lane         (:178) -> chol_factor_lane_{f32,f64}
//
// The TPU kernels put 128 matrices in the vector lanes, (n, n, 128), and
// unrolled the column loop statically. On Hopper the design is one thread
// block per matrix: the block copies its (n, n) row-major matrix from device
// memory into shared memory (row stride ld = n | 1, odd, so column walks hit
// distinct banks), runs a right-looking column loop there, and does both
// substitutions in the same block. The factor and substitution loops are in
// lane_common.cuh, shared with the fused interior-point kernel (ip_lane.cu).
//
// Contract (kept exactly from the TPU kernels):
//   * only the lower triangle of a returned factor is valid; the upper
//     triangle holds the leftover input;
//   * the pivot is rsqrt refined by one Newton step r * (1.5 - 0.5 x r^2) on
//     max(x, 1e-30), and a non-positive pivot yields NaN, which then fills the
//     rest of the factorization and the solution (the QP's bad-step guard
//     depends on it).
//
// What bounds it: the n^3/3 fused multiply-adds of the trailing updates, each
// a shared-memory read-modify-write (n = 93: ~2.7e5 updates per matrix), plus
// two __syncthreads per column. Device memory traffic is one read of the
// matrix and, for the kernels that return a factor, one write. The design answers that by
// updating only the lower triangle of the trailing block (half the traffic of
// a full update, as the TPU kernels' banded update did) and by keeping the
// scaled column in its own shared vector, so the update reads it as a
// broadcast instead of as a strided column of the matrix. Several matrices
// per block, register tiles and warp-level panels are left for later work.
//
// Each launcher returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.

#include "lane_common.cuh"

namespace {

using namespace hybdrt_lane;

template <typename T>
struct Smem {
  T* a;
  T* col;
  T* w;
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* raw, int n, int ld) {
  T* base = reinterpret_cast<T*>(raw);
  return {base, base + n * ld, base + n * ld + n};
}

// x = a^-1 b and L = chol(a) (lower triangle valid).
template <typename T>
__global__ void __launch_bounds__(kThreads)
factor_solve_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ x, T* __restrict__ l, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s = carve<T>(smem_raw, n, ld);
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  load_matrix(a + m_off, s.a, n, ld);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.w[i] = b[v_off + i];
  __syncthreads();
  factor_in_place(s.a, s.col, n, ld);
  if (threadIdx.x < 32) substitute_warp(s.a, s.w, n, ld);
  store_matrix(s.a, l + m_off, n, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[v_off + i] = s.w[i];
}

// L = chol(a) (lower triangle valid). The input is only read: the resolve
// re-factors the same diagonal blocks at every interior-point step, where
// the TPU kernel factored a fresh transpose it was free to overwrite.
template <typename T>
__global__ void __launch_bounds__(kThreads)
factor_kernel(const T* __restrict__ a, T* __restrict__ l, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s = carve<T>(smem_raw, n, ld);
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  load_matrix(a + m_off, s.a, n, ld);
  __syncthreads();
  factor_in_place(s.a, s.col, n, ld);
  store_matrix(s.a, l + m_off, n, ld);
}

// x = a^-1 b (the factor stays in shared memory).
template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ x,
             int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s = carve<T>(smem_raw, n, ld);
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  load_matrix(a + m_off, s.a, n, ld);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.w[i] = b[v_off + i];
  __syncthreads();
  factor_in_place(s.a, s.col, n, ld);
  if (threadIdx.x < 32) substitute_warp(s.a, s.w, n, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[v_off + i] = s.w[i];
}

// x = (L L^T)^-1 b against a factor from factor_solve_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_factored_kernel(const T* __restrict__ l, const T* __restrict__ b,
                      T* __restrict__ x, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s = carve<T>(smem_raw, n, ld);
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  load_matrix(l + m_off, s.a, n, ld);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.w[i] = b[v_off + i];
  __syncthreads();
  if (threadIdx.x < 32) substitute_warp(s.a, s.w, n, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[v_off + i] = s.w[i];
}

template <typename T>
inline size_t smem_bytes(int n) {
  const int ld = row_stride(n);
  return sizeof(T) * (static_cast<size_t>(n) * ld + 2 * static_cast<size_t>(n));
}

template <typename T>
int launch_factor_solve(const void* a, const void* b, void* x, void* l, int batch, int n,
                        void* stream) {
  if (batch == 0) return 0;
  const size_t bytes = smem_bytes<T>(n);
  int err = allow_smem(factor_solve_kernel<T>, bytes);
  if (err) return err;
  factor_solve_kernel<T><<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<T*>(l), n, row_stride(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_factor(const void* a, void* l, int batch, int n, void* stream) {
  if (batch == 0) return 0;
  const size_t bytes = smem_bytes<T>(n);
  int err = allow_smem(factor_kernel<T>, bytes);
  if (err) return err;
  factor_kernel<T><<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(l), n, row_stride(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const void* a, const void* b, void* x, int batch, int n, void* stream) {
  if (batch == 0) return 0;
  const size_t bytes = smem_bytes<T>(n);
  int err = allow_smem(solve_kernel<T>, bytes);
  if (err) return err;
  solve_kernel<T><<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x), n,
      row_stride(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve_factored(const void* l, const void* b, void* x, int batch, int n,
                          void* stream) {
  if (batch == 0) return 0;
  const size_t bytes = smem_bytes<T>(n);
  int err = allow_smem(solve_factored_kernel<T>, bytes);
  if (err) return err;
  solve_factored_kernel<T><<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(b), static_cast<T*>(x), n,
      row_stride(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int chol_factor_solve_lane_f32(const void* a, const void* b, void* x, void* l, int batch,
                               int n, void* stream) {
  return launch_factor_solve<float>(a, b, x, l, batch, n, stream);
}
int chol_factor_solve_lane_f64(const void* a, const void* b, void* x, void* l, int batch,
                               int n, void* stream) {
  return launch_factor_solve<double>(a, b, x, l, batch, n, stream);
}
int chol_factor_lane_f32(const void* a, void* l, int batch, int n, void* stream) {
  return launch_factor<float>(a, l, batch, n, stream);
}
int chol_factor_lane_f64(const void* a, void* l, int batch, int n, void* stream) {
  return launch_factor<double>(a, l, batch, n, stream);
}
int chol_solve_lane_f32(const void* a, const void* b, void* x, int batch, int n,
                        void* stream) {
  return launch_solve<float>(a, b, x, batch, n, stream);
}
int chol_solve_lane_f64(const void* a, const void* b, void* x, int batch, int n,
                        void* stream) {
  return launch_solve<double>(a, b, x, batch, n, stream);
}
int chol_solve_factored_lane_f32(const void* l, const void* b, void* x, int batch, int n,
                                 void* stream) {
  return launch_solve_factored<float>(l, b, x, batch, n, stream);
}
int chol_solve_factored_lane_f64(const void* l, const void* b, void* x, int batch, int n,
                                 void* stream) {
  return launch_solve_factored<double>(l, b, x, batch, n, stream);
}
}  // extern "C"
