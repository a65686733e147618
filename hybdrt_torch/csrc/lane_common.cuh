// Device helpers shared by the lane kernels (chol_lane.cu, ip_lane.cu,
// chol_layouts.cu, and lane_regs.cuh): the refined pivot, and for the
// kernels that keep one (n, n) matrix per thread block in shared memory (row
// stride ld = n | 1, odd, so that column walks hit distinct banks) its load,
// store and the one-warp substitution.
//
// The factor's contract is the TPU kernels' (hybdrt_tpu/ops/pallas_chol_lane.py):
// only the lower triangle of the factor is valid, the upper triangle keeps
// the input; the pivot is rsqrt refined by one Newton step on max(x, 1e-30),
// and a non-positive pivot yields NaN, which then fills the rest of the
// factor and every solution computed from it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hybdrt_lane {

constexpr int kThreads = 256;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ T refined_rsqrt(T x) {
  T xm = x > T(1e-30) ? x : T(1e-30);
  T r = rsqrt_t(xm);
  r = r * (T(1.5) - T(0.5) * xm * r * r);
  return x > T(0) ? r : T(NAN);
}

template <typename T>
__device__ __forceinline__ void load_matrix(const T* __restrict__ g, T* s, int n, int ld) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    int r = idx / n;
    int c = idx - r * n;
    s[r * ld + c] = g[idx];
  }
}

template <typename T>
__device__ __forceinline__ void store_matrix(const T* s, T* __restrict__ g, int n, int ld) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    int r = idx / n;
    int c = idx - r * n;
    g[idx] = s[r * ld + c];
  }
}

// Solve (L L^T) x = w in place, L the lower triangle of the shared matrix.
// Runs on warp 0 only (the caller synchronises the block before and after).
template <typename T>
__device__ void substitute_warp(const T* l, T* w, int n, int ld) {
  const int lane = threadIdx.x & 31;
  // Forward: L y = w, column-oriented.
  for (int j = 0; j < n; ++j) {
    const T yj = w[j] / l[j * ld + j];
    __syncwarp();
    if (lane == 0) w[j] = yj;
    for (int i = j + 1 + lane; i < n; i += 32) w[i] -= yj * l[i * ld + j];
    __syncwarp();
  }
  // Backward: L^T x = y, column-oriented over the rows of L.
  for (int j = n - 1; j >= 0; --j) {
    const T xj = w[j] / l[j * ld + j];
    __syncwarp();
    if (lane == 0) w[j] = xj;
    const T* row = l + j * ld;
    for (int i = lane; i < j; i += 32) w[i] -= row[i] * xj;
    __syncwarp();
  }
}

inline int row_stride(int n) { return n | 1; }

template <typename K>
inline int allow_smem(K kernel, size_t bytes) {
  // Above 48 KB a block may only use dynamic shared memory after opting in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return static_cast<int>(err);
}

}  // namespace hybdrt_lane
