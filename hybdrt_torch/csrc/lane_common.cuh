// Device helpers shared by the lane kernels (chol_lane.cu, ip_lane.cu,
// chol_layouts.cu, and lane_regs.cuh): the refined pivot; where the rows of
// a packed lower triangle in shared memory start; and the one-warp
// substitution, which chol_solve_factored_lane runs on it.
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

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ T refined_rsqrt(T x) {
  T xm = x > T(1e-30) ? x : T(1e-30);
  T r = rsqrt_t(xm);
  r = r * (T(1.5) - T(0.5) * xm * r * r);
  return x > T(0) ? r : T(NAN);
}

// Where row r of a lower triangle packed by rows in shared memory starts.
struct PackedRows {
  __device__ __forceinline__ int operator()(int r) const { return r * (r + 1) / 2; }
};

// Solve (L L^T) x = w in place, L the lower triangle in shared memory with
// its rows where `rows` puts them. Runs on one warp (the caller makes w and
// L visible to the warp before and reads w after it).
template <typename T, typename Rows>
__device__ void substitute_warp(const T* l, T* w, int n, Rows rows) {
  const int lane = threadIdx.x & 31;
  // Forward: L y = w, column-oriented.
  for (int j = 0; j < n; ++j) {
    const T yj = w[j] / l[rows(j) + j];
    __syncwarp();
    if (lane == 0) w[j] = yj;
    for (int i = j + 1 + lane; i < n; i += 32) w[i] -= yj * l[rows(i) + j];
    __syncwarp();
  }
  // Backward: L^T x = y, column-oriented over the rows of L.
  for (int j = n - 1; j >= 0; --j) {
    const T* row = l + rows(j);
    const T xj = w[j] / row[j];
    __syncwarp();
    if (lane == 0) w[j] = xj;
    for (int i = lane; i < j; i += 32) w[i] -= row[i] * xj;
    __syncwarp();
  }
}

template <typename K>
inline int allow_smem(K kernel, size_t bytes) {
  // Above 48 KB a block may only use dynamic shared memory after opting in.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return static_cast<int>(err);
}

}  // namespace hybdrt_lane
