// The register-tiled lane Cholesky: one thread block per (n, n) matrix, its
// lower triangle held in registers for the whole factorization and for the
// substitutions against it. Used by chol_factor_solve_lane, chol_solve_lane
// and chol_factor_lane (chol_lane.cu), by the fused interior-point steps
// (ip_lane.cu), and by the layout study's speed-of-light probe
// (chol_layouts.cu::sol_kernel), which runs factor_regs with its arithmetic
// (CholMath) swapped out. chol_solve_factored_lane substitutes with one warp
// instead (chol_lane.cu).
//
// Layout. The lower triangle is cut into 4x4 tiles (I, K), K <= I < nt =
// ceil(n / 4), padded past n with zeros. Tile t = I (I + 1) / 2 + K (row by
// row) belongs to thread t % P in slot t / P, P = blockDim.x, so neighbouring
// threads hold neighbouring tiles of one tile row: loads and stores of a row
// are coalesced, and the trailing tiles of the last panels lie on distinct
// threads. Each thread holds TPT slots, T v[TPT][4][4].
//
// Panels of 4 columns (one tile column J). Per panel, two block barriers:
//   1. the owners of tile column J have published it to a shared panel
//      buffer pan[np][4] (row-major, np = 4 nt), one of two;
//   2. warp 0 factors the panel's 4 columns in registers, a lane per row,
//      the pivot rows' values passed by shuffles (no block barrier, no
//      shared round trip inside the panel) and, for the solve, runs the
//      forward substitution of those 4 rows;
//   3. after the barrier every thread reads its factored panel tiles back
//      and applies the panel's 4 rank-1 updates to its trailing tiles from
//      the shared panel (two 16-byte loads per row of 4 multiply-adds), then
//      publishes tile column J + 1 into the other buffer, so that the next
//      panel needs no barrier of its own before it.
// n = 93: 48 block barriers for the factor. A substitution against a factor
// already in registers (forward_regs, backward_regs) takes two barriers per
// tile column or row: its owners publish it, thread 0 solves the 4
// unknowns, every thread updates its rows. chol_lane.cu copies the input's
// strict upper triangle, which a returned factor keeps, to the output
// through a shared stage by asynchronous copies started before the
// factorization and stored after it.
//
// The order of every update is fixed, whatever the geometry. Each element
// (r, c) of the lower triangle receives a_rc <- fma(-l_rj, l_cj, a_rc) for j =
// 0, 1, ..., c - 1 in ascending order; the pivot of column c is
// refined_rsqrt of its updated diagonal, and every element of column c, the
// diagonal included, is then scaled as a_ic * inv. The forward substitution
// gives each w_i the updates w_i <- fma(-l_ij, y_j, w_i) for ascending j < i
// and then y_i = w_i / l_ii; the backward one gives w_i the updates
// fma(-l_ji, x_j, w_i) for descending j > i and then x_i = w_i / l_ii. So L
// and x do not depend on the number of threads or tiles a thread, and
// substitute_warp (lane_common.cuh), which applies the same substitution
// orders, gives bitwise the same x against the same L.
#pragma once

#include <cuda_pipeline.h>

#include "lane_common.cuh"

namespace hybdrt_lane {

// Most threads a register-tiled block may have: ptxas then keeps at most
// 65536 / 384 = 170 registers a thread, so a block always fits one SM.
constexpr int kRegThreadsMax = 384;
constexpr int kTile = 4;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// Four consecutive values of a 16-byte aligned shared row, in 16-byte loads.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// The factor's arithmetic: each multiply-add a_rc <- fma(-l_rj, l_cj, a_rc),
// the inverse pivot, and the scale of a column by it; and the two ways the
// panel's values reach it: the trailing pass's 16-byte shared loads (load)
// and warp 0's shuffles of the pivot rows (shfl). factor_regs takes it as a
// template parameter so that the layout study's speed-of-light probe
// (chol_layouts.cu) runs this skeleton with other arithmetic, its loads and
// shuffles kept although the probe does not use their values.
struct CholMath {
  template <typename T>
  __device__ __forceinline__ static T update(T a, T l_r, T l_c) { return fma_t(-l_r, l_c, a); }
  template <typename T>
  __device__ __forceinline__ static T inverse_pivot(T d) { return refined_rsqrt(d); }
  template <typename T>
  __device__ __forceinline__ static T scale(T a, T inv) { return a * inv; }
  template <typename T>
  __device__ __forceinline__ static void load(const T* p, T (&v)[kTile]) { load4(p, v); }
  template <typename T>
  __device__ __forceinline__ static T shfl(T v, int src) { return __shfl_sync(0xffffffffu, v, src); }
};

// A thread's tiles: v[s] is tile (ti[s], tk[s]); an unused slot has -1 in both.
template <typename T, int TPT>
struct RegTiles {
  T v[TPT][kTile][kTile];
  int ti[TPT];
  int tk[TPT];
};

// Load this thread's tiles of the row-major (n, n) matrix g (lower triangle
// and the diagonal tiles' upper corners; zeros past n).
template <typename T, int TPT>
__device__ __forceinline__ void load_tiles(const T* __restrict__ g, RegTiles<T, TPT>& m, int n) {
  const int nt = (n + kTile - 1) / kTile;
  const int n_tiles = nt * (nt + 1) / 2;
#pragma unroll
  for (int s = 0; s < TPT; ++s) {
    const int t = s * blockDim.x + threadIdx.x;
    int i = -1, k = -1;
    if (t < n_tiles) {
      i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (i * (i + 1) / 2 > t) --i;
      while ((i + 1) * (i + 2) / 2 <= t) ++i;
      k = t - i * (i + 1) / 2;
    }
    m.ti[s] = i;
    m.tk[s] = k;
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) {
        const int r = kTile * i + rr, c = kTile * k + cc;
        m.v[s][rr][cc] = (i >= 0 && r < n && c < n) ? g[r * n + c] : T(0);
      }
    }
  }
}

// Write the lower triangle of this thread's tiles into the row-major g.
template <typename T, int TPT>
__device__ __forceinline__ void store_tiles(const RegTiles<T, TPT>& m, T* __restrict__ g, int n) {
#pragma unroll
  for (int s = 0; s < TPT; ++s) {
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) {
        const int r = kTile * m.ti[s] + rr, c = kTile * m.tk[s] + cc;
        if (m.ti[s] >= 0 && r < n && c <= r) g[r * n + c] = m.v[s][rr][cc];
      }
    }
  }
}

// Rows per lane a register-held panel keeps (chunks of 32 kPanelSlots<T>
// rows at a time).
template <typename T> constexpr int kPanelSlots = 3;
template <> constexpr int kPanelSlots<double> = 1;

// The strict upper triangle of a into l (the factor's contract: it keeps
// the input), in two halves: copy_upper_issue starts asynchronous copies
// (cp.async) of it into the shared stage, row by row (n (n - 1) / 2 values,
// a warp per row, lanes along it), copy_upper_finish waits for them and
// stores the stage to l. Each thread stores what it copied. The kernels
// issue before the factorization and finish after it, so no thread waits on
// device memory for the copy and no register holds it.
// stage + upper_offset(r, n) + c holds a[r][c] (c > r): the rows of the
// strict upper triangle packed one after the other.
__device__ __forceinline__ int upper_offset(int r, int n) { return r * n - r * (r + 1) / 2 - r - 1; }

template <typename T>
__device__ __forceinline__ void copy_upper_issue(const T* __restrict__ a, T* stage, int n) {
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < n - 1; r += n_warps) {
    T* dst = stage + upper_offset(r, n);
    for (int c = r + 1 + lane; c < n; c += 32)
      __pipeline_memcpy_async(dst + c, a + r * n + c, sizeof(T));
  }
  __pipeline_commit();
}
template <typename T>
__device__ __forceinline__ void copy_upper_finish(const T* stage, T* __restrict__ l, int n) {
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  __pipeline_wait_prior(0);
  for (int r = threadIdx.x >> 5; r < n - 1; r += n_warps) {
    const T* src = stage + upper_offset(r, n);
    for (int c = r + 1 + lane; c < n; c += 32) l[r * n + c] = src[c];
  }
}

// Rows 4 i .. 4 i + 3 of a tile into a 4-wide shared panel, and back.
template <typename T>
__device__ __forceinline__ void publish(const T (&v)[kTile][kTile], T* pan, int i) {
#pragma unroll
  for (int rr = 0; rr < kTile; ++rr) store4(pan + (kTile * i + rr) * kTile, v[rr]);
}
template <typename T>
__device__ __forceinline__ void read_back(T (&v)[kTile][kTile], const T* pan, int i) {
#pragma unroll
  for (int rr = 0; rr < kTile; ++rr) load4(pan + (kTile * i + rr) * kTile, v[rr]);
}

// The forward substitution of one diagonal 4x4 block, in registers: y <-
// D^-1 y for its first kend rows, d[k2][k] = D(k2, k), k <= k2.
template <typename T>
__device__ __forceinline__ void solve_diag4(T (&y)[kTile], const T (&d)[kTile][kTile], int kend) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (k < kend) {
      y[k] = y[k] / d[k][k];
#pragma unroll
      for (int k2 = k + 1; k2 < kTile; ++k2)
        if (k2 < kend) y[k2] = fma_t(-d[k2][k], y[k], y[k2]);
    }
  }
}

// Warp 0: factor the panel of columns j0 .. j0 + 3 in the shared buffer pan
// (rows j0 .. n - 1 valid) in registers, 32 kPanelSlots<T> rows at a time,
// a lane per row; the pivot rows' values go round by shuffles. With kSolve,
// lane 0 then runs the forward substitution of w's rows j0 .. j0 + 3 (w
// already holds the earlier panels' updates).
template <typename T, bool kSolve, typename Math>
__device__ __forceinline__ void factor_panel_warp(T* pan, T* w, int j0, int n) {
  constexpr int kSlots = kPanelSlots<T>;
  const int lane = threadIdx.x & 31;
  const int kend = min(kTile, n - j0);
  T inv[kTile];
  T d[kTile][kTile];  // d[k2][k] = l(j0 + k2, j0 + k), k <= k2
  for (int base = j0; base < n; base += 32 * kSlots) {
    T v[kSlots][kTile];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int i = base + 32 * q + lane;
      if (i < n) {
        load4(pan + i * kTile, v[q]);
      } else {
#pragma unroll
        for (int k = 0; k < kTile; ++k) v[q][k] = T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (k >= kend) break;
      if (base == j0) inv[k] = Math::inverse_pivot(Math::shfl(v[0][k], k));
#pragma unroll
      for (int q = 0; q < kSlots; ++q) v[q][k] = Math::scale(v[q][k], inv[k]);
      if (base == j0) {
#pragma unroll
        for (int k2 = k; k2 < kTile; ++k2) d[k2][k] = Math::shfl(v[0][k], k2);
      }
#pragma unroll
      for (int k2 = k + 1; k2 < kTile; ++k2) {
        if (k2 < kend) {
#pragma unroll
          for (int q = 0; q < kSlots; ++q) v[q][k2] = Math::update(v[q][k2], v[q][k], d[k2][k]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int i = base + 32 * q + lane;
      if (i < n) store4(pan + i * kTile, v[q]);
    }
  }
  if (kSolve && lane == 0) {
    T y[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) y[k] = k < kend ? w[j0 + k] : T(0);
    solve_diag4(y, d, kend);
#pragma unroll
    for (int k = 0; k < kTile; ++k)
      if (k < kend) w[j0 + k] = y[k];
  }
  __syncwarp();
}

// The lower Cholesky factor of the tiles m, in place, by panels; with
// kSolve also w <- L^-1 w (w in shared memory, np = 4 nt long). pan is
// shared scratch of 2 * 4 * np values. Called by the whole block; ends with
// the factor in m, after a barrier.
template <typename T, int TPT, bool kSolve, typename Math = CholMath>
__device__ __forceinline__ void factor_regs(RegTiles<T, TPT>& m, T* pan, T* w, int n) {
  const int nt = (n + kTile - 1) / kTile;
  const int np = kTile * nt;
#pragma unroll
  for (int s = 0; s < TPT; ++s)
    if (m.tk[s] == 0) publish(m.v[s], pan, m.ti[s]);
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = kTile * jt;
    T* p = pan + (jt & 1) * kTile * np;
    T* q = pan + ((jt + 1) & 1) * kTile * np;
    __syncthreads();
    if (threadIdx.x < 32) factor_panel_warp<T, kSolve, Math>(p, w, j0, n);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < TPT; ++s) {
      const int ti = m.ti[s], tk = m.tk[s];
      if (tk == jt) {
        read_back(m.v[s], p, ti);
      } else if (tk > jt) {
        T lc[kTile][kTile];
#pragma unroll
        for (int cc = 0; cc < kTile; ++cc) Math::load(p + (kTile * tk + cc) * kTile, lc[cc]);
#pragma unroll
        for (int rr = 0; rr < kTile; ++rr) {
          T lr[kTile];
          Math::load(p + (kTile * ti + rr) * kTile, lr);
#pragma unroll
          for (int cc = 0; cc < kTile; ++cc) {
#pragma unroll
            for (int k = 0; k < kTile; ++k)
              m.v[s][rr][cc] = Math::update(m.v[s][rr][cc], lr[k], lc[cc][k]);
          }
        }
        if (tk == jt + 1) publish(m.v[s], q, ti);
      }
    }
    if (kSolve) {
      // the panel's solved rows into the rows below it, ascending j
      for (int i = j0 + kTile + threadIdx.x; i < n; i += blockDim.x) {
        T wi = w[i];
#pragma unroll
        for (int k = 0; k < kTile; ++k) wi = fma_t(-p[i * kTile + k], w[j0 + k], wi);
        w[i] = wi;
      }
    }
  }
  __syncthreads();
}

// w <- L^-T w for the factor in m, by tile rows from the last: the owners
// publish tile row J to rows[4][np] (one of two buffers, 2 * 4 * np values
// of shared scratch), thread 0 solves its 4 unknowns in registers, and every thread
// updates the rows above it. Called by the whole block after factor_regs;
// ends after a barrier.
template <typename T, int TPT>
__device__ __forceinline__ void backward_regs(const RegTiles<T, TPT>& m, T* rows, T* w, int n) {
  const int nt = (n + kTile - 1) / kTile;
  const int np = kTile * nt;
  for (int jt = nt - 1; jt >= 0; --jt) {
    const int j0 = kTile * jt;
    T* r = rows + (jt & 1) * kTile * np;
#pragma unroll
    for (int s = 0; s < TPT; ++s) {
      if (m.ti[s] == jt) {
#pragma unroll
        for (int rr = 0; rr < kTile; ++rr) store4(r + rr * np + kTile * m.tk[s], m.v[s][rr]);
      }
    }
    __syncthreads();
    const int jend = min(kTile, n - j0);
    if (threadIdx.x == 0) {
      T y[kTile], d[kTile][kTile];  // d[jj][i] = l(j0 + jj, j0 + i), i <= jj
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj) {
        y[jj] = jj < jend ? w[j0 + jj] : T(0);
#pragma unroll
        for (int i = 0; i <= jj; ++i) d[jj][i] = jj < jend ? r[jj * np + j0 + i] : T(0);
      }
#pragma unroll
      for (int jj = kTile - 1; jj >= 0; --jj) {
        if (jj < jend) {
          y[jj] = y[jj] / d[jj][jj];
#pragma unroll
          for (int i = 0; i < jj; ++i) y[i] = fma_t(-d[jj][i], y[jj], y[i]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kTile; ++jj)
        if (jj < jend) w[j0 + jj] = y[jj];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < j0; i += blockDim.x) {
      T wi = w[i];
      for (int jj = jend - 1; jj >= 0; --jj) wi = fma_t(-r[jj * np + i], w[j0 + jj], wi);
      w[i] = wi;
    }
  }
}

// w <- L^-1 w for the factor in m, by tile columns from the first: the
// owners publish tile column J to cols[np][4] (one of two buffers, 2 * 4 * np
// values of shared scratch), thread 0 solves its 4 unknowns in registers,
// and every thread updates the rows below it, ascending k, one fma each (the
// order factor_regs' fused forward substitution keeps). Called by the whole
// block after factor_regs; ends after a barrier.
template <typename T, int TPT>
__device__ __forceinline__ void forward_regs(const RegTiles<T, TPT>& m, T* cols, T* w, int n) {
  const int nt = (n + kTile - 1) / kTile;
  const int np = kTile * nt;
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = kTile * jt;
    T* p = cols + (jt & 1) * kTile * np;
#pragma unroll
    for (int s = 0; s < TPT; ++s)
      if (m.tk[s] == jt) publish(m.v[s], p, m.ti[s]);
    __syncthreads();
    const int kend = min(kTile, n - j0);
    if (threadIdx.x == 0) {
      T y[kTile], d[kTile][kTile];  // d[k2][k] = l(j0 + k2, j0 + k), k <= k2
#pragma unroll
      for (int k2 = 0; k2 < kTile; ++k2) {
        y[k2] = k2 < kend ? w[j0 + k2] : T(0);
#pragma unroll
        for (int k = 0; k < kTile; ++k)
          d[k2][k] = k2 < kend && k <= k2 ? p[(j0 + k2) * kTile + k] : T(0);
      }
      solve_diag4(y, d, kend);
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (k < kend) w[j0 + k] = y[k];
    }
    __syncthreads();
    for (int i = j0 + kTile + threadIdx.x; i < n; i += blockDim.x) {
      T wi = w[i];
#pragma unroll
      for (int k = 0; k < kTile; ++k) wi = fma_t(-p[i * kTile + k], w[j0 + k], wi);
      w[i] = wi;
    }
  }
}

}  // namespace hybdrt_lane
