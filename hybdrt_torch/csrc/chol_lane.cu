// Batched small-matrix Cholesky kernels for the interior-point QP solves.
//
// Replaces the four TPU kernels of hybdrt_tpu/ops/pallas_chol_lane.py:
//   chol_factor_solve_lane   (:277) -> chol_factor_solve_lane_{f32,f64}
//   chol_solve_factored_lane (:208) -> chol_solve_factored_lane_{f32,f64}
//   chol_solve_lane          (:95)  -> chol_solve_lane_{f32,f64}
//   chol_factor_lane         (:178) -> chol_factor_lane_{f32,f64}
//
// The TPU kernels put 128 matrices in the vector lanes, (n, n, 128), and
// unrolled the column loop statically. On Hopper each matrix gets one thread
// block, and nothing needs the TPU's padding to 128 lanes.
//
// chol_factor_solve_lane, chol_solve_lane and chol_factor_lane keep the
// lower triangle in registers for the whole factorization (lane_regs.cuh):
// 4x4 tiles spread over the block's threads, panels of 4 columns factored by
// one warp from a small shared buffer, the trailing update applied by every
// thread to its own tiles. The two that solve fuse the forward substitution
// into the panels and run the backward one by tile rows; chol_solve_lane is
// chol_factor_solve_lane without the factor's output (no store of the tiles,
// no copy of the upper triangle). chol_solve_factored_lane copies the
// factor's lower triangle, packed by rows, into shared memory by cp.async
// and substitutes with one warp (substitute_warp, lane_common.cuh), one
// matrix to a warp-sized block.
//
// Contract (kept exactly from the TPU kernels):
//   * only the lower triangle of a returned factor is valid; the upper
//     triangle holds the input;
//   * the pivot is rsqrt refined by one Newton step r * (1.5 - 0.5 x r^2) on
//     max(x, 1e-30), and a non-positive pivot yields NaN, which then fills the
//     rest of the factorization and the solution (the QP's bad-step guard
//     depends on it).
// The register-tiled factor applies every update in a fixed order, each as
// one fma (lane_regs.cuh), whatever the threads, so x from
// chol_factor_solve_lane is bitwise x from chol_solve_lane, and L from
// chol_factor_solve_lane bitwise L from chol_factor_lane. substitute_warp
// gives each unknown its updates in the same order, so
// chol_solve_factored_lane against that L gives bitwise the same x.
//
// What bounds them: device memory moves one read of the matrix and, for the
// kernels that return a factor, one write (0.17 ms at B=8192, n=93 in f32);
// the n^3/6 multiply-adds of the lower triangle's updates are a tenth of
// that at the card's f32 rate. What held the shared-memory column loop that
// these kernels replaced far above both was not the arithmetic but its
// skeleton (the layout study's probe, PERF.md): each multiply-add was a
// shared read-modify-write, two block barriers per column (186 at n = 93),
// and 35 KB of shared memory per matrix, so six matrices per SM. The
// register-tiled design answers each: half a shared value read per
// multiply-add (in 16-byte loads) from a panel buffer the threads share, two
// block barriers per panel of four columns, and a few KB of shared memory per
// matrix, so registers (not shared memory) set how many matrices an SM
// holds. Tensor cores (mma / wgmma) would sum the updates in
// another order and break the bitwise identity; they are left out. So is a
// persistent grid that prefetches the next matrix with cp.async: not tried.
//
// chol_solve_factored_lane needs only a read of the lower triangle and of b
// and a write of x (0.045 ms at B=8192, n=93 in f32) and 2 n^2
// multiply-adds; what holds it is the chain of 2 n dependent divisions,
// each behind a warp barrier. One warp per matrix keeps that chain free of
// block barriers, and the packed triangle (17.8 KB at n = 93 in f32, half
// of the (n, n | 1) matrix it replaced) lets twelve matrices share an SM.
// The triangle in register tiles over 64 threads, substituted by tile
// columns and rows, gave the same x and was slower at the fit's batch; so
// was a warp reading the triangle through L1 with no shared memory
// (PERF.md, Findings).
//
// Each launcher returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.

#include "lane_regs.cuh"

namespace {

using namespace hybdrt_lane;

// chol_solve_factored_lane: one warp a matrix (ops/chol_lane.py::solve_geometry)
constexpr int kSolveThreads = 32;

// Shared memory of the register-tiled kernels: two panel buffers of np x 4
// (np = n rounded up to the tile; the backward substitution reuses them),
// w for the solve (np), and, where the factor is returned, the stage of the
// upper triangle, n (n - 1) / 2.
template <typename T>
inline size_t reg_smem_bytes(int n, bool solve, bool factor_out) {
  const size_t np = kTile * ((n + kTile - 1) / kTile);
  return sizeof(T) * (2 * kTile * np + (solve ? np : 0) +
                      (factor_out ? static_cast<size_t>(n) * (n - 1) / 2 : 0));
}

// x = a^-1 b and, with kFactorOut, L = chol(a) (lower triangle valid), the
// lower triangle in registers (lane_regs.cuh).
template <typename T, int TPT, bool kFactorOut>
__global__ void __launch_bounds__(kRegThreadsMax)
factor_solve_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ x, T* __restrict__ l, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = kTile * ((n + kTile - 1) / kTile);
  T* pan = reinterpret_cast<T*>(smem_raw);
  T* w = pan + 2 * kTile * np;
  T* stage = w + np;
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  if (kFactorOut) copy_upper_issue(a + m_off, stage, n);
  RegTiles<T, TPT> m;
  load_tiles(a + m_off, m, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) w[i] = b[v_off + i];
  factor_regs<T, TPT, true>(m, pan, w, n);
  if (kFactorOut) store_tiles(m, l + m_off, n);
  backward_regs(m, pan, w, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[v_off + i] = w[i];
  if (kFactorOut) copy_upper_finish(stage, l + m_off, n);
}

// L = chol(a) (lower triangle valid), the lower triangle in registers. The
// input is only read: the resolve re-factors the same diagonal blocks at
// every interior-point step, where the TPU kernel factored a fresh transpose
// it was free to overwrite.
template <typename T, int TPT>
__global__ void __launch_bounds__(kRegThreadsMax)
factor_kernel(const T* __restrict__ a, T* __restrict__ l, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pan = reinterpret_cast<T*>(smem_raw);
  T* stage = pan + 2 * kTile * kTile * ((n + kTile - 1) / kTile);
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  copy_upper_issue(a + m_off, stage, n);
  RegTiles<T, TPT> m;
  load_tiles(a + m_off, m, n);
  factor_regs<T, TPT, false>(m, pan, nullptr, n);
  store_tiles(m, l + m_off, n);
  copy_upper_finish(stage, l + m_off, n);
}

// x = (L L^T)^-1 b against a factor from factor_solve_kernel or
// factor_kernel, one warp a matrix and a matrix a block: the factor's lower
// triangle, packed by rows, is copied into shared memory by cp.async, then
// substitute_warp solves against it (lane_common.cuh).
template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
solve_factored_kernel(const T* __restrict__ l, const T* __restrict__ b, T* __restrict__ x,
                      int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  T* w = s + n * (n + 1) / 2;
  const T* g = l + static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  for (int r = 0; r < n; ++r)
    for (int c = threadIdx.x; c <= r; c += kSolveThreads)
      __pipeline_memcpy_async(s + r * (r + 1) / 2 + c, g + r * n + c, sizeof(T));
  __pipeline_commit();
  for (int i = threadIdx.x; i < n; i += kSolveThreads) w[i] = b[v_off + i];
  __pipeline_wait_prior(0);
  __syncwarp();
  substitute_warp(s, w, n, PackedRows{});
  for (int i = threadIdx.x; i < n; i += kSolveThreads) x[v_off + i] = w[i];
}

// Shared memory of solve_factored_kernel (ops/chol_lane.py::solve_geometry
// mirrors it): the packed lower triangle and w.
template <typename T>
inline size_t solve_smem_bytes(int n) {
  return sizeof(T) * (static_cast<size_t>(n) * (n + 1) / 2 + n);
}

// The register-tiled kernel for TPT tiles a thread, TPT = 1 .. kMaxTPT<T>
// (the Python wrapper's reg_geometry picks the threads; TPT follows).
template <typename T> constexpr int kMaxTPT = 6;
template <> constexpr int kMaxTPT<double> = 3;

template <typename T, int TPT>
int launch_regs(int tpt, const void* a, const void* b, void* x, void* l, int batch, int n,
                int threads, cudaStream_t stream) {
  if constexpr (TPT > kMaxTPT<T>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (tpt != TPT) return launch_regs<T, TPT + 1>(tpt, a, b, x, l, batch, n, threads, stream);
    const size_t bytes = reg_smem_bytes<T>(n, b != nullptr, l != nullptr);
    const T* ta = static_cast<const T*>(a);
    const T* tb = static_cast<const T*>(b);
    T* tx = static_cast<T*>(x);
    T* tl = static_cast<T*>(l);
    int err;
    if (b == nullptr) {
      err = allow_smem(factor_kernel<T, TPT>, bytes);
      if (!err) factor_kernel<T, TPT><<<batch, threads, bytes, stream>>>(ta, tl, n);
    } else if (l == nullptr) {
      err = allow_smem(factor_solve_kernel<T, TPT, false>, bytes);
      if (!err)
        factor_solve_kernel<T, TPT, false><<<batch, threads, bytes, stream>>>(ta, tb, tx, tl, n);
    } else {
      err = allow_smem(factor_solve_kernel<T, TPT, true>, bytes);
      if (!err)
        factor_solve_kernel<T, TPT, true><<<batch, threads, bytes, stream>>>(ta, tb, tx, tl, n);
    }
    return err ? err : static_cast<int>(cudaGetLastError());
  }
}

// b == nullptr: the factor alone; l == nullptr: the solve alone. threads: a
// multiple of 32, at most kRegThreadsMax, with ceil(tiles / threads) <=
// kMaxTPT<T>.
template <typename T>
int launch_factor_regs(const void* a, const void* b, void* x, void* l, int batch, int n,
                       int threads, void* stream) {
  if (batch == 0) return 0;
  const int nt = (n + kTile - 1) / kTile;
  const int n_tiles = nt * (nt + 1) / 2;
  if (n < 1 || threads < 32 || threads % 32 || threads > kRegThreadsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpt = (n_tiles + threads - 1) / threads;
  return launch_regs<T, 1>(tpt, a, b, x, l, batch, n, threads,
                           static_cast<cudaStream_t>(stream));
}

// The blocks of factor_kernel<float, TPT> one SM holds at (n, threads), for
// the layout study's probe, which runs at the same occupancy
// (chol_layouts.cu::sol_occupancy).
template <int TPT>
int factor_blocks_per_sm(int tpt, int n, int threads, int* blocks) {
  if constexpr (TPT > kMaxTPT<float>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (tpt != TPT) return factor_blocks_per_sm<TPT + 1>(tpt, n, threads, blocks);
    const size_t bytes = reg_smem_bytes<float>(n, false, true);
    int err = allow_smem(factor_kernel<float, TPT>, bytes);
    if (!err)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, factor_kernel<float, TPT>,
                                                          threads, bytes);
    return err;
  }
}

// threads and bytes: the wrapper's solve_geometry, refused unless they are
// this kernel's.
template <typename T>
int launch_solve_factored(const void* l, const void* b, void* x, int batch, int n,
                          int threads, int bytes, void* stream) {
  if (batch == 0) return 0;
  if (n < 1 || threads != kSolveThreads || static_cast<size_t>(bytes) != solve_smem_bytes<T>(n))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = allow_smem(solve_factored_kernel<T>, bytes);
  if (err) return err;
  solve_factored_kernel<T><<<batch, kSolveThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(b), static_cast<T*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int chol_factor_solve_lane_f32(const void* a, const void* b, void* x, void* l, int batch,
                               int n, int threads, void* stream) {
  return launch_factor_regs<float>(a, b, x, l, batch, n, threads, stream);
}
int chol_factor_solve_lane_f64(const void* a, const void* b, void* x, void* l, int batch,
                               int n, int threads, void* stream) {
  return launch_factor_regs<double>(a, b, x, l, batch, n, threads, stream);
}
int chol_factor_lane_f32(const void* a, void* l, int batch, int n, int threads, void* stream) {
  return launch_factor_regs<float>(a, nullptr, nullptr, l, batch, n, threads, stream);
}
int chol_factor_lane_f64(const void* a, void* l, int batch, int n, int threads, void* stream) {
  return launch_factor_regs<double>(a, nullptr, nullptr, l, batch, n, threads, stream);
}
int chol_solve_lane_f32(const void* a, const void* b, void* x, int batch, int n, int threads,
                        void* stream) {
  return launch_factor_regs<float>(a, b, x, nullptr, batch, n, threads, stream);
}
int chol_solve_lane_f64(const void* a, const void* b, void* x, int batch, int n, int threads,
                        void* stream) {
  return launch_factor_regs<double>(a, b, x, nullptr, batch, n, threads, stream);
}
int chol_factor_lane_blocks_per_sm_f32(int n, int threads, int* blocks) {
  const int nt = (n + kTile - 1) / kTile;
  if (n < 1 || threads < 32 || threads % 32 || threads > kRegThreadsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  return factor_blocks_per_sm<1>((nt * (nt + 1) / 2 + threads - 1) / threads, n, threads, blocks);
}
int chol_solve_factored_lane_f32(const void* l, const void* b, void* x, int batch, int n,
                                 int threads, int bytes, void* stream) {
  return launch_solve_factored<float>(l, b, x, batch, n, threads, bytes, stream);
}
int chol_solve_factored_lane_f64(const void* l, const void* b, void* x, int batch, int n,
                                 int threads, int bytes, void* stream) {
  return launch_solve_factored<double>(l, b, x, batch, n, threads, bytes, stream);
}
}  // extern "C"
