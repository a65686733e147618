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
// it changes no result. Each kernel reads its matrix from device memory once
// and writes each output once. Where they keep it:
//   * the panel-blocked factor-solve and the probe run the production
//     factor's register-tiled skeleton (lane_regs.cuh): a block per matrix,
//     the lower triangle in registers, panels factored by warp 0 from a
//     shared panel buffer;
//   * the column solve and the blocked solve are one kernel, one warp per
//     matrix on its lower triangle packed by rows in shared memory (row
//     starts padded, below); the blocked solve is its instantiation in panels
//     of nb columns.
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s float32) at B=8192,
// n=93: device memory, by a wide margin: 0.1710 ms for the factor-solve
// (read A and b, write L and x), 0.0446 ms for the two solves (read A's
// lower triangle and b, write x), 0.169 ms for the probe (read A, write the
// result), against about 0.04 ms for the n^3/6 multiply-adds. The layouts
// test answers to the question of what holds the lane kernels back (block
// barriers, the warp-serial panel pass, one matrix per block, the order of
// the sums), and the probe measures the skeleton of the production factor
// without its math.
//
// Each launcher returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.

#include "lane_regs.cuh"

// chol_lane.cu: the blocks of chol_factor_lane's float kernel one SM holds.
extern "C" int chol_factor_lane_blocks_per_sm_f32(int n, int threads, int* blocks);

namespace {

using namespace hybdrt_lane;

constexpr int kMaxPanel = 32;      // the widest panel of the factor-solve
constexpr int kMaxWarps = 32;      // matrices per block of the warp layouts
constexpr float kSolScale = 0.999f;
// The register-tiled kernels here for TPT tiles a thread, TPT = 1 .. 6
// (chol_factor_lane's float instantiations, chol_lane.cu::kMaxTPT)
constexpr int kMaxTPT = 6;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The warp layouts: chol_solve_batched and chol_solve_blocked, one kernel.
//
// Several matrices per block, one warp per matrix, no block barrier at all:
// each warp loads its matrix, factors it, solves and stores x, synchronised
// by __syncwarp only. block_batch warps share a block; shared memory bounds
// it.
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

// L^T x = y in place with the division guard, on the warp's matrix, its rows
// where `rows` puts them.
template <typename Rows>
__device__ __forceinline__ void backward_guarded_warp(const float* l, float* w, int n, Rows rows,
                                                      int lane) {
  for (int j = n - 1; j >= 0; --j) {
    const float* row = l + rows(j);
    const float xj = w[j] / pivot_guard(row[j]);
    __syncwarp();
    if (lane == 0) w[j] = xj;
    for (int i = lane; i < j; i += 32) w[i] -= row[i] * xj;
    __syncwarp();
  }
}

// A warp per matrix on its lower triangle, packed by rows in shared memory,
// factored left-looking.
//
// The TPU kernels' column loops, run on a whole (n, n | 1) matrix in shared
// memory, read and rewrite the trailing triangle once per column (or, in
// panels, once per panel column and once per panel), and at 35 KB a matrix
// only six matrices share an SM. Here each warp copies only the lower
// triangle in by cp.async, row r at 4 packed_row4(r) (the rows' starts
// padded below: 19.2 KB at n = 93 with w, so twelve matrices fit one block),
// and factors it in groups of 4 columns, a lane per row (kColSlots rows a
// lane at a time): each of its 4 elements starts from a_rc, takes the terms
// l_rj l_cj of every earlier column j in ascending order in a register
// (16-byte loads: l_rj per lane, l_cj broadcast), then the group's own
// columns as #1's panel (pivot rows by shuffles), and is scaled once by its
// column's inverse pivot and written once. The forward substitution runs
// behind each group on its rows (w_i -= y_j l_ij, ascending j, then the
// guarded division); the backward one reads the rows of L
// (backward_guarded_warp).
//
// The order of the terms is each TPU kernel's, so x is bitwise the order's:
//   * chol_solve_batched (Panels = false): a_rc -= l_rj l_cj, one fma per
//     term, for every j < c, the right-looking column loop's order;
//   * chol_solve_blocked (Panels = true, panels of nb columns): an element of
//     column c in the panel [j0, j0 + nb) first loses, for each earlier panel
//     [k0, k1) in ascending order, that panel's sum of l_rk l_ck (from +0,
//     ascending k: the TPU kernel's trailing product), then l_rj l_cj one fma
//     at a time for j0 <= j < c (its panel's column loop). Each element keeps
//     its current panel sum beside it (acc) and loses it at the panel's last
//     column. A panel that ends inside a group of 4 columns (nb not a
//     multiple of 4) ends after the group's column there has been scaled: the
//     group's columns past it take that column's term into their sums, lose
//     them, and go on in their own panel. With one panel (nb >= n) the order
//     is chol_solve_batched's, and so is x.
//
// The row starts: row r = 4 m + i needs ceil((r + 1) / 4) = m + 1 vectors of
// 4 floats; it gets (m + 1) | 1, an odd count, so that 16-byte row starts
// are aligned and the 8 lanes of each quarter-warp's 16-byte loads (8 rows)
// mostly land on distinct banks. packed_row4(r) is the sum over the rows
// before r, in vectors.
//
// Registers: both hold kColSlots = 2 rows a lane (1 was slower for both, 3
// for chol_solve_batched). A warp layout launches up to kMaxWarps warps a
// block, which caps a thread at 64 registers; the panel sums add a 2 x 4
// block of accumulators, which still fit there (60, no spill), but
// chol_solve_blocked ran about 5 % faster with more (94 under the 512-thread
// bound, PERF.md), so blocks of up to kMaxWarps / 2 matrices take that
// instantiation.
// ---------------------------------------------------------------------------
constexpr int kColSlots = 2;

__host__ __device__ __forceinline__ int packed_row4(int r) {
  const int m = r >> 2;
  return 4 * (m * (m + 1) / 2 + m / 2) + (r & 3) * ((m + 1) | 1);
}

// Floats of one warp's matrix: the padded triangle and w (rounded up to 4,
// so that the next warp's triangle starts aligned). The wrappers'
// smem_bytes mirrors it.
__host__ __device__ __forceinline__ int column_matrix_floats(int n) {
  return kTile * (packed_row4(n) + (n + kTile - 1) / kTile);
}

struct PaddedRows {
  __device__ __forceinline__ int operator()(int r) const { return kTile * packed_row4(r); }
};

// The 4 terms l_rj l_cj, j ascending, of element kk of each of the lane's
// rows, straight into the element.
__device__ __forceinline__ void own_terms4(float (&v)[kColSlots][kTile],
                                           const float (&lr)[kColSlots][kTile],
                                           const float (&lc)[kTile], int kk) {
#pragma unroll
  for (int k = 0; k < kTile; ++k)
#pragma unroll
    for (int q = 0; q < kColSlots; ++q) v[q][kk] = fmaf(-lr[q][k], lc[k], v[q][kk]);
}

// One term l_rj l_cj of the element v, panelled: straight into v in the
// element's own panel (own), else into the sum acc of j's panel, which v
// loses at the panel's last column (end). Each term is one fma, written out:
// a product shared by the two branches would otherwise be rounded apart.
__device__ __forceinline__ void panel_term(float& v, float& acc, float lr, float lc, bool own,
                                           bool end) {
  if (own) {
    v = fmaf(-lr, lc, v);
  } else {
    acc = fmaf(lr, lc, acc);
    if (end) {
      v -= acc;
      acc = 0.f;
    }
  }
}

// Columns c0 .. c0 + 3 of the factor, and rows c0 .. c0 + 3 of the forward
// substitution, on the warp's matrix s; Panels: in panels of nb columns.
template <bool Panels>
__device__ __forceinline__ void column_group_warp(float* s, float* w, int c0, int n, int nb,
                                                  int lane) {
  const int kend = min(kTile, n - c0);
  float inv[kTile];
  float d[kTile][kTile];  // d[k2][k] = l(c0 + k2, c0 + k), k <= k2
  float y[kTile];         // the group's unknowns
#pragma unroll
  for (int k = 0; k < kTile; ++k) y[k] = k < kend ? w[c0 + k] : 0.f;
  const float* pc[kTile];  // the group's rows
#pragma unroll
  for (int k = 0; k < kTile; ++k) pc[k] = s + kTile * packed_row4(min(c0 + k, n - 1));
  // Panels: the first column of each group column's own panel, and the group
  // columns that end a panel (bit k for column c0 + k)
  int own[kTile];
  int ends = 0;
  if constexpr (Panels) {
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      own[k] = (c0 + k) / nb * nb;
      if ((c0 + k + 1) % nb == 0) ends |= 1 << k;
    }
  }
  for (int base = c0; base < n; base += 32 * kColSlots) {
    float v[kColSlots][kTile];
    float acc[kColSlots][kTile];  // Panels: each element's sum over an earlier panel
    float* row[kColSlots];
#pragma unroll
    for (int q = 0; q < kColSlots; ++q) {
      const int r = base + 32 * q + lane;
      row[q] = s + kTile * packed_row4(r);
      if (r < n) {
        load4(row[q] + c0, v[q]);
#pragma unroll
        for (int k = 0; k < kTile; ++k)
          if (c0 + k > r) v[q][k] = 0.f;  // past the row: padding
      } else {
#pragma unroll
        for (int k = 0; k < kTile; ++k) v[q][k] = 0.f;
      }
      if constexpr (Panels) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) acc[q][k] = 0.f;
      }
    }
    // every earlier column, ascending
    int pend = nb;  // Panels: the end of the panel that holds column j
    for (int j = 0; j < c0; j += kTile) {
      float lr[kColSlots][kTile];
#pragma unroll
      for (int q = 0; q < kColSlots; ++q) {
        if (base + 32 * q + lane < n) {
          load4(row[q] + j, lr[q]);
        } else {
#pragma unroll
          for (int k = 0; k < kTile; ++k) lr[q][k] = 0.f;
        }
      }
      int chunk_ends = 0;  // Panels: bit k where column j + k ends a panel
      if constexpr (Panels) {
        while (pend <= j) pend += nb;
        if (pend < j + kTile)  // only the general path below reads it
          for (int e = pend; e <= j + kTile; e += nb) chunk_ends |= 1 << (e - j - 1);
      }
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) {
        if (kk < kend) {
          float lc[kTile];
          load4(pc[kk] + j, lc);
          if constexpr (!Panels) {
            own_terms4(v, lr, lc, kk);
          } else if (j >= own[kk]) {
            own_terms4(v, lr, lc, kk);
          } else if (j + kTile <= pend) {  // 4 columns of one earlier panel
#pragma unroll
            for (int k = 0; k < kTile; ++k)
#pragma unroll
              for (int q = 0; q < kColSlots; ++q) acc[q][kk] = fmaf(lr[q][k], lc[k], acc[q][kk]);
            if (j + kTile == pend) {
#pragma unroll
              for (int q = 0; q < kColSlots; ++q) {
                v[q][kk] -= acc[q][kk];
                acc[q][kk] = 0.f;
              }
            }
          } else {  // a panel boundary among the 4 columns
#pragma unroll
            for (int k = 0; k < kTile; ++k) {
              const bool mine = j + k >= own[kk], end = (chunk_ends >> k) & 1;
#pragma unroll
              for (int q = 0; q < kColSlots; ++q)
                panel_term(v[q][kk], acc[q][kk], lr[q][k], lc[k], mine, end);
            }
          }
        }
      }
    }
    // the group's own columns, right-looking
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (k >= kend) break;
      if (base == c0) inv[k] = zero_pivot_inv(__shfl_sync(kFull, v[0][k], k));
#pragma unroll
      for (int q = 0; q < kColSlots; ++q) v[q][k] *= inv[k];
      if (base == c0) {
#pragma unroll
        for (int k2 = k; k2 < kTile; ++k2) d[k2][k] = __shfl_sync(kFull, v[0][k], k2);
      }
#pragma unroll
      for (int k2 = k + 1; k2 < kTile; ++k2) {
        if (k2 < kend) {
          if constexpr (Panels) {
            const bool mine = c0 + k >= own[k2], end = (ends >> k) & 1;
#pragma unroll
            for (int q = 0; q < kColSlots; ++q)
              panel_term(v[q][k2], acc[q][k2], v[q][k], d[k2][k], mine, end);
          } else {
#pragma unroll
            for (int q = 0; q < kColSlots; ++q) v[q][k2] -= v[q][k] * d[k2][k];
          }
        }
      }
    }
    if (base == c0) {
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        if (k < kend) {
          y[k] = y[k] / pivot_guard(d[k][k]);
#pragma unroll
          for (int k2 = k + 1; k2 < kTile; ++k2)
            if (k2 < kend) y[k2] -= y[k] * d[k2][k];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kColSlots; ++q) {
      const int r = base + 32 * q + lane;
      if (r < n) {
        store4(row[q] + c0, v[q]);
        if (r >= c0 + kTile) {
          float wr = w[r];
#pragma unroll
          for (int k = 0; k < kTile; ++k)
            if (k < kend) wr -= y[k] * v[q][k];
          w[r] = wr;
        }
      }
    }
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kTile; ++k)
      if (k < kend) w[c0 + k] = y[k];
  }
  __syncwarp();
}

// nb: the panel width (Panels only).
template <bool Panels, int MaxWarps>
__global__ void __launch_bounds__(MaxWarps * 32)
column_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ x, int batch, int n, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= batch) return;  // whole warps leave; nothing below waits for them
  float* s = reinterpret_cast<float*>(smem_raw) + warp * column_matrix_floats(n);
  float* w = s + kTile * packed_row4(n);
  const float* g = a + static_cast<size_t>(m) * n * n;
  const size_t v_off = static_cast<size_t>(m) * n;
  for (int r = 0; r < n; ++r) {
    float* row = s + kTile * packed_row4(r);
    for (int c = lane; c <= r; c += 32) __pipeline_memcpy_async(row + c, g + r * n + c, sizeof(float));
  }
  __pipeline_commit();
  for (int i = lane; i < n; i += 32) w[i] = b[v_off + i];
  __pipeline_wait_prior(0);
  __syncwarp();
  for (int c0 = 0; c0 < n; c0 += kTile) column_group_warp<Panels>(s, w, c0, n, nb, lane);
  backward_guarded_warp(s, w, n, PaddedRows{}, lane);
  for (int i = lane; i < n; i += 32) x[v_off + i] = w[i];
}

// ---------------------------------------------------------------------------
// chol_factor_solve_lane_blocked: chol_factor_solve_lane's register-tiled
// skeleton (lane_regs.cuh) with panels of kb columns.
//
// The TPU kernel factored each kb-column panel column by column and then
// applied the panel's kb rank-1 terms to the trailing block in one fused
// pass. Here the block, the 4x4 register tiles, their geometry
// (ops/chol_lane.py::reg_geometry), the upper triangle's cp.async stage and
// the substitutions are chol_factor_solve_lane's; only the panel differs.
// Per panel of kb columns, two block barriers (2 ceil(n / kb) in all, 24 at
// n = 93 and kb = 8, against the 4-column factor's 48):
//   1. the owners of the panel's columns have published them to a shared
//      panel buffer of kb columns (one of two);
//   2. warp 0 factors the panel in 4-column chunks, a lane per row, in
//      registers: each chunk takes the panel's earlier columns from the
//      buffer, then is factored as #1's panel (pivot rows by shuffles), and
//      the panel's rows of w are solved behind it;
//   3. after the barrier every thread reads its panel columns back and
//      subtracts from each trailing element the panel's kb products, summed
//      in a register from 0; then it publishes its columns of the next
//      panel into the other buffer and updates w below the panel.
// When kb is not a multiple of 4 a panel ends inside a tile column: its
// tiles are read back, updated and published column by column (masked).
//
// The order of operations is the TPU kernel's: within a panel each element
// (r, c) receives a_rc -= l_rj l_cj for the panel's j < c in ascending order
// and then its column's scale a_rc * inv; each trailing element receives,
// per panel, a_rc -= acc with acc = sum of l_rk l_ck from 0 in ascending k.
// So L and x depend on kb and not on the threads. The contract is
// chol_factor_solve_lane's: refined rsqrt, NaN from a non-positive pivot
// on, only the lower triangle of L valid (the upper one keeps the input).
// ---------------------------------------------------------------------------

// Row stride of a panel buffer: kb rounded up to 4, an odd count of 16-byte
// vectors, so that warp 0's lanes (a row each) load from distinct banks.
__host__ __device__ __forceinline__ int panel_stride(int kb) {
  return kTile * (((kb + kTile - 1) / kTile) | 1);
}

// Shared memory of the panel-blocked factor-solve (the wrapper's smem_bytes
// mirrors it): two panel buffers of np rows, w (np) and the stage of the
// strict upper triangle.
inline size_t kb_smem_bytes(int n, int kb) {
  const size_t np = kTile * ((n + kTile - 1) / kTile);
  return sizeof(float) * (2 * panel_stride(kb) * np + np + static_cast<size_t>(n) * (n - 1) / 2);
}

// The columns c_begin .. c_end - 1 of a tile into the buffer buf (column c
// at offset c - c_begin of row stride ld), and back.
__device__ __forceinline__ void publish_cols(const float (&v)[kTile][kTile], int ti, int tk,
                                             float* buf, int ld, int c_begin, int c_end) {
  const int c_lo = kTile * tk;
  if (ti < 0 || c_lo + kTile <= c_begin || c_lo >= c_end) return;
  float* row = buf + kTile * ti * ld + c_lo - c_begin;
  if (c_lo >= c_begin && c_lo + kTile <= c_end && ((c_lo - c_begin) & 3) == 0) {
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) store4(row + rr * ld, v[rr]);
    return;
  }
#pragma unroll
  for (int rr = 0; rr < kTile; ++rr)
#pragma unroll
    for (int cc = 0; cc < kTile; ++cc)
      if (c_lo + cc >= c_begin && c_lo + cc < c_end) row[rr * ld + cc] = v[rr][cc];
}
__device__ __forceinline__ void read_cols(float (&v)[kTile][kTile], int ti, int tk,
                                          const float* buf, int ld, int c_begin, int c_end) {
  const int c_lo = kTile * tk;
  const float* row = buf + kTile * ti * ld + c_lo - c_begin;
  if (c_lo >= c_begin && c_lo + kTile <= c_end && ((c_lo - c_begin) & 3) == 0) {
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) load4(row + rr * ld, v[rr]);
    return;
  }
#pragma unroll
  for (int rr = 0; rr < kTile; ++rr)
#pragma unroll
    for (int cc = 0; cc < kTile; ++cc)
      if (c_lo + cc >= c_begin && c_lo + cc < c_end) v[rr][cc] = row[rr * ld + cc];
}

// Warp 0: factor the panel of columns j0 .. j1 - 1 in the buffer p (rows
// j0 .. n - 1 valid, column j at offset j - j0 of row stride ld) in chunks
// of 4 columns, kPanelSlots rows a lane at a time; then solve the chunk's
// rows of w (which hold the earlier panels' updates) in the substitution's
// order: w_i -= y_j l_ij for the panel's earlier j, ascending, then the
// chunk's 4 x 4 block (solve_diag4).
__device__ __forceinline__ void factor_kb_panel_warp(float* p, int ld, float* w, int j0, int j1,
                                                     int n) {
  constexpr int kSlots = kPanelSlots<float>;
  const int lane = threadIdx.x & 31;
  for (int c0 = j0; c0 < j1; c0 += kTile) {
    const int kend = min(kTile, j1 - c0);
    const int cb = c0 - j0;  // the chunk's first column in the buffer
    float inv[kTile];
    float d[kTile][kTile];  // d[k2][k] = l(c0 + k2, c0 + k), k <= k2
    for (int base = c0; base < n; base += 32 * kSlots) {
      float v[kSlots][kTile];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int i = base + 32 * q + lane;
        if (i < n) {
          load4(p + i * ld + cb, v[q]);
        } else {
#pragma unroll
          for (int k = 0; k < kTile; ++k) v[q][k] = 0.0f;
        }
      }
      // the panel's earlier columns, ascending
      for (int k4 = 0; k4 < cb; k4 += kTile) {
        float lr[kSlots][kTile];
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const int i = base + 32 * q + lane;
          if (i < n) {
            load4(p + i * ld + k4, lr[q]);
          } else {
#pragma unroll
            for (int k = 0; k < kTile; ++k) lr[q][k] = 0.0f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < kTile; ++kk) {
          if (kk < kend) {
            float lc[kTile];
            load4(p + (c0 + kk) * ld + k4, lc);
#pragma unroll
            for (int k = 0; k < kTile; ++k)
#pragma unroll
              for (int q = 0; q < kSlots; ++q) v[q][kk] -= lr[q][k] * lc[k];
          }
        }
      }
      // the chunk's own columns, right-looking
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        if (k >= kend) break;
        if (base == c0) inv[k] = refined_rsqrt(__shfl_sync(kFull, v[0][k], k));
#pragma unroll
        for (int q = 0; q < kSlots; ++q) v[q][k] = v[q][k] * inv[k];
        if (base == c0) {
#pragma unroll
          for (int k2 = k; k2 < kTile; ++k2) d[k2][k] = __shfl_sync(kFull, v[0][k], k2);
        }
#pragma unroll
        for (int k2 = k + 1; k2 < kTile; ++k2) {
          if (k2 < kend) {
#pragma unroll
            for (int q = 0; q < kSlots; ++q) v[q][k2] -= v[q][k] * d[k2][k];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int i = base + 32 * q + lane;
        if (i < n) store4(p + i * ld + cb, v[q]);
      }
    }
    float wk = 0.0f;
    if (lane < kend) {
      const int i = c0 + lane;
      wk = w[i];
      for (int k = 0; k < cb; ++k) wk = fma_t(-p[i * ld + k], w[j0 + k], wk);
    }
    float y[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) y[k] = __shfl_sync(kFull, wk, k);
    solve_diag4(y, d, kend);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (k < kend) w[c0 + k] = y[k];
    }
    __syncwarp();
  }
}

// Every thread, after warp 0's panel pass: read this tile's panel columns
// back from p; subtract from its columns right of the panel the panel's
// summed products; publish its columns of the next panel (j1 .. j1 + kb - 1)
// to q. Columns left of the panel are final and left alone.
__device__ __forceinline__ void kb_tile_pass(float (&v)[kTile][kTile], int ti, int tk,
                                             const float* p, float* q, int ld, int j0, int j1,
                                             int kb, int n) {
  const int c_lo = kTile * tk;
  if (ti < 0 || c_lo + kTile <= j0) return;
  if (c_lo < j1) read_cols(v, ti, tk, p, ld, j0, j1);
  if (c_lo + kTile <= j1) return;
  const int width = j1 - j0;
  const int kfull = width & ~(kTile - 1);
  float acc[kTile][kTile] = {};
  for (int k4 = 0; k4 < kfull; k4 += kTile) {
    float lc[kTile][kTile];
#pragma unroll
    for (int cc = 0; cc < kTile; ++cc) load4(p + (c_lo + cc) * ld + k4, lc[cc]);
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
      float lr[kTile];
      load4(p + (kTile * ti + rr) * ld + k4, lr);
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc)
#pragma unroll
        for (int k = 0; k < kTile; ++k) acc[rr][cc] += lr[k] * lc[cc][k];
    }
  }
  for (int k = kfull; k < width; ++k) {
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
      const float lr = p[(kTile * ti + rr) * ld + k];
#pragma unroll
      for (int cc = 0; cc < kTile; ++cc) acc[rr][cc] += lr * p[(c_lo + cc) * ld + k];
    }
  }
#pragma unroll
  for (int rr = 0; rr < kTile; ++rr)
#pragma unroll
    for (int cc = 0; cc < kTile; ++cc)
      if (c_lo + cc >= j1) v[rr][cc] -= acc[rr][cc];
  if (j1 < n) publish_cols(v, ti, tk, q, ld, j1, min(j1 + kb, n));
}

template <int TPT>
__global__ void __launch_bounds__(kRegThreadsMax)
factor_solve_kb_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ x, float* __restrict__ l, int n, int kb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = kTile * ((n + kTile - 1) / kTile);
  const int ld = panel_stride(kb);
  float* pan = reinterpret_cast<float*>(smem_raw);
  float* w = pan + 2 * ld * np;
  float* stage = w + np;
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  copy_upper_issue(a + m_off, stage, n);
  RegTiles<float, TPT> m;
  load_tiles(a + m_off, m, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) w[i] = b[v_off + i];
#pragma unroll
  for (int s = 0; s < TPT; ++s) publish_cols(m.v[s], m.ti[s], m.tk[s], pan, ld, 0, min(kb, n));
  for (int j0 = 0, panel = 0; j0 < n; j0 += kb, ++panel) {
    const int j1 = min(j0 + kb, n);
    float* p = pan + (panel & 1) * ld * np;
    float* q = pan + ((panel + 1) & 1) * ld * np;
    __syncthreads();
    if (threadIdx.x < 32) factor_kb_panel_warp(p, ld, w, j0, j1, n);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < TPT; ++s) kb_tile_pass(m.v[s], m.ti[s], m.tk[s], p, q, ld, j0, j1, kb, n);
    // the panel's solved rows into the rows below it, ascending j
    for (int i = j1 + threadIdx.x; i < n; i += blockDim.x) {
      float wi = w[i];
      for (int k = 0; k < j1 - j0; ++k) wi = fma_t(-p[i * ld + k], w[j0 + k], wi);
      w[i] = wi;
    }
  }
  __syncthreads();
  store_tiles(m, l + m_off, n);
  backward_regs(m, pan, w, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[v_off + i] = w[i];
  copy_upper_finish(stage, l + m_off, n);
}

// ---------------------------------------------------------------------------
// smem_sol: the speed-of-light probe of the lane factor.
//
// chol_factor_lane's kernel (chol_lane.cu::factor_kernel) as it is: its
// grid, block (threads from ops/chol_lane.py::reg_geometry), shared memory,
// the upper triangle's cp.async stage, load_tiles and store_tiles, and per
// panel of 4 columns the publish to the two panel buffers, the two block
// barriers, warp 0's register panel pass with its shuffles, the read-back
// and the trailing pass over every thread's tiles (lane_regs.cuh::
// factor_regs), with the arithmetic taken out (ProbeMath): each
// multiply-add a_rc <- fma(-l_rj, l_cj, a_rc) becomes a_rc <- a_rc 0.999,
// each pivot scale the same, and the inverse pivot's rsqrt and Newton step
// go. The probe does not need the panel values, and ptxas drops a load or a
// shuffle whose value goes unused, so ProbeMath keeps them in the code that
// runs: the trailing pass's 16-byte shared loads are volatile PTX
// (ld.volatile.shared, which ptxas keeps), and each of warp 0's shuffles is
// multiplied by 0 and added to the value it would have updated or scaled.
// So every update and scale is one fma, fma(a, 0.999, z) with z = +-0, as
// in the factor, and the panel pass adds one multiply per shuffle.
// Element (r, c) of the lower triangle is touched c times by trailing
// updates and once by its column's scale, so it comes out as a 0.999^(c+1),
// the product rounded after each multiply (adding +-0 to a nonzero product
// changes no bit); the upper triangle keeps the input. The TPU probe also
// scaled the upper part of each trailing block, because its factor updated
// it; the port's factor updates the lower triangle only, and so does its
// probe.
//
// The launcher holds the probe to chol_factor_lane's occupancy: where the
// probe, with fewer registers, would fit more blocks on an SM, it is given
// the dynamic shared memory that caps it at the factor's count
// (smem_sol_occupancy reports both; at n = 93 both are 6). Its time over
// chol_factor_lane's is then the share of the factor's time that its
// skeleton (access pattern, barriers, shuffles, occupancy) takes rather
// than its arithmetic.
// ---------------------------------------------------------------------------
struct ProbeMath {
  // l_c: a shuffled value times 0 in the panel pass, 0 in the trailing pass
  __device__ __forceinline__ static float update(float a, float, float l_c) {
    return fmaf(a, kSolScale, l_c);
  }
  __device__ __forceinline__ static float inverse_pivot(float z) { return z; }
  __device__ __forceinline__ static float scale(float a, float z) { return fmaf(a, kSolScale, z); }
  // the panel values are loaded and left unused: v comes back as zeros
  __device__ __forceinline__ static void load(const float* p, float (&v)[kTile]) {
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
    float u0, u1, u2, u3;
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(u0), "=f"(u1), "=f"(u2), "=f"(u3)
                 : "r"(addr));
    v[0] = v[1] = v[2] = v[3] = 0.0f;
  }
  __device__ __forceinline__ static float shfl(float v, int src) {
    return __shfl_sync(0xffffffffu, v, src) * 0.0f;
  }
};

template <int TPT>
__global__ void __launch_bounds__(kRegThreadsMax)
sol_kernel(const float* __restrict__ a, float* __restrict__ o, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pan = reinterpret_cast<float*>(smem_raw);
  float* stage = pan + 2 * kTile * kTile * ((n + kTile - 1) / kTile);
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  copy_upper_issue(a + m_off, stage, n);
  RegTiles<float, TPT> m;
  load_tiles(a + m_off, m, n);
  factor_regs<float, TPT, false, ProbeMath>(m, pan, nullptr, n);
  store_tiles(m, o + m_off, n);
  copy_upper_finish(stage, o + m_off, n);
}

// The probe's dynamic shared memory for (n, threads) and the blocks an SM
// then holds of it and of chol_factor_lane's kernel: chol_factor_lane's
// bytes (two panel buffers and the upper stage), raised where the probe
// would otherwise fit more blocks than the factor to the share of an SM's
// shared memory that leaves room for the factor's count alone.
template <int TPT>
int sol_occupancy(int n, int threads, size_t* bytes, int* probe_blocks, int* factor_blocks) {
  const size_t np = kTile * ((n + kTile - 1) / kTile);
  *bytes = sizeof(float) * (2 * kTile * np + static_cast<size_t>(n) * (n - 1) / 2);
  int err = chol_factor_lane_blocks_per_sm_f32(n, threads, factor_blocks);
  if (!err) err = allow_smem(sol_kernel<TPT>, *bytes);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(probe_blocks, sol_kernel<TPT>, threads,
                                                        *bytes);
  if (err || *probe_blocks <= *factor_blocks) return err;
  int dev, sm_bytes, reserved;
  err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (!err) err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err) return err;
  *bytes = static_cast<size_t>(sm_bytes / *factor_blocks - reserved) / 16 * 16;
  err = allow_smem(sol_kernel<TPT>, *bytes);
  if (!err)
    err = cudaFuncSetAttribute(sol_kernel<TPT>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(probe_blocks, sol_kernel<TPT>, threads,
                                                        *bytes);
  return err;
}

template <int TPT>
int launch_sol_regs(int tpt, const void* a, void* o, int batch, int n, int threads,
                    cudaStream_t stream, int* probe_blocks, int* factor_blocks) {
  if constexpr (TPT > kMaxTPT) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (tpt != TPT)
      return launch_sol_regs<TPT + 1>(tpt, a, o, batch, n, threads, stream, probe_blocks,
                                      factor_blocks);
    size_t bytes;
    int err = sol_occupancy<TPT>(n, threads, &bytes, probe_blocks, factor_blocks);
    if (err) return err;
    if (a != nullptr)
      sol_kernel<TPT><<<batch, threads, bytes, stream>>>(static_cast<const float*>(a),
                                                         static_cast<float*>(o), n);
    return static_cast<int>(cudaGetLastError());
  }
}
template <int TPT>
int launch_kb_regs(int tpt, const void* a, const void* b, void* x, void* l, int batch, int n,
                   int kb, int threads, cudaStream_t stream) {
  if constexpr (TPT > kMaxTPT) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (tpt != TPT)
      return launch_kb_regs<TPT + 1>(tpt, a, b, x, l, batch, n, kb, threads, stream);
    const size_t bytes = kb_smem_bytes(n, kb);
    int err = allow_smem(factor_solve_kb_kernel<TPT>, bytes);
    if (err) return err;
    factor_solve_kb_kernel<TPT><<<batch, threads, bytes, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(x),
        static_cast<float*>(l), n, kb);
    return static_cast<int>(cudaGetLastError());
  }
}

// threads: chol_factor_solve_lane's (ops/chol_lane.py::reg_geometry).
int launch_factor_solve_blocked(const void* a, const void* b, void* x, void* l, int batch,
                                int n, int kb, int threads, void* stream) {
  if (batch == 0) return 0;
  if (n < 1 || kb < 1 || kb > kMaxPanel || threads < 32 || threads % 32 ||
      threads > kRegThreadsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (n + kTile - 1) / kTile;
  const int tpt = (nt * (nt + 1) / 2 + threads - 1) / threads;
  return launch_kb_regs<1>(tpt, a, b, x, l, batch, n, kb, threads,
                           static_cast<cudaStream_t>(stream));
}

// Both warp layouts: block_batch matrices a block.
template <bool Panels, int MaxWarps>
int launch_warp_solve(const void* a, const void* b, void* x, int batch, int n, int block_batch,
                      int nb, void* stream) {
  const size_t bytes = sizeof(float) * block_batch * static_cast<size_t>(column_matrix_floats(n));
  int err = allow_smem(column_solve_kernel<Panels, MaxWarps>, bytes);
  if (err) return err;
  const int blocks = (batch + block_batch - 1) / block_batch;
  column_solve_kernel<Panels, MaxWarps>
      <<<blocks, 32 * block_batch, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(x),
          batch, n, nb);
  return static_cast<int>(cudaGetLastError());
}

int launch_column_solve(const void* a, const void* b, void* x, int batch, int n,
                        int block_batch, void* stream) {
  if (batch == 0) return 0;
  if (n < 1 || block_batch < 1 || block_batch > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_warp_solve<false, kMaxWarps>(a, b, x, batch, n, block_batch, n, stream);
}

int launch_blocked_solve(const void* a, const void* b, void* x, int batch, int n,
                         int block_batch, int nb, void* stream) {
  if (batch == 0) return 0;
  if (block_batch < 1 || block_batch > kMaxWarps || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_batch <= kMaxWarps / 2)
    return launch_warp_solve<true, kMaxWarps / 2>(a, b, x, batch, n, block_batch, nb, stream);
  return launch_warp_solve<true, kMaxWarps>(a, b, x, batch, n, block_batch, nb, stream);
}

// a == nullptr: no launch, only the occupancy of the probe and of the factor.
int launch_sol(const void* a, void* o, int batch, int n, int threads, void* stream,
               int* probe_blocks, int* factor_blocks) {
  if (batch == 0) return 0;
  if (n < 1 || threads < 32 || threads % 32 || threads > kRegThreadsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (n + kTile - 1) / kTile;
  const int tpt = (nt * (nt + 1) / 2 + threads - 1) / threads;
  return launch_sol_regs<1>(tpt, a, o, batch, n, threads, static_cast<cudaStream_t>(stream),
                            probe_blocks, factor_blocks);
}
}  // namespace

extern "C" {

int chol_factor_solve_lane_blocked_f32(const void* a, const void* b, void* x, void* l,
                                       int batch, int n, int kb, int threads, void* stream) {
  return launch_factor_solve_blocked(a, b, x, l, batch, n, kb, threads, stream);
}
int chol_solve_batched_f32(const void* a, const void* b, void* x, int batch, int n,
                           int block_batch, void* stream) {
  return launch_column_solve(a, b, x, batch, n, block_batch, stream);
}
int chol_solve_blocked_f32(const void* a, const void* b, void* x, int batch, int n,
                           int block_batch, int nb, void* stream) {
  return launch_blocked_solve(a, b, x, batch, n, block_batch, nb, stream);
}
int smem_sol_f32(const void* a, void* o, int batch, int n, int threads, void* stream) {
  int probe_blocks, factor_blocks;
  return launch_sol(a, o, batch, n, threads, stream, &probe_blocks, &factor_blocks);
}
// The blocks of the probe and of chol_factor_lane one SM holds at (n,
// threads), as the probe is launched.
int smem_sol_occupancy_f32(int n, int threads, int* probe_blocks, int* factor_blocks) {
  *probe_blocks = *factor_blocks = 0;
  return launch_sol(nullptr, nullptr, 1, n, threads, nullptr, probe_blocks, factor_blocks);
}
}  // extern "C"
