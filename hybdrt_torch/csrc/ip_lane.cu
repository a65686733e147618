// Fused fixed-count Mehrotra interior-point steps for a batch of box QPs
//     min 1/2 x'Px + q'x  s.t.  x >= lb.
//
// One kernel, two corrector step rules (the template parameter kFullStep):
//
// - ip_steps_lane_{f32,f64} replaces the TPU kernel
//   hybdrt_tpu/ops/pallas_ip_lane.py::ip_steps_lane (:157), with the step rule
//   of the JAX package's plain loop, hybdrt_tpu/ops/qp.py::_ip_steps_single
//   (:157-192): the corrector's step is min(1, 0.99 min(1, ratio)), never more
//   than 0.99. The TPU kernel takes min(1, 0.99 ratio) (pallas_ip_lane.py:
//   133-134), a full step where one is feasible; the fit follows the plain
//   loop.
// - ip_steps_loop_f32 replaces the experiment's TPU kernel
//   experiments/pallas_ip_loop.py::ip_steps_lane (:160), with that kernel's
//   rule: min(1, 0.99 ratio), the fraction-to-boundary ratio unclamped
//   (pallas_ip_loop.py:136-137). It is float32 only, as its TPU kernel was.
//   The two TPU kernels compute the same steps (they differ only in the span
//   of the factor's trailing update, of which only the lower triangle is
//   read), so the experiment needs no second design.
//
// The predictor's step is min(1, ratio) under both rules.
//
// Each step, per lane: H = P + diag(z/s); r_d = P x + q - z; r_p = s - (x - lb);
// mu = s.z/n; factor H; predictor solve; fraction-to-boundary ratios; mu_aff
// and sigma = clip((mu_aff / max(mu, 1e-30))^3, 0, 1); corrector solve against
// the same factor; step lengths; s, z floored at 1e-25 (f32) or 1e-30 (f64).
// A lane whose new x or z has a non-finite entry (a non-positive pivot gives
// NaN, lane_common.cuh) keeps its last iterate for every remaining step. There
// is no convergence test: every lane takes n_steps steps.
//
// Design: one thread block per lane, H's lower triangle in registers. P
// stays in device memory and is read at every step, for the matvec and to
// rebuild H; the resident blocks' P (at n = 93, four blocks of 35 KB per SM,
// 18 MB on 132 SMs) stays in the 50 MB L2. Each step builds H = P + diag(z/s)
// in the 4x4 register tiles of lane_regs.cuh
// and factors it there (factor_regs, two block barriers per panel of 4
// columns), with the predictor's forward substitution fused into the
// panels; the backward substitution (backward_regs) and the corrector's two
// (forward_regs, backward_regs) run against the factor still in registers,
// two barriers per tile column or row. The whole block computes r_d (a warp
// per row, four rows at a time); warp 0 alone does the O(n) vector work and
// the reductions, with
// warp shuffles and no block barrier. All vectors live in shared memory, so
// nothing goes to device memory between steps. The threads per block and
// the tiles a thread follow n (ops/ip_lane.py::geometry), one instantiation
// per tile count. The outputs do not depend on the geometry: the factor and
// substitution orders are fixed (lane_regs.cuh), and the matvec (lane-strided
// sums and warp_sum), the step lengths, mu, sigma and the freeze sum in
// orders that do not depend on the number of warps.
//
// What bounds it: per step the n^3/6 multiply-adds of the factor (n = 93:
// ~1.3e5 per lane) and the n^2 of the matvec and of each substitution, in
// chains of dependent panels and tile steps, each behind a block barrier.
// Device memory traffic is one read of P and of five vectors and one write
// of three; the reads of P after the first come from L2. Holding P in shared
// memory instead (35.7 KB a block at n = 93) was slower at every batch size
// measured: the blocks an SM holds are set by registers either way (four of
// 96 threads at n = 93 in f32, 162 registers a thread), and the L2 reads
// overlap. Registers also bound the sizes taken: at most kMaxTPT<T> tiles a
// thread on kRegThreadsMax threads (n <= 216 in f32, 152 in f64); no f32
// instantiation spills, the f64 one of 2 tiles spills 16 bytes. Several
// lanes per block, `mma` for the trailing update and TMA loads are left for
// later work.
//
// NaN: jnp.maximum, jnp.minimum and jnp.clip propagate NaN, and fmaxf/fminf
// do not, so the floors, caps and min-reductions below are written with
// comparisons that return a NaN operand.
//
// Each launcher returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.

#include "lane_regs.cuh"

namespace {

using namespace hybdrt_lane;

constexpr int kVectors = 13;
// Rows of P x a warp sums at a time
constexpr int kRows = 4;

template <typename T>
__device__ __forceinline__ T floor_at(T v, T lo) { return v < lo ? lo : v; }

template <typename T>
__device__ __forceinline__ T cap_at(T v, T hi) { return v > hi ? hi : v; }

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (a < b || a != a) ? a : b; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Fraction-to-boundary ratio: the largest alpha with v + alpha dv >= 0, not
// capped (+inf where no dv is negative, NaN where a dv is NaN); warp-wide,
// every lane of the warp gets the result. cap_at(ratio, 1) is
// qp.py::_max_step.
template <typename T>
__device__ __forceinline__ T min_ratio_warp(const T* v, const T* dv, int n) {
  T r = T(INFINITY);
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const T d = dv[i];
    r = nan_min(r, d < T(0) ? -v[i] / d : T(INFINITY));
  }
  return warp_min(r);
}

// The corrector's step length from its ratio: min(1, 0.99 ratio) with the
// full-step rule, else min(1, 0.99 min(1, ratio)). NaN stays NaN either way.
template <bool kFullStep, typename T>
__device__ __forceinline__ T corrector_step(T ratio) {
  return cap_at(T(0.99) * (kFullStep ? ratio : cap_at(ratio, T(1))), T(1));
}

template <typename T, int TPT, bool kFullStep>
__global__ void __launch_bounds__(kRegThreadsMax)
ip_steps_kernel(const T* __restrict__ p, const T* __restrict__ q, const T* __restrict__ lb,
                const T* __restrict__ x0, const T* __restrict__ s0, const T* __restrict__ z0,
                T* __restrict__ x_out, T* __restrict__ s_out, T* __restrict__ z_out, int n,
                int n_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = kTile * ((n + kTile - 1) / kTile);
  T* pan = reinterpret_cast<T*>(smem_raw);  // two panel buffers of np x 4
  T* x = pan + 2 * kTile * np;
  T* s = x + n;
  T* z = s + n;
  T* qv = z + n;
  T* lbv = qv + n;
  T* d = lbv + n;    // z / s
  T* rd = d + n;     // P x + q - z
  T* rp = rd + n;    // s - (x - lb)
  T* w = rp + n;     // right-hand side, then the solution, of each solve
  T* dsa = w + n;    // predictor ds
  T* dza = dsa + n;  // predictor dz
  T* rc = dza + n;   // corrector complementarity residual
  T* dz = rc + n;    // corrector dz (the corrector ds is kept in dsa)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t m_off = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t v_off = static_cast<size_t>(blockIdx.x) * n;
  const T tiny = sizeof(T) == 8 ? T(1e-30) : T(1e-25);
  const T inv_n = T(1) / T(n);
  const T* pm = p + m_off;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] = x0[v_off + i];
    s[i] = s0[v_off + i];
    z[i] = z0[v_off + i];
    qv[i] = q[v_off + i];
    lbv[i] = lb[v_off + i];
  }
  __syncthreads();

  RegTiles<T, TPT> h;
  bool frozen = false;  // meaningful in warp 0, the same in each of its lanes
  for (int step = 0; step < n_steps; ++step) {
    // r_d, a warp per row, kRows rows of a warp at a time (independent sums,
    // each in the order of one row alone)
    for (int r0 = warp; r0 < n; r0 += kRows * n_warps) {
      T acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = T(0);
      for (int c = lane; c < n; c += 32) {
        const T xc = x[c];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = r0 + j * n_warps;
          if (r < n) {
            const T pv = pm[r * n + c];
            acc[j] += pv * xc;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + j * n_warps;
        if (lane == 0 && r < n) rd[r] = acc[j] + qv[r] - z[r];
      }
    }
    // H = P + diag(z / s), its lower tiles in registers
    load_tiles(pm, h, n);
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
      if (h.ti[t] >= 0 && h.ti[t] == h.tk[t]) {
#pragma unroll
        for (int rr = 0; rr < kTile; ++rr) {
          const int r = kTile * h.ti[t] + rr;
          if (r < n) {
            const T pv = h.v[t][rr][rr];
            h.v[t][rr][rr] = pv + z[r] / s[r];
          }
        }
      }
    }
    __syncthreads();

    // Predictor (affine scaling) step: its right-hand side, then the factor
    // with the forward substitution fused in, then the backward one
    T mu = T(0);
    if (warp == 0) {
      for (int i = lane; i < n; i += 32) {
        const T di = z[i] / s[i];
        const T rpi = s[i] - (x[i] - lbv[i]);
        d[i] = di;
        rp[i] = rpi;
        w[i] = -rd[i] - z[i] + di * rpi;
        mu += s[i] * z[i];
      }
      mu = warp_sum(mu) * inv_n;
    }
    factor_regs<T, TPT, true>(h, pan, w, n);
    backward_regs(h, pan, w, n);

    if (warp == 0) {
      for (int i = lane; i < n; i += 32) {
        const T dsi = w[i] - rp[i];
        dsa[i] = dsi;
        dza[i] = -z[i] - d[i] * dsi;
      }
      const T a_p = cap_at(min_ratio_warp(s, dsa, n), T(1));
      const T a_d = cap_at(min_ratio_warp(z, dza, n), T(1));
      T mu_aff = T(0);
      for (int i = lane; i < n; i += 32) mu_aff += (s[i] + a_p * dsa[i]) * (z[i] + a_d * dza[i]);
      mu_aff = warp_sum(mu_aff) * inv_n;
      const T ratio = mu_aff / floor_at(mu, T(1e-30));
      const T sigma = cap_at(floor_at(ratio * ratio * ratio, T(0)), T(1));

      // Corrector step against the same factor
      for (int i = lane; i < n; i += 32) {
        const T rci = s[i] * z[i] + dsa[i] * dza[i] - sigma * mu;
        rc[i] = rci;
        w[i] = -rd[i] - rci / s[i] + d[i] * rp[i];
      }
    }
    forward_regs(h, pan, w, n);
    backward_regs(h, pan, w, n);

    if (warp == 0) {
      for (int i = lane; i < n; i += 32) {
        const T dsi = w[i] - rp[i];
        dsa[i] = dsi;
        dz[i] = -rc[i] / s[i] - d[i] * dsi;
      }
      const T a_p = corrector_step<kFullStep>(min_ratio_warp(s, dsa, n));
      const T a_d = corrector_step<kFullStep>(min_ratio_warp(z, dz, n));

      // New iterate, unless a lane's step is not finite: then it keeps its
      // last iterate from here on
      bool bad = false;
      for (int i = lane; i < n; i += 32) {
        const T xn = x[i] + a_p * w[i];
        const T zn = floor_at(z[i] + a_d * dz[i], tiny);
        bad = bad || !isfinite(xn) || !isfinite(zn);
      }
      frozen = frozen || __any_sync(0xffffffffu, bad);
      if (!frozen) {
        for (int i = lane; i < n; i += 32) {
          x[i] = x[i] + a_p * w[i];
          s[i] = floor_at(s[i] + a_p * dsa[i], tiny);
          z[i] = floor_at(z[i] + a_d * dz[i], tiny);
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x_out[v_off + i] = x[i];
    s_out[v_off + i] = s[i];
    z_out[v_off + i] = z[i];
  }
}

// Shared memory of a block (ops/ip_lane.py::smem_bytes mirrors it): two
// panel buffers of np x 4 and kVectors vectors.
template <typename T>
inline size_t smem_bytes(int n) {
  const size_t np = kTile * ((n + kTile - 1) / kTile);
  return sizeof(T) * (2 * kTile * np + kVectors * static_cast<size_t>(n));
}

// The kernel for TPT tiles a thread, TPT = 1 .. kMaxTPT<T>
// (ops/ip_lane.py::geometry picks the threads and TPT follows; its
// MAX_TILES_PER_THREAD mirrors kMaxTPT).
template <typename T> constexpr int kMaxTPT = 4;
template <> constexpr int kMaxTPT<double> = 2;

template <typename T, bool kFullStep, int TPT>
int launch_tpt(int tpt, const void* p, const void* q, const void* lb, const void* x0,
               const void* s0, const void* z0, void* x, void* s, void* z, int batch, int n,
               int n_steps, int threads, cudaStream_t stream) {
  if constexpr (TPT > kMaxTPT<T>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (tpt != TPT)
      return launch_tpt<T, kFullStep, TPT + 1>(tpt, p, q, lb, x0, s0, z0, x, s, z, batch, n,
                                               n_steps, threads, stream);
    // under the 48 KB a block may use without opting in, at every n taken
    const size_t bytes = smem_bytes<T>(n);
    ip_steps_kernel<T, TPT, kFullStep><<<batch, threads, bytes, stream>>>(
        static_cast<const T*>(p), static_cast<const T*>(q), static_cast<const T*>(lb),
        static_cast<const T*>(x0), static_cast<const T*>(s0), static_cast<const T*>(z0),
        static_cast<T*>(x), static_cast<T*>(s), static_cast<T*>(z), n, n_steps);
    return static_cast<int>(cudaGetLastError());
  }
}

// threads: a multiple of 32, at most kRegThreadsMax, with ceil(tiles /
// threads) <= kMaxTPT<T>.
template <typename T, bool kFullStep>
int launch_ip_steps(const void* p, const void* q, const void* lb, const void* x0,
                    const void* s0, const void* z0, void* x, void* s, void* z, int batch,
                    int n, int n_steps, int threads, void* stream) {
  if (batch == 0) return 0;
  const int nt = (n + kTile - 1) / kTile;
  const int n_tiles = nt * (nt + 1) / 2;
  if (n < 1 || threads < 32 || threads % 32 || threads > kRegThreadsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpt = (n_tiles + threads - 1) / threads;
  return launch_tpt<T, kFullStep, 1>(tpt, p, q, lb, x0, s0, z0, x, s, z, batch, n, n_steps,
                                     threads, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int ip_steps_lane_f32(const void* p, const void* q, const void* lb, const void* x0,
                      const void* s0, const void* z0, void* x, void* s, void* z, int batch,
                      int n, int n_steps, int threads, void* stream) {
  return launch_ip_steps<float, false>(p, q, lb, x0, s0, z0, x, s, z, batch, n, n_steps,
                                      threads, stream);
}
int ip_steps_lane_f64(const void* p, const void* q, const void* lb, const void* x0,
                      const void* s0, const void* z0, void* x, void* s, void* z, int batch,
                      int n, int n_steps, int threads, void* stream) {
  return launch_ip_steps<double, false>(p, q, lb, x0, s0, z0, x, s, z, batch, n, n_steps,
                                       threads, stream);
}
int ip_steps_loop_f32(const void* p, const void* q, const void* lb, const void* x0,
                      const void* s0, const void* z0, void* x, void* s, void* z, int batch,
                      int n, int n_steps, int threads, void* stream) {
  return launch_ip_steps<float, true>(p, q, lb, x0, s0, z0, x, s, z, batch, n, n_steps,
                                     threads, stream);
}
}  // extern "C"
