"""Inputs and timers shared by the repository's scripts that drive the port on
a CUDA card (``chip_smoke.py``, ``torch_fit_walls.py``,
``torch_resolve_walls.py``, the experiments ``hybdrt_torch.experiments.
layouts`` and ``ip_loop``, ``utils/kernel_digest.py``) and by its tests.

Nothing here is on a fitting path: it makes seeded test inputs, reads the
card's name and power limit, times calls, computes a call's bound (the
least time the card could take for its bytes and operations), and holds one
parameter covariance against another by the readouts users take from it.
"""
import subprocess
import time

import numpy as np
import torch

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes through HBM and do n_ops float32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lower_bytes(b, n, itemsize=4):
    """Bytes of the lower triangles (diagonal included) of b (n, n) matrices,
    b n (n + 1) / 2 values: what a function defined on the lower triangle
    must read of its matrix."""
    return b * n * (n + 1) // 2 * itemsize


def chol_ops(b, n):
    """Operations of b Cholesky factorizations: the trailing updates of the
    lower triangle, sum_k k (k + 1) / 2 = (n^3 - n) / 6 multiply-adds each
    (about n^3 / 6), two operations a multiply-add."""
    return b * (n ** 3 - n) / 3


def solve_ops(b, n):
    """Operations of b forward and backward substitutions."""
    return b * 2 * n * n


def ip_steps_bound(b, n, n_steps):
    """(bound_ms, bound_by) of ``n_steps`` fused Mehrotra steps on b lanes of
    size n, float32: P and five vectors read once, three vectors written once;
    per step the factor, the matvec and two substitutions (the O(n) vector
    work, under 1 % of it, is left out)."""
    ops = n_steps * (chol_ops(b, n) + b * 2 * n * n + 2 * solve_ops(b, n))
    return bound(4 * b * n * n + 8 * 4 * b * n, ops)


def card_line():
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi exit {smi.returncode}: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def make_batch(batch, n_freq, seed=1):
    """The benchmark's spectra (``bench.py::make_batch``, copied so that the
    port's scripts need nothing of the TPU benchmark): ``batch`` 2-ZARC
    spectra with a series inductance on ``logspace(6, -1, n_freq)``, complex
    noise of 0.004. Returns (freq, z)."""
    rng = np.random.default_rng(seed)
    freq = np.logspace(6, -1, n_freq)
    z = np.zeros((batch, n_freq), dtype=complex)
    for i in range(batch):
        r1, r2 = rng.uniform(0.3, 1.5, 2)
        t1 = 10 ** rng.uniform(-5, -2)
        t2 = 10 ** rng.uniform(-2, 0.5)
        a1, a2 = rng.uniform(0.8, 0.95, 2)
        z[i] = (0.5 + r1 / (1 + (2j * np.pi * freq * t1) ** a1)
                + r2 / (1 + (2j * np.pi * freq * t2) ** a2)
                + 2j * np.pi * freq * 1e-7)
    noise = rng.normal(size=(batch, n_freq)) + 1j * rng.normal(size=(batch, n_freq))
    return freq, z + noise * 0.004


def make_frames(batch, n_freq, n_frames, drift, seed=1):
    """An operando sequence of ``n_frames`` frames of ``batch`` spectra of
    ``make_batch``'s kind: each lane draws ``make_batch``'s parameters once
    (two ZARCs and a series inductance on ``logspace(6, -1, n_freq)``), and
    in frame f its R1 is scaled by 1 + drift f, log10 tau1 moves by
    +drift f and log10 tau2 by -drift f, with fresh complex noise of 0.004
    in every frame, all from one numpy seed. Frame 0 is of ``make_batch``'s
    distribution but not its draws. Returns (freq, z) with z of shape
    (n_frames, batch, n_freq)."""
    rng = np.random.default_rng(seed)
    freq = np.logspace(6, -1, n_freq)
    r1, r2 = rng.uniform(0.3, 1.5, (2, batch, 1))
    lt1, lt2 = rng.uniform(-5, -2, (batch, 1)), rng.uniform(-2, 0.5, (batch, 1))
    a1, a2 = rng.uniform(0.8, 0.95, (2, batch, 1))
    jw = 2j * np.pi * freq
    frames = []
    for f in range(n_frames):
        z = (0.5 + r1 * (1 + drift * f) / (1 + (jw * 10 ** (lt1 + drift * f)) ** a1)
             + r2 / (1 + (jw * 10 ** (lt2 - drift * f)) ** a2) + jw * 1e-7)
        noise = rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)
        frames.append(z + noise * 0.004)
    return freq, np.stack(frames)


def make_stream(batch, n_freq):
    """A stream of four batches of ``make_batch``'s spectra, of batch, batch,
    batch // 2 and batch lanes, each from its own seed (11 to 14). Returns
    (freq, [z, ...])."""
    sizes = (batch, batch, batch // 2, batch)
    return (make_batch(1, n_freq)[0],
            [make_batch(n, n_freq, seed=11 + i)[1] for i, n in enumerate(sizes)])


def cov_readouts(fitter, n_tau=56):
    """(Q, N) rows u of the variances a user reads off a parameter covariance
    C as u^T C u: the DRT at ``n_tau`` log-spaced points over the basis (the
    CI band squared, on the grid of tests/test_f32_accuracy.py) and R_inf
    (sigma(R_inf) squared)."""
    from ..ops import basis as basis_mod

    tau = np.logspace(np.log10(fitter.basis_tau[0]), np.log10(fitter.basis_tau[-1]), n_tau)
    em = basis_mod.construct_func_eval_matrix(np.log(fitter.basis_tau), np.log(tau),
                                              epsilon=fitter.tau_epsilon)
    ns = fitter.num_special
    u = np.zeros((n_tau + 1, ns + em.shape[1]))
    u[:n_tau, ns:] = em
    u[n_tau, fitter.special_qp_params["R_inf"]["index"]] = 1.0
    return u


def readout_errors(cov, p, cov_ref, p_ref, u):
    """The readouts u^T C u (rows of ``u``) of the scaled covariance ``cov``
    against those of ``cov_ref``, both (B, N, N) float64 inverses of the
    posterior precisions ``p`` and ``p_ref``: (relative error, bound), each
    (B, Q). The bound is first order in the perturbation of P behind the
    difference: each inverse's rounding, a componentwise perturbation of
    sqrt(N) eps |P| (the probabilistic backward error of an LU inverse, in
    place of the worst case's 3 N eps), and |p - p_ref|. With C = cov_ref,

        |C u|^T (sqrt(N) eps |P| + |p - p_ref|) |C u| / |u^T C u|,

    the readout's own sensitivity: near eps on a well-conditioned lane, and
    as loose along P's near-null directions as float64 leaves them."""
    v = np.einsum("qi,bij,qj->bq", u, cov, u)
    v_ref = np.einsum("qi,bij,qj->bq", u, cov_ref, u)
    cu = np.abs(np.einsum("bij,qj->bqi", cov_ref, u))
    pert = np.sqrt(p.shape[-1]) * np.finfo(float).eps * np.abs(p_ref) + np.abs(p - p_ref)
    bound = np.einsum("bqi,bij,bqj->bq", cu, pert, cu) / np.abs(v_ref)
    return np.abs(v - v_ref) / np.abs(v_ref), bound


def inverse_residual(p, cov):
    """Per lane ||P C - I||_2 / (||P||_2 ||C||_2): the normwise backward
    error of C as the inverse of P, which a stable inverse keeps below
    N eps however ill-conditioned P is."""
    eye = np.eye(p.shape[-1])
    norm = lambda a: np.linalg.norm(a, 2, axis=(1, 2))
    return norm(p @ cov - eye) / (norm(p) * norm(cov))


def spd_batch(b, n, dtype, seed, device="cuda"):
    """b seeded SPD matrices G G^T + n I of size n and b right-hand sides."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, n))
    a = g @ np.swapaxes(g, 1, 2) + n * np.eye(n)
    rhs = rng.normal(size=(b, n))
    return (torch.as_tensor(a, dtype=dtype, device=device),
            torch.as_tensor(rhs, dtype=dtype, device=device))


def qp_batch(b, n, dtype, seed, device="cuda"):
    """b equilibrated (unit-diagonal) SPD box QPs of size n with a strictly
    interior warm start and lb in {-1, 0}, as ``ops/qp.py::solve_qp_box``
    hands them to the fused steps: [P, q, lb, x0, s0, z0]."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, n))
    a = g @ np.swapaxes(g, 1, 2) / n + 0.1 * np.eye(n)
    dinv = 1 / np.sqrt(np.einsum("bii->bi", a))
    lb = np.where(rng.uniform(size=(b, n)) < 0.25, -1.0, 0.0)
    s0 = rng.uniform(0.05, 2.0, size=(b, n))
    arrays = (a * dinv[:, :, None] * dinv[:, None, :], rng.normal(size=(b, n)), lb, lb + s0,
              s0, rng.uniform(0.05, 2.0, size=(b, n)))
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in arrays]


def freeze_lane(args, lane):
    """Make ``lane`` of the box QPs ``args`` (``qp_batch``) indefinite: -P,
    with s = 1 and z = 0.1 so that z/s cannot lift its negated diagonal. Its
    first pivot is negative, so the fused steps must leave it as it was."""
    args[0][lane] = -args[0][lane]
    args[4][lane], args[5][lane] = 1.0, 0.1
    args[3][lane] = args[2][lane] + args[4][lane]


def check_steps(name, fn, plain, args, n_steps, tol, frozen=None, label=""):
    """Fused steps ``fn`` against ``plain`` on the same box QPs ``args``
    (``qp_batch``), within rtol = atol = ``tol`` on x, s and z; lane
    ``frozen`` must keep its input while its neighbours step. Prints the
    errors and returns the max abs errors of x, s and z; raises RuntimeError
    on a miss."""
    got, want = fn(*args, n_steps), plain(*args, n_steps)
    b, n = args[1].shape
    errs = []
    for part, g, w in zip("xsz", got, want):
        err = (g - w).abs()
        if not bool(torch.all(err <= tol + tol * w.abs())):
            raise RuntimeError(f"{name} at ({b}, {n}, {n_steps} steps) {part}: max abs err "
                               f"{float(err.max())} beyond rtol = atol = {tol}")
        errs.append(float(err.max()))
    if frozen is not None:
        others = torch.ones(b, dtype=torch.bool, device=args[1].device)
        others[frozen] = False
        for g, inp in zip(got, args[3:]):
            if not torch.equal(g[frozen], inp[frozen]):
                raise RuntimeError(f"{name}: the failed lane {frozen} does not keep its input")
            if not bool(torch.isfinite(g).all() and (g[others] != inp[others]).any(dim=1).all()):
                raise RuntimeError(f"{name}: a neighbour of the failed lane {frozen} did not step")
    tag = {torch.float32: "f32", torch.float64: "f64"}[args[1].dtype]
    print(f"{name} vs plain at B={b} n={n} {tag} {n_steps} steps{label}: max abs err "
          f"x {errs[0]:.3g}, s {errs[1]:.3g}, z {errs[2]:.3g}"
          + (f"; lane {frozen} (indefinite P) kept its input" if frozen is not None else ""))
    return errs


def resolve_map(n_obs, seed=8):
    """The smooth analytic map of tests/test_resolve_coupled.py:93-125 on the
    benchmark's grids (71 frequencies, the 111-point supergrid of
    bench.py:180): z = 0.4 + R_ct / (1 + (j w tau)^0.85), R_ct = 1 + 0.5 p,
    tau = 10^(-3 + 2 p), p = linspace(0, 1, n_obs), noise 0.004. Returns
    (freq, tau_supergrid, p, z)."""
    freq, tau_super = np.logspace(6, -1, 71), np.logspace(-8, 3, 111)
    p = np.linspace(0, 1, n_obs)
    rng = np.random.default_rng(seed)
    z = 0.4 + (1 + 0.5 * p[:, None]) / (
        1 + (2j * np.pi * freq[None, :] * 10 ** (-3 + 2 * p[:, None])) ** 0.85)
    z = z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 0.004
    return freq, tau_super, p, z


def cuda_ms(fn, reps=20):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns, reps=20):
    """{name: [ms, ms]}: each callable of the dict ``fns`` timed by
    ``cuda_ms`` in turns, the list and then the list backwards."""
    ms = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        ms[k].append(cuda_ms(fns[k], reps))
    return ms


class FitLaunches:
    """Inside ``with``, records the lane kernels' launches made by each call
    of ``fitter._fit_plain`` (the fit of one batch, by ``fit`` or
    ``fit_stream``) in ``per_fit``, one dict per call, as the difference of
    the wrappers' counts around the call (no count is reset)."""

    def __init__(self, fitter):
        self.fitter, self.per_fit = fitter, []

    def __enter__(self):
        from ..ops import chol_lane, ip_lane

        real = self.fitter._fit_plain
        counts = lambda: {**chol_lane.LAUNCHES, **ip_lane.LAUNCHES}

        def counted(rzv):
            before = counts()
            out = real(rzv)
            self.per_fit.append({k: v - before[k] for k, v in counts().items()})
            return out

        self.fitter._fit_plain = counted
        return self

    def __exit__(self, *exc):
        del self.fitter._fit_plain


def timed(fn):
    """Host-clock seconds of one call of ``fn`` that ends in a synchronize."""
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def profile(label, fn, top=8):
    """One call of ``fn`` under ``torch.profiler`` with CUDA activity: prints
    its wall, summed kernel time, busy share and the ``top`` kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CUDA]) as p:
        wall = timed(fn)
    rows = [e for e in p.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in rows)
    print(f"{label} profiled: wall {wall:.4f} s, kernel time {total_us / 1e6:.4f} s in "
          f"{sum(e.count for e in rows)} kernels, busy {total_us / 1e6 / wall:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x  {e.key[:90]}")
