"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. the card: ``torch.cuda.is_available()``, the card's name and power limit
   as ``nvidia-smi`` reports them, the torch and CUDA versions;
2. build the CUDA kernels of ``hybdrt_torch/csrc`` from the checkout, and
   print each kernel's registers and spills as ``ptxas`` reports them;
3. each Cholesky kernel against its plain PyTorch version on the same CUDA
   tensors, at the main path's shape (B=8192, n=93, float32) and at (B=130,
   n=17), within rtol = atol = 2e-4, plus the NaN contract for a
   non-positive pivot and one float64 case; ``chol_factor_solve_lane``'s x
   must equal ``chol_solve_lane``'s bit for bit (the same register-tiled
   factor, with and without its output), and ``chol_solve_factored_lane``'s
   against ``chol_factor_solve_lane``'s L too (the same substitution
   orders); kernel, plain and single library-call times from CUDA events,
   the three kernels timed in turns;
4. the fused kernel ``ip_steps_lane`` against its plain version on the same
   CUDA tensors: equilibrated SPD box QPs from a seed at (8192, 93) and
   (130, 17), float32, 4 and 8 steps, within rtol = atol = 2e-4; a lane with
   an indefinite P comes back equal to its input while its neighbours step;
   one float64 case at (64, 93); kernel and plain times at (8192, 93, 4);
5. the main path: ``hybdrt_torch.BatchedEISFitter`` on the benchmark batch
   (``make_batch(8192, 71)`` of ``hybdrt_torch/utils/probe.py``, the
   benchmark's spectra) with the benchmark's settings, on the card in
   float32, ``fit(adaptive="staged", collect="lazy")`` twice; the launch
   counters are reset just before the second call and the three
   Cholesky kernels must all have launched; the coefficients must be finite,
   and the first 64 spectra refitted by the port on the CPU in float64 must
   agree within the float32 bounds of ``tests/test_f32_accuracy.py`` (Rp
   median, p95 and max, R_inf, and the functional fit);
6. the fused path: the same with ``qp_fused=True``, where every warm QP runs
   ``qp_max_iter_warm`` steps in one ``ip_steps_lane`` launch: all four
   kernels must have launched in the second call, ``ip_steps_lane`` at most
   once per outer pass; the CPU float64 reference is the port's fused fit,
   and the Rp max and R_inf bounds are held on the lanes that stop at the
   same iteration in both precisions (see the comment in ``phase_slice``);
7. the factor-only kernel ``chol_factor_lane`` against its plain version on
   the same CUDA tensors, on the lower triangle, within rtol = atol = 2e-4,
   at the resolve's shape (B=1435, n=94: 205 windows of 7) and at (130, 17)
   in float32 and once in float64; its input must come back unchanged, and a
   non-positive pivot gives NaN in its lane only; kernel and
   ``torch.linalg.cholesky_ex`` times in turns, and plain times, at (1435,
   94) and (8192, 93);
8. the group resolve: a 1024-observation map (``resolve_map``) fitted by
   ``BatchedEISFitter(tau_supergrid=...)`` in float32 on the card, then
   ``hybdrt_torch.resolve_group`` windowed (batch_size 7, overlap 2) and
   coupled, each in float32 and called twice, the launch counters reset
   before the second call, in which ``chol_factor_lane`` and
   ``chol_solve_factored_lane`` must both launch; the coupled KKT residual
   within its tolerance, the coupled group objective no higher than the
   windowed one, every coupled-resolved Rp within 0.05 of the map's truth
   (the float32 windowed Rp error is printed), and the float32 coupled
   resolve within ``RESOLVE_F32_BOUND`` of a float64 one of the same
   blocks; the windowed resolve of the same blocks in float64 on the card
   must hold every Rp within 0.05 of the truth and match a float64 windowed
   resolve on the CPU (the port's plain path): the same IP iteration in
   every window, x within 1e-8 of max |x|; a third float32 call of each
   form under ``torch.profiler`` reports the device time of
   ``chol_solve_factored_lane`` and ``chol_factor_lane``;
9. the layout study (``hybdrt_torch/experiments``): each of its four
   kernels, in every variant the study times, against its plain version on
   the same CUDA tensors at (8192, 93) and (130, 17), float32, within rtol =
   atol = 2e-4, and the probe against its closed form; the pivot contracts
   (NaN in the panel-blocked factor's failed lanes, finite x = b from the
   column and blocked solves where every pivot fails); then
   ``experiments.layouts.study`` once at (8192, 93) with the launch counters
   reset just before it: kernel, plain, library and bound times, and
   t_probe / t_factor for ``chol_factor_lane`` and ``chol_factor_solve_lane``;
10. the IP-loop experiment (``hybdrt_torch/experiments/ip_loop.py``): its
    kernel ``ip_steps_loop`` (the fused steps with the TPU kernels' full-step
    rule) against its plain version on the same CUDA tensors, on phase 4's
    problems (lb with -1 entries) and on the experiment's own, at (8192, 93)
    and (130, 17), float32, 4 and 8 steps, within rtol = atol = 2e-4; the
    indefinite lane of phase 4 keeps its input while its neighbours step; a
    float64 call raises; then ``ip_loop.study(8192, 93, 4)`` with the launch
    counter reset just before it: the kernel against its plain version on
    the inputs it times, the experiment's own check against its reference,
    kernel and ``ip_steps_lane`` times in turns, plain, reference and bound
    times.

The line before the last is a JSON object with one entry per kernel (its
launches from the path it serves: phase 5 for the three fit Cholesky
kernels, phase 6 for ``ip_steps_lane``, phase 8's two timed resolves for
``chol_factor_lane``, phase 9's study for the four layout kernels, phase
10's study for ``ip_steps_loop``); the last line is ``{"ok": true,
"device": {...}}``.
"""
import json
import re
import sys
import time

import numpy as np
import torch

from hybdrt_torch.utils.probe import (bound, card_line, check_steps, chol_ops, cuda_ms,
                                      freeze_lane, in_turns, ip_steps_bound, lower_bytes,
                                      make_batch, qp_batch, resolve_map, solve_ops, spd_batch)

B_BENCH, N_FREQ, MAX_ITER = 8192, 71, 50
# tests/test_pallas_lane_kernels.py: f32 lane kernels vs a dense solve. For
# ip_steps_lane it is 6x the f32-vs-f64 spread of the plain steps on these
# problems (3.4e-5 at B=1024, n=93, 4 steps, on a CPU)
TOL = 2e-4
KERNELS = {
    "chol_factor_solve_lane": ("hybdrt_torch/csrc/chol_lane.cu",
                               "hybdrt_tpu/ops/pallas_chol_lane.py:277"),
    "chol_solve_factored_lane": ("hybdrt_torch/csrc/chol_lane.cu",
                                 "hybdrt_tpu/ops/pallas_chol_lane.py:208"),
    "chol_solve_lane": ("hybdrt_torch/csrc/chol_lane.cu",
                        "hybdrt_tpu/ops/pallas_chol_lane.py:95"),
    "ip_steps_lane": ("hybdrt_torch/csrc/ip_lane.cu", "hybdrt_tpu/ops/pallas_ip_lane.py:157"),
    "chol_factor_lane": ("hybdrt_torch/csrc/chol_lane.cu",
                         "hybdrt_tpu/ops/pallas_chol_lane.py:178"),
    "chol_factor_solve_lane_blocked": ("hybdrt_torch/csrc/chol_layouts.cu",
                                       "experiments/pallas_chol_lane_blocked.py:75"),
    "chol_solve_batched": ("hybdrt_torch/csrc/chol_layouts.cu",
                           "experiments/pallas_chol_column.py:110"),
    "chol_solve_blocked": ("hybdrt_torch/csrc/chol_layouts.cu",
                           "experiments/pallas_chol_blocked.py:158"),
    "smem_sol": ("hybdrt_torch/csrc/chol_layouts.cu", "experiments/vmem_sol.py:63"),
    "ip_steps_loop": ("hybdrt_torch/csrc/ip_lane.cu", "experiments/pallas_ip_loop.py:160"),
}
FIT_KERNELS = ("chol_factor_solve_lane", "chol_solve_factored_lane", "chol_solve_lane")
# The resolve phase: 1024 observations, windows of 7 overlapping by 2 (205
# windows, so 1435 diagonal blocks of n = 94 per factor launch)
RESOLVE_OBS, RESOLVE_B, RESOLVE_N = 1024, 1435, 94
FORMS = {"windowed": dict(batched=True, batch_size=7, overlap=2), "coupled": dict(coupled=True)}
# Every resolved Rp against the map's truth 1 + 0.5 p (tests/test_resolve_coupled.py)
RP_TOL = 0.05
# max |x32 - x64| / max |x64| of the coupled resolve: 3x the spread of the
# port's plain path on the CPU on the same blocks (the card's float32 fit),
# 1.734e-2 (torch_resolve_walls.py); the card's own solve reads 1.793e-3
# there, stopping at 12 IP iterations where the CPU's stops at 13
RESOLVE_F32_BOUND = 0.052


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase_card():
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")


def phase_build():
    from hybdrt_torch.csrc import build
    t0 = time.time()
    lib = build.build()
    build.load()
    print(f"build: {time.time() - t0:.1f} s -> {lib.name}")
    log = lib.with_suffix(".log")
    if log.exists():
        for name, regs, spill in ptxas_report(log.read_text()):
            print(f"  ptxas: {name}: {regs} registers, spill stores/loads {spill}")


def ptxas_report(log):
    """[(kernel, registers, "stores/loads bytes")] from the ``-Xptxas=-v``
    log, each kernel named with its template arguments (f or d for float or
    double, then the ints and bools, e.g. ``ip_steps_kernel<f,4,0,1>``)."""
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "spill stores" in line:
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spill = f"{st.group(1)}/{st.group(2)} bytes" if st else "?"
        elif "Used" in line and "registers" in line and name is not None:
            out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            name, spill = None, "?"
    return out


def kernel_label(mangled):
    """``factor_solve_kernel<f,5,1>`` from the kernel's mangled name."""
    m = re.search(r"([a-z_]+_kernel)(?:I(\w*?)E+v)?", mangled)
    if m is None:
        return mangled
    args = [t or v for t, v in re.findall(r"^([fd])|L[ib](\d+)", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def compare_kernels():
    """Kernel vs plain per Cholesky kernel; returns ({name: max_abs_err},
    {name: timing dict}) with the times at the main path's shape."""
    from hybdrt_torch.ops import chol_lane as cl

    def close(got, want):
        err = (got - want).abs()
        ok = bool(torch.all(err <= TOL + TOL * want.abs()))
        return ok, float(err.max())

    max_err = {k: 0.0 for k in KERNELS}
    for (b, n) in ((B_BENCH, 93), (130, 17)):
        a, rhs = spd_batch(b, n, torch.float32, seed=n + b)
        rhs2 = rhs * 0.5 - 1.0
        x, l = cl.chol_factor_solve_lane(a, rhs)
        x_p, l_p = cl.chol_factor_solve_lane_plain(a, rhs)
        ok_x, e_x = close(x, x_p)
        ok_l, e_l = close(torch.tril(l), l_p)
        check(ok_x and ok_l, f"chol_factor_solve_lane ({b}, {n}): x err {e_x}, L err {e_l}")
        # the corrector re-solves against the kernel's factor (stale upper
        # triangle included) and is held to the plain solve on the plain factor
        x2 = cl.chol_solve_factored_lane(l, rhs2)
        ok2, e2 = close(x2, cl.chol_solve_factored_lane_plain(l_p, rhs2))
        check(ok2, f"chol_solve_factored_lane ({b}, {n}): err {e2}")
        x3 = cl.chol_solve_lane(a, rhs)
        ok3, e3 = close(x3, cl.chol_solve_lane_plain(a, rhs))
        check(ok3, f"chol_solve_lane ({b}, {n}): err {e3}")
        # the two kernels run the same register-tiled factor and solves, one
        # with the factor's output and one without, so their x agree bit for
        # bit; and the one-warp substitution applies the same orders, so
        # against that factor it gives the same x too
        check(bool(torch.equal(x, x3)), f"chol_factor_solve_lane's x is chol_solve_lane's "
                                        f"bitwise ({b}, {n})")
        check(bool(torch.equal(cl.chol_solve_factored_lane(l, rhs), x)),
              f"chol_solve_factored_lane's x against #1's L is #1's bitwise ({b}, {n})")
        errs = {"chol_factor_solve_lane": max(e_x, e_l), "chol_solve_factored_lane": e2,
                "chol_solve_lane": e3}
        for k, e in errs.items():
            max_err[k] = max(max_err[k], e)
        print(f"kernels vs plain at B={b} n={n} f32: max abs err "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
        if b == B_BENCH:
            # #2 and #3 are defined on the lower triangle and read only that;
            # #1 returns the input's upper triangle, so it reads all of A
            mat, vec, low = a.numel() * 4, rhs.numel() * 4, lower_bytes(b, n)
            # the three kernels in turns (the factor-and-solve with and
            # without the factor's output, and the solve against the factor)
            turns = in_turns({"chol_factor_solve_lane": lambda: cl.chol_factor_solve_lane(a, rhs),
                              "chol_solve_lane": lambda: cl.chol_solve_lane(a, rhs),
                              "chol_solve_factored_lane":
                                  lambda: cl.chol_solve_factored_lane(l, rhs2)})
            print("  in turns: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms"
                                             for k, v in turns.items()))
            # library_ms: one PyTorch call computing the same function, where
            # one exists (none returns both x and the factor)
            times = {
                "chol_factor_solve_lane": dict(
                    ms=float(np.mean(turns["chol_factor_solve_lane"])),
                    plain_ms=cuda_ms(lambda: cl.chol_factor_solve_lane_plain(a, rhs)),
                    library_ms=None,
                    bound=bound(2 * mat + 2 * vec, chol_ops(b, n) + 2 * solve_ops(b, n))),
                "chol_solve_factored_lane": dict(
                    ms=float(np.mean(turns["chol_solve_factored_lane"])),
                    plain_ms=cuda_ms(lambda: cl.chol_solve_factored_lane_plain(l_p, rhs2)),
                    library_ms=cuda_ms(lambda: torch.cholesky_solve(rhs2[:, :, None], l_p)),
                    bound=bound(low + 2 * vec, 2 * solve_ops(b, n))),
                "chol_solve_lane": dict(
                    ms=float(np.mean(turns["chol_solve_lane"])),
                    plain_ms=cuda_ms(lambda: cl.chol_solve_lane_plain(a, rhs)),
                    library_ms=cuda_ms(lambda: torch.linalg.solve(a, rhs)),
                    bound=bound(low + 2 * vec, chol_ops(b, n) + 2 * solve_ops(b, n))),
            }
            for k, t in times.items():
                lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
                print(f"  {k}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                      f"library {lib}, bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
                      f"(B={b}, n={n}, f32, CUDA events, mean of 20)")

    # Non-positive pivot -> NaN (the QP's bad-step guard depends on it)
    a, rhs = spd_batch(4, 17, torch.float32, seed=7)
    a[1, 5, 5] = -1.0
    a[2] = -a[2]
    x, l = cl.chol_factor_solve_lane(a, rhs)
    x3 = cl.chol_solve_lane(a, rhs)
    for t in (x, x3):
        check(bool(torch.isnan(t[1]).all() and torch.isnan(t[2]).all()),
              "NaN on a non-positive pivot")
        check(bool(torch.isfinite(t[0]).all() and torch.isfinite(t[3]).all()),
              "healthy lanes beside a failed one stay finite")
    check(bool(torch.isnan(torch.diagonal(l[1])[5:]).all()), "NaN factor column")
    print("non-positive pivot: NaN in x and L of the failed lanes, finite elsewhere")

    # float64: the kernels exist in f64 so that no CUDA tensor reaches a plain path
    a, rhs = spd_batch(64, 93, torch.float64, seed=11)
    x, l = cl.chol_factor_solve_lane(a, rhs)
    x_p, l_p = cl.chol_factor_solve_lane_plain(a, rhs)
    e64 = max(float((x - x_p).abs().max()), float((torch.tril(l) - l_p).abs().max()),
              float((cl.chol_solve_factored_lane(l, rhs) - x_p).abs().max()),
              float((cl.chol_solve_lane(a, rhs) - x_p).abs().max()))
    check(e64 < 1e-10, f"float64 kernels vs plain: err {e64}")
    print(f"float64 (B=64, n=93): max abs err {e64:.3g}")
    torch.cuda.synchronize()
    return max_err, times


def compare_ip_kernel():
    """ip_steps_lane vs its plain version; returns (max_abs_err, timing dict)
    with the times at (B=8192, n=93, 4 steps)."""
    from hybdrt_torch.ops import ip_lane

    max_err = 0.0
    for (b, n) in ((B_BENCH, 93), (130, 17)):
        args = qp_batch(b, n, torch.float32, seed=b + n)
        frozen = 7 if b == 130 else None
        if frozen is not None:
            freeze_lane(args, frozen)
        for n_steps in (4, 8):
            errs = check_steps("ip_steps_lane", ip_lane.ip_steps_lane, ip_lane.ip_steps_lane_plain,
                               args, n_steps, TOL, frozen)
            max_err = max(max_err, *errs)
        if b == B_BENCH:
            steps = 4
            timing = dict(ms=cuda_ms(lambda: ip_lane.ip_steps_lane(*args, steps)),
                          plain_ms=cuda_ms(lambda: ip_lane.ip_steps_lane_plain(*args, steps)),
                          library_ms=None, bound=ip_steps_bound(b, n, steps))
            print(f"  ip_steps_lane: kernel {timing['ms']:.4f} ms, plain "
                  f"{timing['plain_ms']:.4f} ms, library none, bound "
                  f"{timing['bound'][0]:.4f} ms by {timing['bound'][1]} "
                  f"(B={b}, n={n}, {steps} steps, f32, CUDA events, mean of 20)")

    args = qp_batch(64, 93, torch.float64, seed=11)
    e64 = max(float((g - w).abs().max()) for g, w in
              zip(ip_lane.ip_steps_lane(*args, 8), ip_lane.ip_steps_lane_plain(*args, 8)))
    check(e64 < 1e-10, f"float64 ip_steps_lane vs plain: err {e64}")
    print(f"ip_steps_lane float64 (B=64, n=93, 8 steps): max abs err {e64:.3g}")
    torch.cuda.synchronize()
    return max_err, timing


def phase_slice(fused):
    """The main path on the card (with fused warm QPs if ``fused``); returns
    (launch counts of the timed call, its wall in s)."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane

    label = "fused slice" if fused else "slice"
    freq, z = make_batch(B_BENCH, N_FREQ)
    kw = dict(max_iter=MAX_ITER, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True,
              pred_rtol=3e-2, qp_fused=fused)
    fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda", **kw)
    t0 = time.time()
    fitter.fit(z, adaptive="staged", collect="lazy")
    torch.cuda.synchronize()
    warm_s = time.time() - t0

    cl.reset_launch_counts()
    ip_lane.reset_launch_counts()
    t0 = time.time()
    res = fitter.fit(z, adaptive="staged", collect="lazy")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**cl.LAUNCHES, **ip_lane.LAUNCHES}

    check(isinstance(res.weights, torch.Tensor) and res.weights.is_cuda,
          "collect='lazy' keeps weights on the card")
    path = [*FIT_KERNELS, "ip_steps_lane"] if fused else FIT_KERNELS
    check(all(launches[k] > 0 for k in path), f"every kernel of the path launched: {launches}")
    if fused:
        # one launch per warm outer pass; the passes are as many as the
        # slowest lane's iterations, the first of them the cold peel
        passes = int(res.n_iter.max())
        check(launches["ip_steps_lane"] <= passes,
              f"ip_steps_lane launched {launches['ip_steps_lane']} times in {passes} passes")
    else:
        check(launches["ip_steps_lane"] == 0, "the plain path does not fuse")
    check(bool(np.all(np.isfinite(res.x)) and np.all(np.isfinite(res.r_inf))),
          "finite coefficients")
    z_hat = fitter.predict_z(res)
    rel = np.abs(z_hat - z) / np.abs(z)
    med_rel = float(np.median(rel))
    pct = np.percentile(res.n_iter, [50, 90, 99, 100])
    print(f"{label}: B={B_BENCH} n_freq={N_FREQ} staged lazy f32: first call {warm_s:.2f} s, "
          f"second call {wall:.3f} s -> {B_BENCH / wall:.1f} spectra/s; "
          f"converged {int(res.converged.sum())}/{B_BENCH}; "
          f"median |z_hat - z|/|z| {med_rel:.4g}; n_iter p50/p90/p99/max {pct.tolist()}")
    print(f"{label}: launches in the timed call: {launches}")
    if not res.converged.all():
        print(f"{label}: unconverged lanes {np.flatnonzero(~res.converged).tolist()}")
    # the noise is ~0.4% of |z|; a fit that missed the spectra sits far above
    check(med_rel < 0.02, f"median relative residual {med_rel}")

    # f32 on the card vs f64 on the CPU, first 64 spectra
    ref = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **kw)
    t0 = time.time()
    r64 = ref.fit(z[:64], adaptive="staged")
    cpu_s = time.time() - t0
    rp32 = fitter.predict_r_p(res)[:64]
    rp64 = ref.predict_r_p(r64)
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)
    d_rinf = np.abs(res.r_inf[:64] - r64.r_inf)
    # Diagnostic: with pred_stop a lane that settles at another iteration in
    # f32 than in f64 lands elsewhere on its settled plateau; the lanes that
    # stop at the same iteration show the float32 arithmetic alone
    same = res.n_iter[:64] == r64.n_iter
    print(f"{label}: f32 card vs f64 CPU (64 spectra, CPU fit {cpu_s:.1f} s): Rp rel err "
          f"median {np.median(rel_rp):.3g} p95 {np.percentile(rel_rp, 95):.3g} max "
          f"{np.max(rel_rp):.3g}, max |dR_inf| {np.max(d_rinf):.3g}")
    if same.any():
        print(f"  {int(same.sum())} lanes stopped at the same iteration: Rp rel err max "
              f"{np.max(rel_rp[same]):.3g}, max |dR_inf| {np.max(d_rinf[same]):.3g}")
    worst = np.argsort(-rel_rp)[:4]
    print(f"  worst Rp lanes {worst.tolist()}: rel err {rel_rp[worst].tolist()}, n_iter f32 "
          f"{res.n_iter[:64][worst].tolist()} f64 {r64.n_iter[worst].tolist()}")
    # tests/test_f32_accuracy.py's bounds. The functional fit (predicted
    # impedance) and the Rp median and p95 are held on all 64 lanes. The Rp
    # max and R_inf are held on all lanes of the plain path; on the fused path
    # on the lanes that stop at the same iteration in both precisions: there
    # a lane that settles an iteration later in float32 lands elsewhere on its
    # settled plateau, as in the JAX package's own float32 fused fit, which
    # breaks the all-lane Rp max on these spectra (PERF.md, Findings)
    zrel = np.max(np.abs(z_hat[:64] - ref.predict_z(r64)), axis=1) / np.max(np.abs(z[:64]), axis=1)
    print(f"  functional fit: sup |z_hat32 - z_hat64| / max |z| max {np.max(zrel):.3g}")
    check(np.median(rel_rp) < 1e-3, "Rp median rel err < 1e-3")
    check(np.percentile(rel_rp, 95) < 3e-3, "Rp p95 rel err < 3e-3")
    check(np.max(zrel) < 1.5e-2, "functional fit rel err < 1.5e-2")
    held = same if fused else np.ones(64, dtype=bool)
    check(held.sum() >= 16, f"{int(held.sum())} lanes stopped at the same iteration")
    check(np.max(rel_rp[held]) < 5e-3, "Rp max rel err < 5e-3")
    check(np.max(d_rinf[held]) < 5e-3, "max |dR_inf| < 5e-3")
    return launches, wall


def compare_factor_kernel():
    """chol_factor_lane vs its plain version; returns (max_abs_err, timing
    dict) with the times at the resolve's shape."""
    from hybdrt_torch.ops import chol_lane as cl

    max_err, timing = 0.0, None
    for (b, n) in ((RESOLVE_B, RESOLVE_N), (130, 17)):
        a, _ = spd_batch(b, n, torch.float32, seed=3 * n + b)
        a_in = a.clone()
        l = cl.chol_factor_lane(a)
        l_p = cl.chol_factor_lane_plain(a)
        err = (torch.tril(l) - l_p).abs()
        e = float(err.max())
        check(bool(torch.all(err <= TOL + TOL * l_p.abs())), f"chol_factor_lane ({b}, {n}): err {e}")
        torch.cuda.synchronize()
        check(bool(torch.equal(a, a_in)), "chol_factor_lane leaves its input unchanged")
        max_err = max(max_err, e)
        print(f"chol_factor_lane vs plain at B={b} n={n} f32: max abs err {e:.3g}; input unchanged")

    # Non-positive pivot -> NaN in that lane only
    a, _ = spd_batch(4, 17, torch.float32, seed=7)
    a[1, 5, 5] = -1.0
    a[2] = -a[2]
    l = cl.chol_factor_lane(a)
    check(bool(torch.isnan(torch.diagonal(l[1])[5:]).all()
               and torch.isfinite(torch.diagonal(l[1])[:5]).all()
               and torch.isnan(torch.diagonal(l[2])).all()), "NaN from the non-positive pivot on")
    check(bool(torch.isfinite(torch.tril(l[0])).all() and torch.isfinite(torch.tril(l[3])).all()),
          "healthy lanes beside a failed one stay finite")
    print("chol_factor_lane non-positive pivot: NaN in the failed lanes, finite elsewhere")

    a, _ = spd_batch(64, RESOLVE_N, torch.float64, seed=13)
    e64 = float((torch.tril(cl.chol_factor_lane(a)) - cl.chol_factor_lane_plain(a)).abs().max())
    check(e64 < 1e-10, f"float64 chol_factor_lane vs plain: err {e64}")
    print(f"chol_factor_lane float64 (B=64, n={RESOLVE_N}): max abs err {e64:.3g}")

    for (b, n) in ((RESOLVE_B, RESOLVE_N), (B_BENCH, 93)):
        a, _ = spd_batch(b, n, torch.float32, seed=n)
        # the kernel and its library call in turns; read A once, write L
        # once; (n^3 - n)/6 multiply-adds per factor
        turns = in_turns({"chol_factor_lane": lambda: cl.chol_factor_lane(a),
                          "cholesky_ex": lambda: torch.linalg.cholesky_ex(a)})
        print("  in turns: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms"
                                         for k, v in turns.items()))
        t = dict(ms=float(np.mean(turns["chol_factor_lane"])),
                 plain_ms=cuda_ms(lambda: cl.chol_factor_lane_plain(a)),
                 library_ms=float(np.mean(turns["cholesky_ex"])),
                 bound=bound(2 * a.numel() * 4, chol_ops(b, n)))
        print(f"  chol_factor_lane: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library (cholesky_ex) {t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"by {t['bound'][1]} (B={b}, n={n}, f32, CUDA events, mean of 20)")
        if timing is None:
            timing = t
    torch.cuda.synchronize()
    return max_err, timing


def phase_resolve():
    """The group resolve on the card; returns the chol_factor_lane launches of
    the two timed resolves."""
    import hybdrt_torch
    from hybdrt_torch.mapping.drtmd import group_objective
    from hybdrt_torch.ops import chol_lane as cl

    freq, tau_super, p, z = resolve_map(RESOLVE_OBS)
    fitter = hybdrt_torch.BatchedEISFitter(freq, tau_supergrid=tau_super, dtype=torch.float32,
                                           device="cuda", qp_max_iter=20, qp_max_iter_warm=4)
    t0 = time.time()
    res = fitter.fit(z, adaptive="staged", collect="lazy")
    torch.cuda.synchronize()
    n_tau = fitter.tau_indices[1] - fitter.tau_indices[0]
    print(f"resolve map: {RESOLVE_OBS} obs, {len(freq)} frequencies, basis {n_tau} of the "
          f"{len(tau_super)}-point supergrid (nc = {n_tau + fitter.num_special}); fit f32 "
          f"{time.time() - t0:.2f} s, converged {int(res.converged.sum())}/{RESOLVE_OBS}")
    check(isinstance(res.weights, torch.Tensor) and res.weights.is_cuda, "lazy weights on the card")

    outs, factor_launches = {}, 0
    for label, kw in FORMS.items():
        t0 = time.time()
        hybdrt_torch.resolve_group(fitter, res, z, psi=p, dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        first = time.time() - t0
        cl.reset_launch_counts()
        t0 = time.time()
        out = hybdrt_torch.resolve_group(fitter, res, z, psi=p, dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cl.LAUNCHES)
        check(launches["chol_factor_lane"] > 0 and launches["chol_solve_factored_lane"] > 0,
              f"{label} resolve launched chol_factor_lane and chol_solve_factored_lane: {launches}")
        check(all(launches[k] == 0 for k in ("chol_factor_solve_lane", "chol_solve_lane")),
              f"{label} resolve launches no fit kernel: {launches}")
        factor_launches += launches["chol_factor_lane"]
        info = out.info
        n_iter = np.atleast_1d(info["n_iter"])
        print(f"{label} resolve f32: first call {first:.3f} s, second call {wall:.4f} s; "
              f"IP iterations {'max ' if n_iter.size > 1 else ''}{int(n_iter.max())}"
              + (f" (windows {info['windows']}, median {float(np.median(n_iter)):.0f})"
                 if n_iter.size > 1 else "")
              + f"; PCG solves {info['pcg_solves']}, CG iterations {info['cg_iterations']} "
              f"({info['cg_iterations'] / max(info['pcg_solves'], 1):.2f} per solve); "
              f"host syncs {info['host_syncs']}")
        print(f"{label} resolve: launches in the timed call: {launches}")
        lane_kernel_times(label, lambda: hybdrt_torch.resolve_group(
            fitter, res, z, psi=p, dtype=torch.float32, **kw))
        check(np.all(np.isfinite(out.x)) and out.x.shape == (RESOLVE_OBS, n_tau),
              f"{label} resolve: finite x of shape ({RESOLVE_OBS}, {n_tau})")
        outs[label] = out

    # The same blocks in float64 on the card, and windowed in float64 on the
    # CPU (the port's plain path); everything is printed before the checks
    r64 = {}
    for label, kw in FORMS.items():
        t0 = time.time()
        r64[label] = hybdrt_torch.resolve_group(fitter, res, z, psi=p, dtype=torch.float64, **kw)
        torch.cuda.synchronize()
        print(f"{label} resolve f64 on the card: {time.time() - t0:.3f} s, IP iterations "
              f"max {int(np.max(r64[label].info['n_iter']))}")
    t0 = time.time()
    cpu64 = hybdrt_torch.resolve_group(fitter, res, z, psi=p, dtype=torch.float64, device="cpu",
                                       **FORMS["windowed"])
    print(f"windowed resolve f64 on the CPU: {time.time() - t0:.2f} s")

    def rp_err(out):
        return float(np.max(np.abs(fitter.predict_r_p(out) - (1 + 0.5 * p))))

    def spread(out, ref):
        return float(np.max(np.abs(out.x - ref.x)) / np.max(np.abs(ref.x)))

    info = outs["coupled"].info
    f_win = group_objective(fitter, res, z, p, outs["windowed"])
    f_cpl = group_objective(fitter, res, z, p, outs["coupled"])
    f32_spread = spread(outs["coupled"], r64["coupled"])
    print(f"coupled KKT residual {info['kkt_residual']:.4g} (tolerance {info['kkt_tol']:.4g}); "
          f"f64 KKT {r64['coupled'].info['kkt_residual']:.3g}")
    print(f"group objective: windowed {f_win:.8g}, coupled {f_cpl:.8g}")
    print(f"max |Rp - (1 + 0.5 p)|: coupled f32 {rp_err(outs['coupled']):.4g}, windowed f64 "
          f"{rp_err(r64['windowed']):.4g} (f32 {rp_err(outs['windowed']):.4g}, reported)")
    print(f"coupled f32 vs f64 of the same blocks on the card: max |dx| / max |x| "
          f"{f32_spread:.4g} (bound {RESOLVE_F32_BOUND})")
    same = r64["windowed"].info["n_iter"] == cpu64.info["n_iter"]
    dx64 = spread(r64["windowed"], cpu64)
    print(f"windowed f64, card vs CPU on the same blocks: max |dx| / max |x| {dx64:.4g}; "
          f"same IP iteration in {int(same.sum())} of {same.size} windows")

    check(rp_err(outs["coupled"]) < RP_TOL, "coupled resolve: every Rp within 0.05 of the truth")
    check(info["kkt_residual"] <= info["kkt_tol"], "coupled KKT residual within its tolerance")
    check(f_cpl <= f_win, "the coupled objective is no higher than the windowed one")
    check(f32_spread <= RESOLVE_F32_BOUND, "float32 coupled resolve tracks float64")
    # The float32 windowed resolve stops some windows within a few IP steps,
    # far from their optimum, in the reference's own solver too, and which
    # ones turns on float32 rounding (ROADMAP.md, Queue 3 item 7): its Rp is
    # reported, and the windowed path on the card (per-window loops and the
    # flattened kernel batches) is held in float64, to the truth and to the
    # CPU's plain path
    check(rp_err(r64["windowed"]) < RP_TOL, "float64 windowed resolve: every Rp within 0.05")
    check(same.all() and dx64 < 1e-8,
          "float64 windowed resolve on the card: the CPU's IP iterations and x within 1e-8")
    return factor_launches


def lane_kernel_times(label, fn):
    """One more call of ``fn`` under torch.profiler with CUDA activity:
    prints the device time and launches of the two lane kernels of the
    resolve (``solve_factored_kernel`` and ``factor_kernel``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    parts = []
    for kernel in ("solve_factored_kernel", "factor_kernel"):
        hits = [e for e in rows if kernel in e.key]
        parts.append(f"{kernel} {sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms in "
                     f"{sum(e.count for e in hits)} launches")
    print(f"{label} resolve, profiled third call, device time: " + ", ".join(parts))


def phase_layouts():
    """The layout study's kernels against their plain versions, then the
    study at the fit's shape; returns ({name: max_abs_err}, {name: launches
    of the study}, {name: timing dict})."""
    from hybdrt_torch.experiments import (chol_blocked, chol_column, chol_lane_blocked,
                                          layouts, smem_sol)

    modules = {m.NAME: m for m in (chol_lane_blocked, chol_column, chol_blocked, smem_sol)}
    max_err = {k: 0.0 for k in modules}
    for (b, n) in ((B_BENCH, 93), (130, 17)):
        a, rhs = spd_batch(b, n, torch.float32, seed=5 * n + b)
        errs = layouts.check_variants(a, rhs)
        for k, e in errs.items():
            max_err[k] = max(max_err[k], e)
        o, closed = smem_sol.smem_sol(a), a * smem_sol.sol_weights(n, device=a.device)
        check(bool(torch.all((o - closed).abs() <= TOL + TOL * closed.abs())),
              f"smem_sol ({b}, {n}) against its closed form 0.999^(c+1)")
        print(f"layout kernels vs plain at B={b} n={n} f32, every variant of the study: "
              "max abs err " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + "; smem_sol equals its closed form")

    a, rhs = spd_batch(4, 17, torch.float32, seed=7)
    a[1, 5, 5] = -1.0
    a[2] = -a[2]
    x, l = chol_lane_blocked.chol_factor_solve_lane_blocked(a, rhs)
    check(bool(torch.isnan(x[1]).all() and torch.isnan(x[2]).all()
               and torch.isfinite(x[0]).all() and torch.isfinite(x[3]).all()
               and torch.isnan(torch.diagonal(l[1])[5:]).all()
               and torch.isfinite(torch.diagonal(l[1])[:5]).all()),
          "chol_factor_solve_lane_blocked: NaN from a non-positive pivot on, in its lane only")
    want = chol_column.chol_solve_batched_plain(a, rhs)
    for name, got in ((chol_column.NAME, chol_column.chol_solve_batched(a, rhs)),
                      (chol_blocked.NAME, chol_blocked.chol_solve_blocked(a, rhs, nb=4))):
        check(bool(torch.isfinite(got).all()
                   and torch.all((got - want).abs() <= TOL + TOL * want.abs())
                   and torch.equal(got[2], rhs[2])),
              f"{name}: finite x as the plain version, x = b where every pivot fails")
    print("layout pivot contracts: the panel-blocked factor NaN in its failed lanes; the "
          "column and blocked solves finite, x = b where every pivot fails")

    for m in modules.values():
        m.reset_launch_counts()
    res = layouts.study(B_BENCH, 93, check=False)
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES[k] for k, m in modules.items()}
    check(all(v > 0 for v in launches.values()), f"every layout kernel launched: {launches}")
    ratios = res["kernels"][smem_sol.NAME]["probe_over_factor"]
    print(f"layout study launches: {launches}; t_probe / t_factor: "
          + ", ".join(f"{k} {r:.4f}" for k, r in ratios.items())
          + "; blocks an SM holds (probe, chol_factor_lane) at n = 93: "
          + str(smem_sol.occupancy(93)))
    times = {k: dict(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                     bound=(r["bound_ms"], r["bound_by"]))
             for k, r in res["kernels"].items()}
    return max_err, launches, times


def phase_ip_loop():
    """The IP-loop experiment's kernel against its plain version, then the
    experiment at the fused fit's shape; returns (max_abs_err, launches of
    the study, timing dict)."""
    from hybdrt_torch.experiments import ip_loop

    max_err = 0.0
    for (b, n) in ((B_BENCH, 93), (130, 17)):
        box = qp_batch(b, n, torch.float32, seed=b + n + 1)
        frozen = 7 if b == 130 else None
        if frozen is not None:
            freeze_lane(box, frozen)
        cases = (("phase 4's box QPs", box, frozen),
                 ("the experiment's problems", ip_loop.make_problems(b, n, seed=b + n), None))
        for label, args, lane in cases:
            for n_steps in (4, 8):
                errs = check_steps(ip_loop.NAME, ip_loop.ip_steps_loop,
                                   ip_loop.ip_steps_loop_plain, args, n_steps, TOL, lane,
                                   f", {label}")
                max_err = max(max_err, *errs)
    args = qp_batch(4, 17, torch.float64, seed=11)
    try:
        ip_loop.ip_steps_loop(*args, 4)
    except TypeError as e:
        print(f"{ip_loop.NAME} float64: raises ({e})")
    else:
        check(False, f"{ip_loop.NAME} refuses float64 on the card")

    ip_loop.reset_launch_counts()
    res = ip_loop.study(B_BENCH, 93, 4)
    torch.cuda.synchronize()
    launches = ip_loop.LAUNCHES[ip_loop.NAME]
    check(launches > 0, f"{ip_loop.NAME} launched in the study: {launches}")
    print(f"IP-loop study launches: {launches}")
    timing = dict(ms=res["ms"], plain_ms=res["plain_ms"], library_ms=res["library_ms"],
                  bound=(res["bound_ms"], res["bound_by"]))
    return max(max_err, res["max_abs_err"]), launches, timing


def main():
    phase_card()
    phase_build()
    max_err, times = compare_kernels()
    max_err["ip_steps_lane"], times["ip_steps_lane"] = compare_ip_kernel()
    launches, wall = phase_slice(fused=False)
    fused_launches, fused_wall = phase_slice(fused=True)
    launches["ip_steps_lane"] = fused_launches["ip_steps_lane"]
    max_err["chol_factor_lane"], times["chol_factor_lane"] = compare_factor_kernel()
    launches["chol_factor_lane"] = phase_resolve()
    layout_err, layout_launches, layout_times = phase_layouts()
    max_err.update(layout_err)
    launches.update(layout_launches)
    times.update(layout_times)
    max_err["ip_steps_loop"], launches["ip_steps_loop"], times["ip_steps_loop"] = phase_ip_loop()
    print(f"second-call wall, B={B_BENCH}: plain {wall:.4f} s ({B_BENCH / wall:.1f} spectra/s), "
          f"fused {fused_wall:.4f} s ({B_BENCH / fused_wall:.1f} spectra/s)")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu, "launches": launches[k],
         "max_abs_err": max_err[k], "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"],
         "bound_ms": times[k]["bound"][0], "bound_by": times[k]["bound"][1],
         "library_ms": times[k]["library_ms"]} for k, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
