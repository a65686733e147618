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
6b. operando frames (run after 6, plain and then fused): ``make_frames(8192,
   71, 4, 0.02)`` of ``hybdrt_torch/utils/probe.py`` with the benchmark's
   settings in float32, frame 0 cold and frames 1-3 each warm from the
   previous frame's lazy result (``fit(z, warm_from=prev, collect="lazy")``),
   then frame 3 cold, every fit called twice and the second call timed with
   the launch counters reset just before it. Each warm frame prints its
   wall, iteration counts and lane kernel launches; the plain path must run
   the three fit kernels and no fused steps, the fused path
   ``ip_steps_lane`` once per outer pass (no cold iteration 0), and on the
   fused path an untimed first call counts the lanes the fused steps latch
   (``LatchWatch``). Every frame's coefficients finite and median relative
   residual < 0.02; on frame 3 the warm fit takes fewer mean iterations than
   the cold one, its median |z - z_obs| is within 1.5x the cold fit's, and
   on the plain path it converges at least as many lanes; each warm frame of
   the first 64 lanes against the same chain fitted in float64 on the CPU
   within the Rp median and p95 and functional-fit bounds of phase 5 (the
   Rp max and R_inf are reported; see the comment in ``phase_frames``);
6c. a stream of batches (run after 6b, plain and then fused):
   ``make_stream(8192, 71)`` of ``hybdrt_torch/utils/probe.py`` (four
   batches of 8192, 8192, 4096 and 8192 lanes) fitted one after another,
   each ``fit`` called twice and the second call timed, then
   ``fit_stream`` over the four twice, with the results dropped as they
   come and then held; the launch counters are reset just before the
   second stream. Every result bitwise its sequential fit's, each batch's
   lane kernel launches in the stream those of its sequential fit; the
   card's allocated memory back at its level before the stream once the
   results are dropped, and grown by the lazy fields' bytes while they are
   held; the stream's wall against the sum of the sequential walls;
6d. the parameter covariance: a B=8192 float32 fit of phase 5's kind, then
   ``param_cov`` with ``refine_iters`` 0 and 3 (float64 on the card, the
   refinement's QPs through the float64 fit kernels), every covariance
   finite, walls and launches; the first 64 lanes' scaled covariance on the
   card against the port's on the CPU from the same result, within the
   bounds of ``tests/test_torch_cov.py``: P within 1e-6 of each lane's max
   |P|, the covariance within max(1e-6, cond(P) max(eps, dP)) of each lane's
   max |cov|, each CI-band point and sigma(R_inf) (as variances) within its
   own first-order bound (``probe.readout_errors``), and the card's inverse
   within N eps backward error of the card's P; reported, not held, the
   CI-band and sigma(R_inf) errors of the
   float32 fit, with and without 3 refinement steps, against a float64 fit
   of the 64 lanes on the CPU (the quantities of
   ``tests/test_f32_accuracy.py::test_f32_covariance_and_ci_certification``);
6e. the history: ``fit(z, return_history=True)`` of the B=8192 plain
   float32 fit, called twice, the second timed with the launch counters
   reset just before it: (B, 50, ...) arrays whose entries from a lane's
   last iteration on repeat its final state, whose last x is ``x_raw``, and
   a result bitwise the plain ``fit``'s; its wall against the plain fit's
   and its bytes;
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
   column solve and from the blocked solve at nb = 3, 4 and n where every
   pivot fails); then ``experiments.layouts.study`` once at (8192, 93) with
   the launch counters reset just before it: kernel, plain, library and
   bound times, the panel-blocked factor-solve's kb variants beside
   ``chol_factor_solve_lane``, the column solve's block_batch variants and
   the blocked solve's (nb, block_batch) variants beside
   ``chol_solve_lane``, and t_probe / t_factor for ``chol_factor_lane`` and
   ``chol_factor_solve_lane``;
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
    times;
11. the single fit: ``hybdrt_torch.DRT().fit_eis`` on the golden spectrum of
    ``tests/test_drt_fit_golden.py`` (``utils/probe.py::golden_fit``) on the
    card in float64 (n = 93, the lane kernels at one lane), called twice with
    the launch counters reset before the second, in which #1-#3 must all
    launch; x, R_inf, inductance, z_sigma_tot and q_vector within the golden
    test's tolerances; against the port's float64 fit on the CPU the same
    n_iter and converged flag, x within 1e-6 of max |x|; the warm
    ``fit_eis`` wall (min of 10) and its launches; then the B = 1 float32
    ``BatchedEISFitter.fit`` of the benchmark's single-fit leg
    (``bench.py:394-402``, ``make_batch(1, 71, seed=9)``), its warm wall (min
    of 10) and launches;
12. the ragged fit: the het leg's 768 EIS spectra on three grids
    (``make_het_eis``) through ``BatchedRaggedFitter(TAU_SUPER, float32,
    qp_max_iter=20, qp_max_iter_warm=4)`` with ``fit(adaptive="staged")``
    (``bench.py:183-190``), twice, the launch counters reset before the
    second, in which #1-#3 must all launch: finite coefficients, padded
    coefficient tails exactly zero, the median over observations of the
    relative residual on each observation's own grid below 0.02, the
    converged lanes reported; ``prepare`` and the loop timed apart; the first
    64 observations against a float64 fit on the card: Rp median, p95 and
    max, max |dR_inf| and the functional fit within phase 5's bounds; #1 and
    #2 against their plain versions at TOL on their first calls, the first
    QP's first Mehrotra step, and #3 on the system #1 solved there; #3's own
    first call, the cold start of the weight initialization's overfit ridge,
    too ill-conditioned in float32 for two solvers to agree at TOL, held to
    a backward error of 10 n eps, kernel and plain alike;
13. hybrid (chrono + EIS) fits, galvanostatic with ideal steps: (a)
    ``DRT().fit_hybrid`` with the weight factor methods None, "weight" and
    "rp", and one ``fit_chrono``, on the seeded data of
    ``tests/test_chrono_hybrid.py`` (``utils/probe.py::hybrid_data``) in
    float64 on the card, each with the launch counters reset before it and
    #1-#3 launched, against the port's float64 fit on the CPU (same n_iter,
    x within 1e-6 of max |x|) and within the test's recovery bounds; (b)
    ``BatchedHybridFitter`` on ``make_hybrid_batch(1024)`` (het protocol 0,
    float32, the het leg's QP caps), ``fit(adaptive="staged",
    collect="lazy")`` twice, plain and ``qp_fused``, the second call timed
    with the counters reset (#1-#3 launched, and ``ip_steps_lane`` on the
    fused path at most once a pass, never on the plain one), the first 64
    lanes against a float64 fit on the card within phase 5's Rp median and
    p95 and functional-fit bounds on the lanes converged in both precisions
    (the functional fit in the scaled data's units, chrono and EIS rows; the
    same over every lane, Rp max and R_inf reported; see
    ``hybrid_bounds``); (c) the het
    leg's 256 hybrid observations on its two chrono protocols
    (``make_het_hybrid``) through ``BatchedRaggedFitter`` in float32 with
    ``fit(adaptive="staged")``, twice, the second timed with the counters
    reset: finite, padded coefficient tails exactly zero, ``prepare`` and
    the loop timed apart, the first 64 observations against float64 on the
    card as in (b), and their median relative residuals on the EIS rows
    (|z_hat - z| / |z|) and on the chrono rows (|y - rzv| over the
    observation's max |rzv|, scaled units) within 1.1 times the float64
    fit's plus 1e-3 (see ``phase_hybrid``); (d) #1-#3 against their plain
    versions on that fit's first QP (256, 83, 83), as in phase 12, and
    ``ip_steps_lane`` against its plain version on the fused fitter's first
    warm QP (1024, 83), within 6x the plain steps' float32-vs-float64 spread
    on that QP (at least TOL; TOL is that multiple on phase 4's QPs).

The line before the last is a JSON object with one entry per kernel (its
launches from the path it serves: phase 5 and phase 13's timed fits for the
three fit Cholesky kernels, phase 6 and phase 13's fused fit for
``ip_steps_lane``, phase 8's two timed resolves for
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

from hybdrt_torch.utils.probe import (GOLDEN_HYPERS, FitLaunches, bound, card_line,
                                      check_steps, chol_ops, cov_readouts, cuda_ms, freeze_lane,
                                      golden_fit, hybrid_data, in_turns, inverse_residual,
                                      ip_steps_bound, lower_bytes, make_batch, make_frames,
                                      make_het_eis, make_het_hybrid, make_hybrid_batch,
                                      make_stream, qp_batch, readout_errors, resolve_map,
                                      solve_ops, spd_batch, timed)

B_BENCH, N_FREQ, MAX_ITER = 8192, 71, 50
# The benchmark's fit knobs (bench.py:458-483)
FIT_KW = dict(max_iter=MAX_ITER, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True,
              pred_rtol=3e-2)
# The frames phase: an operando sequence drifting by 0.02 a frame
N_FRAMES, DRIFT = 4, 0.02
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
    kw = dict(FIT_KW, qp_fused=fused)
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
    # tests/test_f32_accuracy.py's bounds. The Rp max and R_inf are held on
    # all lanes of the plain path; on the fused path on the lanes that stop
    # at the same iteration in both precisions: there a lane that settles an
    # iteration later in float32 lands elsewhere on its settled plateau, as
    # in the JAX package's own float32 fused fit, which breaks the all-lane
    # Rp max on these spectra (PERF.md, Findings)
    hold_to_f64(f"{label}: f32 card vs f64 CPU (64 spectra, CPU fit {time.time() - t0:.1f} s)",
                fitter, res, ref, r64, z, "same" if fused else "all")
    return launches, wall


class LatchWatch:
    """Inside ``with``, every call of the fused steps by the QP
    (``hybdrt_torch.ops.qp.ip_steps_lane``) also runs one step fewer on the
    same inputs and records how many lanes came out the same: a lane whose
    iterate after n steps equals the one after n - 1 has latched (a step gave
    it a non-finite x or z, and the kernel keeps its last iterate,
    ``ops/ip_lane.py``). ``counts`` holds one count per call (one call per
    outer pass), ``first`` the lanes of the first pass, where every lane is
    live, so positions are lane numbers. For an untimed call only: it
    launches the kernel twice per pass."""

    def __init__(self):
        from hybdrt_torch.ops import qp
        self.qp, self.counts, self.first = qp, [], []

    def __enter__(self):
        real = self.fused = self.qp.ip_steps_lane

        def watched(P, q, lb, x0, s0, z0, n_steps):
            out = real(P, q, lb, x0, s0, z0, n_steps)
            short = real(P, q, lb, x0, s0, z0, n_steps - 1)
            held = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
            for a, b in zip(out, short):
                held &= (a == b).all(dim=1)
            lanes = torch.nonzero(held).squeeze(1).tolist()
            if not self.counts:
                self.first = lanes
            self.counts.append(len(lanes))
            return out

        self.qp.ip_steps_lane = watched
        return self

    def __exit__(self, *exc):
        self.qp.ip_steps_lane = self.fused


def phase_frames(fused):
    """An operando sequence on the card: ``make_frames(8192, 71, 4, 0.02)``,
    frame 0 fitted cold and frames 1-3 each warm from the previous frame's
    lazy result (``fit(z, warm_from=prev, collect="lazy")``), then frame 3
    cold for comparison, every fit called twice and the second call timed
    with the launch counters reset just before it. Returns the walls
    {"warm": [frames 1-3], "cold": frame 3's} in s."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane

    t_phase = time.time()
    label = "fused frames" if fused else "frames"
    freq, frames = make_frames(B_BENCH, N_FREQ, N_FRAMES, DRIFT)
    kw = dict(FIT_KW, qp_fused=fused)
    fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda", **kw)

    def fit_twice(z, prev):
        opts = dict(collect="lazy", warm_from=prev)
        watch = LatchWatch() if fused and prev is not None else None
        if watch is None:
            fitter.fit(z, **opts)
        else:
            with watch:
                fitter.fit(z, **opts)
        torch.cuda.synchronize()
        cl.reset_launch_counts()
        ip_lane.reset_launch_counts()
        t0 = time.time()
        res = fitter.fit(z, **opts)
        torch.cuda.synchronize()
        wall = time.time() - t0
        check(bool(np.all(np.isfinite(res.x)) and np.all(np.isfinite(res.r_inf))),
              "finite coefficients")
        rel = float(np.median(np.abs(fitter.predict_z(res) - z) / np.abs(z)))
        check(rel < 0.02, f"median relative residual {rel}")
        return res, wall, {**cl.LAUNCHES, **ip_lane.LAUNCHES}, watch

    def n_iter(res):
        pct = np.percentile(res.n_iter, [50, 90, 100]).tolist()
        return (f"n_iter p50/p90/max {pct} mean {res.n_iter.mean():.4g}, converged "
                f"{int(res.converged.sum())}/{len(res.n_iter)}")

    prev, wall0, _, _ = fit_twice(frames[0], None)
    print(f"{label}: B={B_BENCH} n_freq={N_FREQ} drift {DRIFT} f32 lazy: frame 0 cold "
          f"{wall0:.4f} s, {n_iter(prev)}")
    warm, walls = [], []
    for f in range(1, N_FRAMES):
        res, wall, launches, watch = fit_twice(frames[f], prev)
        passes = int(res.n_iter.max())
        lane_launches = {k: launches[k] for k in (*FIT_KERNELS, "ip_steps_lane")}
        print(f"{label}: frame {f} warm {wall:.4f} s, {n_iter(res)}; launches {lane_launches} "
              f"in {passes} passes")
        if not res.converged.all():
            print(f"  unconverged lanes {np.flatnonzero(~res.converged).tolist()}")
        if fused:
            first = np.array(watch.first, dtype=int)
            print(f"  lanes latched by the fused steps, {{pass: count}}: "
                  f"{ {i + 1: c for i, c in enumerate(watch.counts) if c} }; at pass 1 (iteration "
                  f"0) lanes {first.tolist()}, which end with n_iter {res.n_iter[first].tolist()}, "
                  f"converged {int(res.converged[first].sum())}/{first.size}")
            # every pass of a warm frame runs the fused steps, iteration 0
            # included: no cold peel
            check(launches["ip_steps_lane"] == passes,
                  f"ip_steps_lane launched {launches['ip_steps_lane']} times in {passes} passes")
        else:
            check(all(launches[k] > 0 for k in FIT_KERNELS) and launches["ip_steps_lane"] == 0,
                  f"the plain warm path runs the three fit kernels and no fused steps: {launches}")
        warm.append(res)
        walls.append(wall)
        prev = res
    cold, cold_wall, _, _ = fit_twice(frames[-1], None)
    last = warm[-1]
    print(f"{label}: frame {N_FRAMES - 1} cold {cold_wall:.4f} s, {n_iter(cold)}; warm frame "
          f"walls / cold wall {[round(w / cold_wall, 4) for w in walls]}")

    z_obs = frames[-1]
    z_w, z_c = fitter.predict_z(last), fitter.predict_z(cold)
    rp_w, rp_c = fitter.predict_r_p(last), fitter.predict_r_p(cold)
    d_rp = np.abs(rp_w - rp_c) / rp_c
    resid_w, resid_c = np.median(np.abs(z_w - z_obs)), np.median(np.abs(z_c - z_obs))
    print(f"{label}: frame {N_FRAMES - 1} warm vs cold: max |z_warm - z_cold| "
          f"{np.max(np.abs(z_w - z_c)):.4g}, rel dRp p50/p95/max "
          f"{np.percentile(d_rp, [50, 95, 100]).tolist()}; median |z - z_obs| warm "
          f"{resid_w:.4g} cold {resid_c:.4g}")
    lost = np.flatnonzero(cold.converged & ~last.converged)
    if lost.size:
        print(f"  lanes converged cold and not warm: {lost.tolist()}")
    # tests/test_parallel.py::test_warm_from_previous_frame's criteria
    check(last.n_iter.mean() < cold.n_iter.mean(), "fewer mean iterations warm than cold")
    check(resid_w < 1.5 * resid_c, "warm residual within 1.5x the cold fit's")
    if not fused:
        check(last.converged.sum() >= cold.converged.sum(),
              "as many lanes converged warm as cold")

    # The same chain in float64 on the CPU for the first 64 lanes, each warm
    # frame held to the card's: the functional fit and the Rp median and p95.
    # The Rp max and R_inf are reported: a warm lane can land elsewhere along
    # its R_inf-Rp trade in float32 than in float64 at the same iteration,
    # and the JAX package's own float32 warm frames break both bounds against
    # its float64 ones on these 64 lanes (plain, frame 1) and on 64 lanes of
    # make_frames(64, ...) (fused, frames 1-2) in a CPU run (PERF.md,
    # Findings)
    ref = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **kw)
    t0 = time.time()
    r64 = ref.fit(frames[0][:64])
    chain = []
    for f in range(1, N_FRAMES):
        r64 = ref.fit(frames[f][:64], warm_from=r64)
        chain.append(r64)
    print(f"{label}: the first 64 lanes' frames in f64 on the CPU: {time.time() - t0:.1f} s")
    for f, (res, r64) in enumerate(zip(warm, chain), start=1):
        hold_to_f64(f"{label}: frame {f} warm, f32 card vs f64 CPU", fitter, res, ref, r64,
                    frames[f], None)
    print(f"{label}: phase {time.time() - t_phase:.1f} s")
    return {"warm": walls, "cold": cold_wall}


def same_result(a, b):
    """Every field of two BatchFitResults bit for bit (lazy fields as tensors
    on the card)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            if y is not None:
                return False
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and torch.equal(x, y)):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def phase_stream(fused):
    """A stream of four batches on the card: sequential fits against
    ``fit_stream``. Returns (sequential walls, stream wall) in s."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane

    t_phase = time.time()
    label = "fused stream" if fused else "stream"
    freq, batches = make_stream(B_BENCH, N_FREQ)
    fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda",
                                           qp_fused=fused, **FIT_KW)
    opts = dict(adaptive="staged", collect="lazy")
    seq, walls = [], []
    with FitLaunches(fitter) as seq_counts:
        for z in batches:
            fitter.fit(z, **opts)
            torch.cuda.synchronize()
            t0 = time.time()
            seq.append(fitter.fit(z, **opts))
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
    seq_launches = seq_counts.per_fit[1::2]  # the second, timed call of each batch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for res in fitter.fit_stream(batches):
        check(res.weights.is_cuda, "lazy weights on the card")
    del res
    torch.cuda.synchronize()
    after_dropped = torch.cuda.memory_allocated()

    cl.reset_launch_counts()
    ip_lane.reset_launch_counts()
    t0 = time.time()
    with FitLaunches(fitter) as stream_launches:
        held = list(fitter.fit_stream(batches))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**cl.LAUNCHES, **ip_lane.LAUNCHES}
    grown = torch.cuda.memory_allocated() - before
    lazy = sum(t.numel() * t.element_size() for r in held for t in (r.weights, r.s_vectors))
    same = [same_result(a, b) for a, b in zip(seq, held)]
    del held
    torch.cuda.synchronize()
    after_held = torch.cuda.memory_allocated()
    lane = {k: [c[k] for c in stream_launches.per_fit] for k in (*FIT_KERNELS, "ip_steps_lane")}
    print(f"{label}: batches {[len(z) for z in batches]} f32 lazy: sequential second-call walls "
          f"{[round(w, 4) for w in walls]} s, sum {sum(walls):.4f} s; fit_stream {wall:.4f} s "
          f"(stream / sequential {wall / sum(walls):.4f}); n_iter max "
          f"{[int(r.n_iter.max()) for r in seq]}")
    print(f"{label}: lane kernel launches per batch in the stream {lane}; in the timed stream "
          f"{launches}")
    print(f"{label}: memory allocated before {before} B, after the stream with its results "
          f"dropped {after_dropped} B; results held: +{grown} B for {lazy} B of lazy fields "
          f"({lazy * B_BENCH / sum(len(z) for z in batches) / 1e6:.2f} MB per {B_BENCH} lanes); "
          f"after dropping them {after_held} B")
    check(all(same), f"every stream result bitwise its sequential fit's: {same}")
    check(stream_launches.per_fit == seq_launches,
          "each batch's launches in the stream equal its sequential fit's")
    check(all(launches[k] > 0 for k in FIT_KERNELS)
          and (launches["ip_steps_lane"] > 0) == fused, f"the path's kernels launched: {launches}")
    check(after_dropped == before and after_held == before,
          "allocated memory back at its level once the results are dropped")
    # the allocator may keep up to 1 MiB of an unsplit block with each lazy field
    check(lazy <= grown <= lazy + (1 << 20) * 2 * len(batches),
          "held results grow the allocated memory by their lazy fields")
    print(f"{label}: phase {time.time() - t_phase:.1f} s")
    return walls, wall


def phase_cov():
    """param_cov of a B=8192 float32 fit on the card, refine_iters 0 and 3,
    the first 64 lanes against the CPU; returns the walls {refine_iters: s}
    and the lane kernels' launches of the refined call."""
    import hybdrt_torch
    from hybdrt_torch.ops import basis as basis_mod, chol_lane as cl, ip_lane

    t_phase = time.time()
    freq, z = make_batch(B_BENCH, N_FREQ)
    fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda", **FIT_KW)
    res = fitter.fit(z, adaptive="staged", collect="lazy")
    covs, walls = {}, {}
    for r in (0, 3):
        fitter.param_cov(res, z, refine_iters=r)
        torch.cuda.synchronize()
        cl.reset_launch_counts()
        ip_lane.reset_launch_counts()
        t0 = time.time()
        covs[r] = fitter.param_cov(res, z, refine_iters=r)
        torch.cuda.synchronize()
        walls[r] = time.time() - t0
        launches = {**cl.LAUNCHES, **ip_lane.LAUNCHES}
        print(f"param_cov B={B_BENCH} refine_iters={r}: {walls[r]:.4f} s (second call), "
              f"{covs[r].nbytes / 1e6:.0f} MB float64; launches {launches}")
        check(covs[r].shape == (B_BENCH, 93, 93) and bool(np.all(np.isfinite(covs[r]))),
              f"every covariance finite, refine_iters={r}")
        check(all((launches[k] > 0) == (r > 0) for k in FIT_KERNELS)
              and launches["ip_steps_lane"] == 0,
              "the refinement runs the three fit kernels in float64, no fused steps")
    refine_launches = launches

    # the first 64 lanes, float64 on the card against the CPU
    sub = res._replace(**{f: getattr(res, f)[:64] for f in res._fields
                          if getattr(res, f) is not None})
    cpu = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **FIT_KW)
    eps = np.finfo(float).eps
    lane_max = lambda a: np.max(np.abs(a), axis=(1, 2))
    for r in (0, 3):
        t0 = time.time()
        c_cpu = cpu.param_cov(sub, z[:64], scaled=True, refine_iters=r)
        t_cpu = time.time() - t0
        c_gpu = fitter.param_cov(sub, z[:64], scaled=True, refine_iters=r)
        p_gpu = fitter._posterior(sub, z[:64], r)[0].cpu().numpy()
        p_cpu = cpu._posterior(sub, z[:64], r)[0].numpy()
        d_p = lane_max(p_gpu - p_cpu) / lane_max(p_cpu)
        cond = np.linalg.cond(p_cpu)
        bnd = np.maximum(1e-6, cond * np.maximum(eps, d_p))
        err = lane_max(c_gpu - c_cpu) / lane_max(c_cpu)
        r_err, r_bnd = readout_errors(c_gpu, p_gpu, c_cpu, p_cpu, cov_readouts(cpu))
        resid = inverse_residual(p_gpu, c_gpu)
        print(f"param_cov refine_iters={r}, 64 lanes, card vs CPU (CPU {t_cpu:.1f} s): max dP "
              f"{d_p.max():.3g}, cond(P) median {np.median(cond):.3g} max {cond.max():.3g}; "
              f"cov err max {err.max():.3g}, err / bound max {(err / bnd).max():.3g}, lanes held "
              f"to 1e-6 {int((bnd == 1e-6).sum())} (their err max "
              f"{err[bnd == 1e-6].max() if (bnd == 1e-6).any() else 0:.3g})")
        tight = r_bnd < 1e-6
        print(f"  readouts (CI band, sigma(R_inf)): {r_err.size}, err / bound max "
              f"{(r_err / r_bnd).max():.3g}; bound below 1e-6 on {tight.mean():.4f} (err max "
              f"there {r_err[tight].max() if tight.any() else 0:.3g}), below 1e-2 on "
              f"{(r_bnd < 1e-2).mean():.4f}, max {r_bnd.max():.3g}; card inverse backward error "
              f"max {resid.max():.3g} (N eps {p_gpu.shape[-1] * eps:.3g})")
        check(bool(np.all(d_p <= 1e-6)), "P on the card within 1e-6 of the CPU's")
        check(bool(np.all(err <= bnd)), "covariance on the card within the bound of the CPU's")
        check(bool(np.all(r_err <= r_bnd)), "CI band and sigma(R_inf) on the card within their "
              "bounds of the CPU's")
        check(bool(np.all(resid <= p_gpu.shape[-1] * eps)),
              "the card's covariance a backward-stable inverse of the card's P")

    # Reported: the f32 fit's CI bands and sigma(R_inf), with and without 3
    # refinement steps, against a float64 fit's, unrefined and refined alike
    # (the certification set and quantities of tests/test_f32_accuracy.py:
    # 120-175)
    t0 = time.time()
    r64 = cpu.fit(z[:64], adaptive="staged")
    c64 = {r: cpu.param_cov(r64, z[:64], refine_iters=r) for r in (0, 3)}
    ns = fitter.num_special
    tau_eval = np.logspace(np.log10(fitter.basis_tau[0]), np.log10(fitter.basis_tau[-1]), 56)
    em = basis_mod.construct_func_eval_matrix(np.log(fitter.basis_tau), np.log(tau_eval),
                                              epsilon=fitter.tau_epsilon)
    band = lambda c: np.sqrt(np.maximum(np.einsum("ij,bjk,ik->bi", em, c[:, ns:, ns:], em), 0))
    i_rinf = fitter.special_qp_params["R_inf"]["index"]
    sigma = lambda c: np.sqrt(c[:, i_rinf, i_rinf])
    gpk = np.max(np.abs(r64.x @ em.T), axis=1)
    ok = (np.max(band(c64[0]), axis=1) < gpk) & (sigma(c64[0]) < 0.05 * cpu.predict_r_p(r64))
    print(f"param_cov f32 vs f64 fit (64 lanes; f64 CPU fit and covs {time.time() - t0:.1f} s): "
          f"{int(ok.sum())} lanes certified (f64 band below the peak, sigma(R_inf) < 0.05 Rp)")
    for r32, r64_ in ((0, 0), (3, 0), (3, 3)):
        c32, ref = covs[r32][:64], c64[r64_]
        band_rel = (np.abs(band(c32) - band(ref)) / gpk[:, None])[ok].ravel()
        sig_rel = (np.abs(sigma(c32) - sigma(ref)) / sigma(ref))[ok]
        if ok.any():
            print(f"  f32 refine_iters={r32} vs f64 refine_iters={r64_}: CI band err / peak median "
                  f"{np.median(band_rel):.3g} p95 {np.percentile(band_rel, 95):.3g} max "
                  f"{band_rel.max():.3g}; sigma(R_inf) rel err median {np.median(sig_rel):.3g} "
                  f"p95 {np.percentile(sig_rel, 95):.3g} max {sig_rel.max():.3g} (not held; "
                  f"test_f32_accuracy bounds 1e-3 / 3e-2 / 1.0 and 1e-2 / 1.5e-1 / 1.0)")
    print(f"param_cov: phase {time.time() - t_phase:.1f} s")
    return walls, refine_launches


def phase_history():
    """The B=8192 plain float32 fit with return_history; returns (history
    wall, plain wall, launches of the history fit)."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane
    from hybdrt_torch.solver.fitcore import HISTORY_FIELDS

    t_phase = time.time()
    freq, z = make_batch(B_BENCH, N_FREQ)
    fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda", **FIT_KW)
    fitter.fit(z, return_history=True)
    torch.cuda.synchronize()
    cl.reset_launch_counts()
    ip_lane.reset_launch_counts()
    t0 = time.time()
    res, hist = fitter.fit(z, return_history=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**cl.LAUNCHES, **ip_lane.LAUNCHES}
    fitter.fit(z)
    torch.cuda.synchronize()
    t0 = time.time()
    plain = fitter.fit(z)
    torch.cuda.synchronize()
    plain_wall = time.time() - t0
    t_len = fitter.fcfg.max_iter
    n_bytes = sum(v.nbytes for v in hist.values())
    shapes = {k: v.shape for k, v in hist.items()}
    print(f"history: B={B_BENCH} f32 plain: second call {wall:.4f} s against the plain fit's "
          f"{plain_wall:.4f} s; {n_bytes / 1e6:.1f} MB of history {shapes}; launches {launches}")
    check(set(hist) == set(HISTORY_FIELDS) and all(v.shape[:2] == (B_BENCH, t_len)
                                                   for v in hist.values()),
          "history arrays of shape (B, max_iter, ...)")
    last = np.take_along_axis(hist["x"], (res.n_iter - 1)[:, None, None], axis=1)
    after = np.arange(t_len)[None, :] >= (res.n_iter - 1)[:, None]
    check(bool(np.all((hist["x"] == last) | ~after[:, :, None])),
          "entries from a lane's last iteration on repeat its final state")
    check(bool(np.array_equal(hist["x"][:, -1], res.x_raw)), "the last entry is x_raw")
    check(bool(np.array_equal(hist["it"][:, -1], res.n_iter)), "the last it is n_iter")
    check(same_result(res, plain), "the history fit's result is bitwise the plain fit's")
    check(all(launches[k] > 0 for k in FIT_KERNELS) and launches["ip_steps_lane"] == 0,
          f"the history fit runs the plain path's kernels: {launches}")
    print(f"history: phase {time.time() - t_phase:.1f} s")
    return wall, plain_wall, launches


def hold_to_f64(label, fitter, res, ref, r64, z, hold_max):
    """The card's float32 result ``res`` of ``fitter`` against the CPU's
    float64 ``r64`` of ``ref`` on the first 64 spectra of ``z``, within the
    bounds of tests/test_f32_accuracy.py: the functional fit (predicted
    impedance) and the Rp median and p95 on all 64 lanes; the Rp max and
    R_inf on all lanes (``hold_max="all"``), on the lanes that stop at the
    same iteration in both precisions (``"same"``), or reported only
    (``None``). Prints every number before the checks."""
    rp32 = fitter.predict_r_p(res)[:64]
    rp64 = ref.predict_r_p(r64)
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)
    d_rinf = np.abs(res.r_inf[:64] - r64.r_inf)
    # Diagnostic: with pred_stop a lane that settles at another iteration in
    # f32 than in f64 lands elsewhere on its settled plateau; the lanes that
    # stop at the same iteration show the float32 arithmetic alone
    same = res.n_iter[:64] == r64.n_iter
    print(f"{label}: Rp rel err median {np.median(rel_rp):.3g} p95 "
          f"{np.percentile(rel_rp, 95):.3g} max {np.max(rel_rp):.3g}, max |dR_inf| "
          f"{np.max(d_rinf):.3g}")
    if same.any():
        print(f"  {int(same.sum())} lanes stopped at the same iteration: Rp rel err max "
              f"{np.max(rel_rp[same]):.3g}, max |dR_inf| {np.max(d_rinf[same]):.3g}")
    worst = np.argsort(-rel_rp)[:4]
    print(f"  worst Rp lanes {worst.tolist()}: rel err {rel_rp[worst].tolist()}, n_iter f32 "
          f"{res.n_iter[:64][worst].tolist()} f64 {r64.n_iter[worst].tolist()}")
    z_hat = fitter.predict_z(res)[:64]
    zrel = np.max(np.abs(z_hat - ref.predict_z(r64)), axis=1) / np.max(np.abs(z[:64]), axis=1)
    print(f"  functional fit: sup |z_hat32 - z_hat64| / max |z| max {np.max(zrel):.3g}")
    check(np.median(rel_rp) < 1e-3, "Rp median rel err < 1e-3")
    check(np.percentile(rel_rp, 95) < 3e-3, "Rp p95 rel err < 3e-3")
    check(np.max(zrel) < 1.5e-2, "functional fit rel err < 1.5e-2")
    if hold_max is None:
        return
    held = same if hold_max == "same" else np.ones(64, dtype=bool)
    check(held.sum() >= 16, f"{int(held.sum())} lanes stopped at the same iteration")
    check(np.max(rel_rp[held]) < 5e-3, "Rp max rel err < 5e-3")
    check(np.max(d_rinf[held]) < 5e-3, "max |dR_inf| < 5e-3")


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
    solves = [(chol_column.NAME, chol_column.chol_solve_batched(a, rhs))]
    solves += [(f"{chol_blocked.NAME} nb={nb}", chol_blocked.chol_solve_blocked(a, rhs, nb=nb))
               for nb in (3, 4, 17)]
    for name, got in solves:
        check(bool(torch.isfinite(got).all()
                   and torch.all((got - want).abs() <= TOL + TOL * want.abs())
                   and torch.equal(got[2], rhs[2])),
              f"{name}: finite x as the plain version, x = b where every pivot fails")
    print("layout pivot contracts: the panel-blocked factor NaN in its failed lanes; the "
          "column and blocked (nb = 3, 4, n) solves finite, x = b where every pivot fails")

    for m in modules.values():
        m.reset_launch_counts()
    res = layouts.study(B_BENCH, 93, check=False)
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES[k] for k, m in modules.items()}
    check(all(v > 0 for v in launches.values()), f"every layout kernel launched: {launches}")
    for kernel in (chol_lane_blocked.NAME, chol_column.NAME, chol_blocked.NAME):
        ms = {k: sum(v) / len(v) for k, v in res["kernels"][kernel]["variants_ms"].items()}
        print(f"{kernel} beside {layouts.YARDSTICK[kernel]} at B={B_BENCH} n=93 (means in "
              "turns): " + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items()))
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

def launch_counts():
    """The three fit kernels' launch counts now."""
    from hybdrt_torch.ops import chol_lane as cl
    return {k: cl.LAUNCHES[k] for k in FIT_KERNELS}


def phase_single_fit():
    """Phase 11: ``DRT().fit_eis`` on the golden spectrum on the card in
    float64, against the golden values and the port's float64 fit on the
    CPU; its warm wall and launches; and the B = 1 float32
    ``BatchedEISFitter`` fit of the benchmark's single-fit leg. Returns
    (warm fit_eis wall, B = 1 f32 warm wall) in s."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl

    t_phase = time.time()
    freq, z, want = golden_fit()
    drt = hybdrt_torch.DRT()
    drt.fit_eis(freq, z, **GOLDEN_HYPERS)
    cl.reset_launch_counts()
    drt.fit_eis(freq, z, **GOLDEN_HYPERS)
    torch.cuda.synchronize()
    launches = launch_counts()
    fp, qp = drt.fit_parameters, drt.qphb_params
    n_par = len(fp["x"]) + 2
    print(f"single fit: DRT.fit_eis golden spectrum, f64 on the card, n = {n_par}: n_iter "
          f"{qp['n_iter']}, converged {qp['converged']}; launches per fit {launches}")
    check(all(launches[k] > 0 for k in FIT_KERNELS), f"DRT.fit_eis launched #1-#3: {launches}")
    errs = {"x (atol 5e-4)": float(np.max(np.abs(fp["x"] - want["x"]))),
            "R_inf (rtol 5e-3)": abs(fp["R_inf"] / want["R_inf"] - 1),
            "inductance (rtol 5e-3)": abs(fp["inductance"] / want["inductance"] - 1),
            "z_sigma_tot (rtol 2e-2)": float(np.max(np.abs(fp["z_sigma_tot"] - want["z_sigma_tot"])
                                                    / np.abs(want["z_sigma_tot"]))),
            "q_vector (rtol 3e-2)": float(np.max(np.abs(fp["q_vector"] - want["q_vector"])
                                                 / np.abs(want["q_vector"])))}
    print("  against the golden values: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    # tests/test_drt_fit_golden.py:187-194
    check(np.allclose(want["x"], fp["x"], rtol=0, atol=5e-4), "golden x")
    check(np.allclose(want["R_inf"], fp["R_inf"], rtol=5e-3), "golden R_inf")
    check(np.allclose(want["inductance"], fp["inductance"], rtol=5e-3), "golden inductance")
    check(np.allclose(want["z_sigma_tot"], fp["z_sigma_tot"], rtol=2e-2), "golden z_sigma_tot")
    check(np.allclose(want["q_vector"], fp["q_vector"], rtol=3e-2), "golden q_vector")

    cpu = hybdrt_torch.DRT(device="cpu").fit_eis(freq, z, **GOLDEN_HYPERS)
    dx = float(np.max(np.abs(fp["x"] - cpu.fit_parameters["x"]))
               / np.max(np.abs(cpu.fit_parameters["x"])))
    print(f"  card f64 vs CPU f64: n_iter {qp['n_iter']} / {cpu.qphb_params['n_iter']}, "
          f"converged {qp['converged']} / {cpu.qphb_params['converged']}, max |dx| / max |x| "
          f"{dx:.3g}, |dR_inf| {abs(fp['R_inf'] - cpu.fit_parameters['R_inf']):.3g}")
    check(qp["n_iter"] == cpu.qphb_params["n_iter"], "same n_iter on the card and the CPU")
    check(qp["converged"] == cpu.qphb_params["converged"], "same converged flag")
    check(dx < 1e-6, f"card x within 1e-6 of max |x| of the CPU's: {dx}")

    walls = [timed(lambda: drt.fit_eis(freq, z, **GOLDEN_HYPERS)) for _ in range(10)]
    print(f"  warm fit_eis wall: min {min(walls):.4f} s, median {np.median(walls):.4f} s "
          f"(10 calls, host clock)")

    # The benchmark's single-fit leg on the card: a B = 1 f32 batched fit
    # (bench.py:394-402, tpu_b1_warm_s)
    freq1, z1 = make_batch(1, N_FREQ, seed=9)
    b1 = hybdrt_torch.BatchedEISFitter(freq1, dtype=torch.float32, max_iter=MAX_ITER,
                                       qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True,
                                       pred_rtol=3e-2)
    cold = timed(lambda: b1.fit(z1))
    cl.reset_launch_counts()
    r1 = b1.fit(z1)
    torch.cuda.synchronize()
    b1_launches = launch_counts()
    b1_walls = [timed(lambda: b1.fit(z1)) for _ in range(10)]
    print(f"  B=1 f32 BatchedEISFitter.fit (bench single-fit settings): first call {cold:.3f} s, "
          f"warm min {min(b1_walls):.4f} s, median {np.median(b1_walls):.4f} s (10 calls); "
          f"n_iter {int(r1.n_iter[0])}, converged {bool(r1.converged[0])}; launches {b1_launches}")
    check(bool(np.all(np.isfinite(r1.x))), "B=1 f32 fit finite")
    print(f"single fit: phase {time.time() - t_phase:.1f} s")
    return min(walls), min(b1_walls)


class FirstKernelInputs:
    """Inside ``with``, records a copy of the inputs of the first call of
    each SPD routine of the QP (``hybdrt_torch.ops.qp``: spd_factor_solve
    #1, spd_solve_factored #2, spd_solve #3), which the first QP of a fit
    makes: its cold start (#3), its Mehrotra steps (#1, #2) and its polish."""

    NAMES = {"spd_factor_solve": "chol_factor_solve_lane",
             "spd_solve_factored": "chol_solve_factored_lane", "spd_solve": "chol_solve_lane"}

    def __init__(self):
        from hybdrt_torch.ops import qp
        self.qp, self.inputs, self.real = qp, {}, {}

    def __enter__(self):
        for fn, kernel in self.NAMES.items():
            real = self.real[fn] = getattr(self.qp, fn)

            def recorded(*args, _real=real, _kernel=kernel):
                if _kernel not in self.inputs:
                    self.inputs[_kernel] = [a.clone() for a in args]
                return _real(*args)

            setattr(self.qp, fn, recorded)
        return self

    def __exit__(self, *exc):
        for fn, real in self.real.items():
            setattr(self.qp, fn, real)


def phase_ragged():
    """Phase 12: the het leg's 768 EIS spectra (``make_het_eis``) on three
    grids through ``BatchedRaggedFitter`` in float32 on the card with the het
    leg's settings, ``fit(adaptive="staged")`` twice, the launch counters
    reset just before the second; its checks, the first 64 observations
    against a float64 fit on the card, and #1-#3 against their plain versions
    on the first QP's inputs. Returns (second-call wall, prepare wall, loop
    wall) in s."""
    import hybdrt_torch
    from hybdrt_torch.ops import basis, chol_lane as cl
    from hybdrt_torch.solver import fitcore

    t_phase = time.time()
    obs, tau = make_het_eis()
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4)
    fitter = hybdrt_torch.BatchedRaggedFitter(tau, dtype=torch.float32, **kw)
    with FirstKernelInputs() as first:
        t0 = time.time()
        fitter.fit(obs, adaptive="staged")
        torch.cuda.synchronize()
        first_s = time.time() - t0
    cl.reset_launch_counts()
    t0 = time.time()
    res = fitter.fit(obs, adaptive="staged")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    b = len(obs)
    n_max = res.x_raw.shape[1]
    grids = sorted({len(f) for _, (f, _) in obs})
    print(f"ragged: {b} EIS spectra on grids of {grids} frequencies, f32 staged, N_max {n_max}: "
          f"first call {first_s:.2f} s, second call {wall:.4f} s -> {b / wall:.1f} spectra/s; "
          f"converged {int(res.converged.sum())}/{b}; passes {int(res.n_iter.max())}; "
          f"n_iter mean {res.n_iter.mean():.2f}; launches {launches}")
    check(all(launches[k] > 0 for k in FIT_KERNELS), f"the ragged fit launched #1-#3: {launches}")
    check(bool(np.all(np.isfinite(res.x_raw))), "finite ragged coefficients")
    tails = [res.x[k][r - l:] for k, (l, r) in enumerate(res.tau_indices)]
    check(all(np.all(t == 0.0) for t in tails), "padded coefficient tails exactly zero")
    y = fitter.final_predictions(res)
    rel = []
    for k, (_, (f, zk)) in enumerate(obs):
        nf = len(f)
        z_hat = (y[k, :nf] + 1j * y[k, nf:2 * nf]) * res.scale[k]
        rel.append(np.median(np.abs(z_hat - zk) / np.abs(zk)))
    med_rel = float(np.median(rel))
    print(f"  median over observations of the median |z_hat - z|/|z|: {med_rel:.4g} "
          f"(max {max(rel):.4g})")
    check(med_rel < 0.02, f"ragged median relative residual {med_rel}")
    # The converged count is reported, not held: without pred_stop a lane
    # converges when every coefficient moves by under 1e-2 of itself, and the
    # JAX package's own float32 ragged fit of this map on a CPU converges few
    # of the 768 lanes within 50 iterations (PERF.md, Findings)

    # prepare and the loop (upload, weight initialization, passes) apart
    t_prep = timed(lambda: fitter.prepare(obs))
    batch = fitter._last_batch

    def loop():
        args, loop_kw = fitter._loop_args(fitter._device_arrays(batch))
        return fitcore.qphb_fit_loop(*args, **loop_kw)

    t_loop = timed(loop)
    print(f"  prepare {t_prep:.4f} s, loop (upload, weight init, passes) {t_loop:.4f} s")

    # f32 on the card vs f64 on the card, first 64 observations
    ref = hybdrt_torch.BatchedRaggedFitter(tau, dtype=torch.float64, **kw)
    r64 = ref.fit(obs[:64], adaptive="staged")
    area = basis.get_basis_func_area("gaussian", 1 / np.mean(np.diff(np.log(tau))))
    rp32 = np.sum(np.abs(res.x[:64]), axis=1) * area
    rp64 = np.sum(np.abs(r64.x), axis=1) * area
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)
    d_rinf = np.abs(res.r_inf[:64] - r64.r_inf)
    y32, y64 = y[:64], ref.final_predictions(r64)
    zrel = []
    for k in range(64):
        f, zk = obs[k][1]
        nf = len(f)
        dz = (y32[k, :nf] - y64[k, :nf]) * res.scale[k] \
            + 1j * (y32[k, nf:2 * nf] - y64[k, nf:2 * nf]) * res.scale[k]
        zrel.append(np.max(np.abs(dz)) / np.max(np.abs(zk)))
    same = res.n_iter[:64] == r64.n_iter
    print(f"  f32 vs f64 on the card, 64 observations: Rp rel err median {np.median(rel_rp):.3g} "
          f"p95 {np.percentile(rel_rp, 95):.3g} max {np.max(rel_rp):.3g}, max |dR_inf| "
          f"{np.max(d_rinf):.3g}; functional fit max {max(zrel):.3g}; {int(same.sum())} lanes "
          f"at the same n_iter")
    check(np.median(rel_rp) < 1e-3, "ragged Rp median rel err < 1e-3")
    check(np.percentile(rel_rp, 95) < 3e-3, "ragged Rp p95 rel err < 3e-3")
    check(max(zrel) < 1.5e-2, "ragged functional fit rel err < 1.5e-2")

    check(np.max(rel_rp) < 5e-3, "ragged Rp max rel err < 5e-3")
    check(np.max(d_rinf) < 5e-3, "ragged max |dR_inf| < 5e-3")

    # #1-#3 against their plain versions on the first QP's inputs. #1 and #2
    # are held at TOL on their first calls, the QP's first Mehrotra step,
    # and #3 on the system #1 solved there. #3's own calls in that QP, the
    # cold start and the polish of the weight initialization's overfit
    # ridge, are too ill-conditioned in float32 for any two solvers to agree
    # at TOL (the kernel and cuSOLVER differ by up to 5 % of a lane's max
    # there at backward errors of 1e-7, PERF.md, Findings): that call is held
    # to a backward error of 10 n eps, kernel and plain alike
    inp = first.inputs
    check(set(inp) == set(FIT_KERNELS), f"the first QP called #1-#3: {sorted(inp)}")
    h, rhs = inp["chol_factor_solve_lane"]
    cases = {"chol_factor_solve_lane": (cl.chol_factor_solve_lane(h, rhs),
                                        cl.chol_factor_solve_lane_plain(h, rhs)),
             "chol_solve_factored_lane": (cl.chol_solve_factored_lane(*inp[
                 "chol_solve_factored_lane"]), cl.chol_solve_factored_lane_plain(
                 *inp["chol_solve_factored_lane"])),
             "chol_solve_lane": (cl.chol_solve_lane(h, rhs), cl.chol_solve_lane_plain(h, rhs))}
    errs = {}
    for name, (got, want) in cases.items():
        if name == "chol_factor_solve_lane":
            got, want = (got[0], torch.tril(got[1])), want
        else:
            got, want = (got,), (want,)
        err = 0.0
        for g, w in zip(got, want):
            d = (g - w).abs()
            check(bool(torch.all(d <= TOL + TOL * w.abs())),
                  f"{name} vs plain on the first ragged QP: err {float(d.max())}")
            err = max(err, float(d.max()))
        errs[name] = err
    print(f"  kernels vs plain on the first ragged QP's first Mehrotra step "
          f"{tuple(h.shape)}: " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
    a, b0 = inp["chol_solve_lane"]
    x3, x3_p = cl.chol_solve_lane(a, b0), cl.chol_solve_lane_plain(a, b0)

    def backward(x):
        r = torch.linalg.norm(a @ x[..., None] - b0[..., None], dim=(1, 2))
        return float(torch.max(r / (torch.linalg.norm(a, dim=(1, 2)) * torch.linalg.norm(x, dim=1)
                                    + torch.linalg.norm(b0, dim=1))))

    bound_back = 10 * a.shape[-1] * torch.finfo(a.dtype).eps
    back, back_p = backward(x3), backward(x3_p)
    fwd = float(torch.max((x3 - x3_p).abs().amax(1) / x3_p.abs().amax(1)))
    print(f"  chol_solve_lane on the first QP's cold start: backward error {back:.3g} (plain "
          f"{back_p:.3g}, bound {bound_back:.3g}); max |x - x_plain| / max |x_plain| per lane "
          f"{fwd:.3g}")
    check(back < bound_back and back_p < bound_back,
          f"cold-start backward errors {back}, {back_p} within {bound_back}")
    print(f"ragged: phase {time.time() - t_phase:.1f} s")
    return wall, t_prep, t_loop


# The hybrid phase (13): the uniform fitter's batch, and the het leg's knobs
# (bench.py:183-190) for it and the ragged fit
HYBRID_B = 1024
HET_KW = dict(qp_max_iter=20, qp_max_iter_warm=4)


def hybrid_bounds(label, rp32, rp64, d_rinf, zrel, both):
    """Phase 5's bounds on Rp median and p95 and the functional fit, held on
    the lanes that converged in both precisions (at least half of them);
    the same over every lane, Rp max and max |dR_inf| reported. A lane that
    runs to max_iter without converging ends on a limit cycle that float32
    rounding moves: the JAX package's own float32 fit of the last 16 lanes
    of make_hybrid_batch(64) on a CPU spreads its Rp p95 to 3.4e-2 against
    its float64 fit there
    (tests/test_torch_hybrid_batch.py::test_float32_spread_is_the_references)."""
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)

    def stats(m):
        return (f"Rp rel err median {np.median(rel_rp[m]):.3g} p95 "
                f"{np.percentile(rel_rp[m], 95):.3g} max {np.max(rel_rp[m]):.3g}, max |dR_inf| "
                f"{np.max(d_rinf[m]):.3g}, functional fit max {np.max(zrel[m]):.3g}")

    every = np.ones(len(rp64), dtype=bool)
    print(f"  {label} f32 vs f64 on the card, {len(rp64)} observations: {stats(every)}; on the "
          f"{int(both.sum())} converged in both: {stats(both)}")
    check(both.sum() >= len(both) // 2, f"{label}: at least half the lanes converged in both")
    check(np.median(rel_rp[both]) < 1e-3, f"{label} Rp median rel err < 1e-3")
    check(np.percentile(rel_rp[both], 95) < 3e-3, f"{label} Rp p95 rel err < 3e-3")
    check(np.max(zrel[both]) < 1.5e-2, f"{label} functional fit rel err < 1.5e-2")


def hold_first_qp(label, first):
    """#1 and #2 against their plain versions at TOL on their first calls in
    a fit (its first QP's first Mehrotra step), #3 on the system #1 solved
    there, and #3's own first call (the weight initialization's cold start)
    by backward error, as phase 12 holds them. Returns {kernel: max abs
    err}."""
    from hybdrt_torch.ops import chol_lane as cl

    inp = first.inputs
    check(set(inp) == set(FIT_KERNELS), f"{label}: the first QP called #1-#3: {sorted(inp)}")
    h, rhs = inp["chol_factor_solve_lane"]
    fs = inp["chol_solve_factored_lane"]
    cases = {"chol_factor_solve_lane": (cl.chol_factor_solve_lane(h, rhs),
                                        cl.chol_factor_solve_lane_plain(h, rhs)),
             "chol_solve_factored_lane": ((cl.chol_solve_factored_lane(*fs),),
                                          (cl.chol_solve_factored_lane_plain(*fs),)),
             "chol_solve_lane": ((cl.chol_solve_lane(h, rhs),),
                                 (cl.chol_solve_lane_plain(h, rhs),))}
    errs = {}
    for name, (got, want) in cases.items():
        if name == "chol_factor_solve_lane":
            got = (got[0], torch.tril(got[1]))
        err = 0.0
        for g, w in zip(got, want):
            d = (g - w).abs()
            check(bool(torch.all(d <= TOL + TOL * w.abs())),
                  f"{name} vs plain on the first {label} QP: err {float(d.max())}")
            err = max(err, float(d.max()))
        errs[name] = err
    print(f"  kernels vs plain on the first {label} QP's first Mehrotra step {tuple(h.shape)}: "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
    a, b0 = inp["chol_solve_lane"]
    x3, x3_p = cl.chol_solve_lane(a, b0), cl.chol_solve_lane_plain(a, b0)

    def backward(x):
        r = torch.linalg.norm(a @ x[..., None] - b0[..., None], dim=(1, 2))
        return float(torch.max(r / (torch.linalg.norm(a, dim=(1, 2)) * torch.linalg.norm(x, dim=1)
                                    + torch.linalg.norm(b0, dim=1))))

    bound_back = 10 * a.shape[-1] * torch.finfo(a.dtype).eps
    back, back_p = backward(x3), backward(x3_p)
    print(f"  chol_solve_lane on the {label} weight initialization's cold start "
          f"{tuple(a.shape)}: backward error {back:.3g} (plain {back_p:.3g}, bound "
          f"{bound_back:.3g})")
    check(back < bound_back and back_p < bound_back,
          f"{label} cold-start backward errors {back}, {back_p} within {bound_back}")
    return errs


def residuals(obs, res, y, rzv):
    """Per observation, the median relative residual of a ragged hybrid fit
    on its chrono rows (|y - rzv| over its max |rzv|, scaled units) and on
    its EIS rows (|z_hat - z| / |z|)."""
    c_rel, e_rel = [], []
    for k, (_, (f, zk)) in enumerate(obs):
        nc, nf = int(res.num_chrono[k]), len(f)
        c_rel.append(np.median(np.abs(y[k, :nc] - rzv[k, :nc])) / np.max(np.abs(rzv[k, :nc])))
        z_hat = (y[k, nc:nc + nf] + 1j * y[k, nc + nf:nc + 2 * nf]) * res.scale[k]
        e_rel.append(np.median(np.abs(z_hat - zk) / np.abs(zk)))
    return c_rel, e_rel


class FirstFusedInputs:
    """Inside ``with``, records a copy of the inputs of the first call of
    ``ip_steps_lane`` by the QP (``hybdrt_torch.ops.qp``): a fused fit's
    first warm QP."""

    def __init__(self):
        from hybdrt_torch.ops import qp
        self.qp, self.inputs = qp, None

    def __enter__(self):
        self.real = real = self.qp.ip_steps_lane

        def recorded(*args):
            if self.inputs is None:
                self.inputs = [a.clone() if torch.is_tensor(a) else a for a in args]
            return real(*args)

        self.qp.ip_steps_lane = recorded
        return self

    def __exit__(self, *exc):
        self.qp.ip_steps_lane = self.real


def phase_hybrid():
    """Phase 13: hybrid fits. (a) ``DRT().fit_hybrid`` with each weight
    factor method and one ``fit_chrono`` on the seeded data of
    tests/test_chrono_hybrid.py in float64 on the card, against the port's
    CPU fits and the test's recovery bounds; (b) ``BatchedHybridFitter`` on
    ``make_hybrid_batch(1024)``, f32, plain and fused, twice each, the second
    call timed with the launch counters reset, 64 lanes against f64 on the
    card; (c) the het leg's 256 hybrid observations on two protocols
    (``make_het_hybrid``) through ``BatchedRaggedFitter``, f32 staged, twice;
    (d) #1-#3 against their plain versions on the ragged fit's first QP and
    #5 on the fused fitter's first warm QP. Returns ({label: wall},
    {kernel: max abs err}, {kernel: launches of the phase's timed fits})."""
    import hybdrt_torch
    from hybdrt_torch.ops import basis, chol_lane as cl, ip_lane
    from hybdrt_torch.solver import fitcore

    t_phase = time.time()
    walls, errs = {}, {}
    total = dict.fromkeys([*FIT_KERNELS, "ip_steps_lane"], 0)

    def count(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    # (a) single fits, f64, the card against the CPU
    times, i_sig, v, freq, z = hybrid_data(seed=0)
    fits = [("fit_chrono", {}), ("fit_hybrid", {}),
            ("fit_hybrid", dict(hybrid_weight_factor_method="weight")),
            ("fit_hybrid", dict(hybrid_weight_factor_method="rp"))]
    for method, kw in fits:
        data = (times, i_sig, v) if method == "fit_chrono" else (times, i_sig, v, freq, z)
        drt = hybdrt_torch.DRT(warn=False)
        cl.reset_launch_counts()
        getattr(drt, method)(*data, **kw)
        torch.cuda.synchronize()
        launches = launch_counts()
        cpu = getattr(hybdrt_torch.DRT(warn=False, device="cpu"), method)(*data, **kw)
        fp, qp = drt.fit_parameters, drt.qphb_params
        dx = float(np.max(np.abs(qp["x_raw"] - cpu.qphb_params["x_raw"]))
                   / np.max(np.abs(cpu.qphb_params["x_raw"])))
        label = f"{method}({', '.join(f'{k}={v!r}' for k, v in kw.items())})"
        rp = drt.predict_r_p()
        print(f"hybrid: {label}, f64 on the card, n = {len(qp['x_raw'])}: n_iter {qp['n_iter']} "
              f"(CPU {cpu.qphb_params['n_iter']}), max |dx| / max |x| {dx:.3g}; R_inf "
              f"{fp['R_inf']:.5f}, Rp {rp:.5f}, v_baseline {fp['v_baseline'][0]:.5f}"
              + (f", inductance {fp['inductance']:.4g}, vz_offset {fp['vz_offset']:.3g}"
                 if method == "fit_hybrid" else "") + f"; launches {launches}")
        count(launches)
        check(all(launches[k] > 0 for k in FIT_KERNELS), f"{label} launched #1-#3: {launches}")
        check(qp["n_iter"] == cpu.qphb_params["n_iter"], f"{label}: same n_iter as the CPU")
        check(dx < 1e-6, f"{label}: card x within 1e-6 of max |x| of the CPU's: {dx}")
        # tests/test_chrono_hybrid.py:34-78
        check(abs(fp["R_inf"] - 0.3) < 0.02, f"{label} R_inf")
        check(abs(rp - 1.8) < (0.1 if kw else 0.05), f"{label} Rp")
        if method == "fit_chrono":
            check(abs(fp["v_baseline"][0] - 0.05) < 1e-3, f"{label} v_baseline")
            check(np.median(np.abs(drt.predict_response(times) - v)) < 1e-3,
                  f"{label} response residual")
        elif not kw:
            check(abs(fp["inductance"] - 1e-7) < 2e-8, f"{label} inductance")
            check(abs(fp["vz_offset"]) < 0.05, f"{label} vz_offset")

    # (b) the uniform fitter, plain and fused
    t_, i_, f_, vb, zb = make_hybrid_batch(HYBRID_B, proto=0)
    for fused in (False, True):
        name = "fused" if fused else "plain"
        fitter = hybdrt_torch.BatchedHybridFitter(t_, i_, f_, dtype=torch.float32,
                                                  qp_fused=fused, **HET_KW)
        area = basis.get_basis_func_area("gaussian", fitter.tau_epsilon)
        with FirstFusedInputs() as first_fused:
            fitter.fit(vb, zb, adaptive="staged", collect="lazy")
        cl.reset_launch_counts()
        ip_lane.reset_launch_counts()
        t0 = time.time()
        res = fitter.fit(vb, zb, adaptive="staged", collect="lazy")
        torch.cuda.synchronize()
        wall = walls[f"uniform {name}"] = time.time() - t0
        launches = {**cl.LAUNCHES, **ip_lane.LAUNCHES}
        count(launches)
        passes = int(res.n_iter.max())
        print(f"hybrid: BatchedHybridFitter {name}, B={HYBRID_B} on het protocol 0 "
              f"({len(t_)} samples, {len(f_)} frequencies, n = {res.x_raw.shape[1]}), f32 "
              f"staged: second call {wall:.4f} s -> {HYBRID_B / wall:.1f} obs/s; passes {passes}, "
              f"n_iter mean {res.n_iter.mean():.2f}, converged {int(res.converged.sum())}; "
              f"launches {launches}")
        check(all(launches[k] > 0 for k in FIT_KERNELS), f"uniform {name}: #1-#3 launched")
        if fused:
            check(0 < launches["ip_steps_lane"] <= passes,
                  f"uniform fused: ip_steps_lane launched {launches['ip_steps_lane']} times in "
                  f"{passes} passes")
        else:
            check(launches["ip_steps_lane"] == 0, "the plain hybrid fit does not fuse")
        check(bool(np.all(np.isfinite(res.x_raw))), f"uniform {name}: finite coefficients")
        ref = hybdrt_torch.BatchedHybridFitter(t_, i_, f_, dtype=torch.float64, qp_fused=fused,
                                               **HET_KW)
        r64 = ref.fit(vb[:64], zb[:64], adaptive="staged")
        rzv = fitter.scale_batch(vb[:64], zb[:64])[0]
        y32 = np.einsum("bmn,bn->bm", fitter.final_design_matrices(res)[:64], res.x_raw[:64])
        y64 = np.einsum("bmn,bn->bm", ref.final_design_matrices(r64), r64.x_raw)
        zrel = np.max(np.abs(y32 - y64), axis=1) / np.max(np.abs(rzv), axis=1)
        hybrid_bounds(f"uniform {name}", np.sum(np.abs(res.x[:64]), axis=1) * area,
                      np.sum(np.abs(r64.x), axis=1) * area, np.abs(res.r_inf[:64] - r64.r_inf),
                      zrel, res.converged[:64] & r64.converged)
        if fused:
            # #5 against its plain version on the fit's first warm QP. TOL
            # is 6x the float32-vs-float64 spread of the plain steps on
            # phase 4's equilibrated QPs; a fit's QP is far worse
            # conditioned, so the tolerance is taken the same way from the
            # plain steps' spread on this QP (at least TOL)
            inp = first_fused.inputs
            check(inp is not None, "the fused fitter called ip_steps_lane")
            args, n_steps = inp[:6], inp[6]
            p32 = ip_lane.ip_steps_lane_plain(*args, n_steps)
            p64 = ip_lane.ip_steps_lane_plain(*(a.double() for a in args), n_steps)
            spread = max(float(((a - b.float()).abs() / (1 + b.float().abs())).max())
                         for a, b in zip(p32, p64))
            tol = max(TOL, 6 * spread)
            print(f"  the plain steps' f32-vs-f64 spread on the fused fitter's first warm QP "
                  f"{tuple(args[0].shape)}: {spread:.3g}; tolerance {tol:.3g}")
            e = check_steps("ip_steps_lane", ip_lane.ip_steps_lane, ip_lane.ip_steps_lane_plain,
                            args, n_steps, tol,
                            label=" (the fused hybrid fitter's first warm QP)")
            errs["ip_steps_lane"] = max(e)

    # (c) the het leg's hybrid half, ragged
    obs, tau = make_het_hybrid()
    fitter = hybdrt_torch.BatchedRaggedFitter(tau, dtype=torch.float32, **HET_KW)
    with FirstKernelInputs() as first:
        t0 = time.time()
        fitter.fit(obs, adaptive="staged")
        torch.cuda.synchronize()
        first_s = time.time() - t0
    cl.reset_launch_counts()
    t0 = time.time()
    res = fitter.fit(obs, adaptive="staged")
    torch.cuda.synchronize()
    wall = walls["ragged"] = time.time() - t0
    launches = launch_counts()
    count(launches)
    b = len(obs)
    print(f"hybrid: ragged, the het leg's {b} hybrid observations on 2 protocols, f32 staged, "
          f"R_max {res.weights.shape[1]}, N_max {res.x_raw.shape[1]}: first call {first_s:.2f} s, "
          f"second call {wall:.4f} s -> {b / wall:.1f} obs/s; passes {int(res.n_iter.max())}, "
          f"n_iter mean {res.n_iter.mean():.2f}, converged {int(res.converged.sum())}/{b}; "
          f"launches {launches}")
    check(all(launches[k] > 0 for k in FIT_KERNELS), f"the hybrid ragged fit launched #1-#3")
    check(bool(np.all(np.isfinite(res.x_raw))), "finite hybrid ragged coefficients")
    tails = [res.x[k][r - l:] for k, (l, r) in enumerate(res.tau_indices)]
    check(all(np.all(t_k == 0.0) for t_k in tails), "hybrid padded coefficient tails exactly 0")
    y = fitter.final_predictions(res)
    rzv = fitter._last_batch["rzv"]
    c_rel, e_rel = residuals(obs, res, y, rzv)
    print(f"  median relative residual: chrono rows {np.median(c_rel):.4g} (max {max(c_rel):.4g}),"
          f" EIS rows {np.median(e_rel):.4g} (max {max(e_rel):.4g})")
    t_prep = walls["ragged prepare"] = timed(lambda: fitter.prepare(obs))
    batch = fitter._last_batch

    def loop():
        args, loop_kw = fitter._loop_args(fitter._device_arrays(batch))
        return fitcore.qphb_fit_loop(*args, **loop_kw)

    t_loop = walls["ragged loop"] = timed(loop)
    print(f"  prepare {t_prep:.4f} s, loop (upload, weight init, passes) {t_loop:.4f} s")
    area = basis.get_basis_func_area("gaussian", 1 / np.mean(np.diff(np.log(tau))))
    ref = hybdrt_torch.BatchedRaggedFitter(tau, dtype=torch.float64, **HET_KW)
    r64 = ref.fit(obs[:64], adaptive="staged")
    y64 = ref.final_predictions(r64)
    r_max = min(y64.shape[1], y.shape[1])
    zrel = np.max(np.abs(y[:64, :r_max] - y64[:, :r_max]), axis=1) \
        / np.max(np.abs(rzv[:64]), axis=1)
    hybrid_bounds("ragged", np.sum(np.abs(res.x[:64]), axis=1) * area,
                  np.sum(np.abs(r64.x), axis=1) * area, np.abs(res.r_inf[:64] - r64.r_inf), zrel,
                  res.converged[:64] & r64.converged)
    # The residuals are held to the float64 fit's on the same observations:
    # the model cannot reach the noise on these data, in the JAX package
    # either, whose float64 fits leave median EIS residuals of 0.084 and
    # 0.036 on the map's first two (the ideal step is placed one sample
    # interval before the first sample after it, 8.8e-5 s or more after the
    # true step; see
    # tests/test_torch_ragged_hybrid.py::test_het_hybrid_residuals_are_the_references)
    c64, e64 = residuals(obs[:64], r64, y64, ref._last_batch["rzv"])
    for rows, r32_, r64_ in (("chrono", c_rel[:64], c64), ("EIS", e_rel[:64], e64)):
        m32, m64 = float(np.median(r32_)), float(np.median(r64_))
        print(f"  {rows} rows, 64 observations: median relative residual f32 {m32:.4g}, "
              f"f64 {m64:.4g}")
        check(m32 <= 1.1 * m64 + 1e-3, f"hybrid ragged {rows} residual {m32} against f64 {m64}")

    # (d) #1-#3 at the ragged hybrid shapes
    errs.update(hold_first_qp("hybrid ragged", first))
    print(f"hybrid: phase {time.time() - t_phase:.1f} s; launches of the timed fits {total}")
    return walls, errs, total


def main():
    phase_card()
    phase_build()
    max_err, times = compare_kernels()
    max_err["ip_steps_lane"], times["ip_steps_lane"] = compare_ip_kernel()
    launches, wall = phase_slice(fused=False)
    fused_launches, fused_wall = phase_slice(fused=True)
    launches["ip_steps_lane"] = fused_launches["ip_steps_lane"]
    frame_walls = {"plain": phase_frames(fused=False), "fused": phase_frames(fused=True)}
    stream_walls = {"plain": phase_stream(fused=False), "fused": phase_stream(fused=True)}
    cov_walls, _ = phase_cov()
    history_wall, history_plain_wall, _ = phase_history()
    max_err["chol_factor_lane"], times["chol_factor_lane"] = compare_factor_kernel()
    launches["chol_factor_lane"] = phase_resolve()
    layout_err, layout_launches, layout_times = phase_layouts()
    max_err.update(layout_err)
    launches.update(layout_launches)
    times.update(layout_times)
    max_err["ip_steps_loop"], launches["ip_steps_loop"], times["ip_steps_loop"] = phase_ip_loop()
    single_walls = phase_single_fit()
    ragged_walls = phase_ragged()
    hybrid_walls, hybrid_err, hybrid_launches = phase_hybrid()
    for k, e in hybrid_err.items():
        max_err[k] = max(max_err[k], e)
    for k, n in hybrid_launches.items():
        launches[k] += n
    print(f"second-call wall, B={B_BENCH}: plain {wall:.4f} s ({B_BENCH / wall:.1f} spectra/s), "
          f"fused {fused_wall:.4f} s ({B_BENCH / fused_wall:.1f} spectra/s)")
    for name, w in frame_walls.items():
        print(f"frames, {name}: warm frames 1-{N_FRAMES - 1} "
              f"{[round(v, 4) for v in w['warm']]} s, cold frame {N_FRAMES - 1} {w['cold']:.4f} s")
    for name, (seq, wall) in stream_walls.items():
        print(f"stream, {name}: fit_stream {wall:.4f} s against {sum(seq):.4f} s of sequential "
              f"fits")
    print(f"param_cov, B={B_BENCH}: refine_iters 0 {cov_walls[0]:.4f} s, 3 {cov_walls[3]:.4f} s; "
          f"history fit {history_wall:.4f} s against the plain fit's {history_plain_wall:.4f} s")
    print(f"single fit: DRT.fit_eis f64 warm {single_walls[0]:.4f} s, B=1 f32 batched fit "
          f"{single_walls[1]:.4f} s; ragged 768 f32: {ragged_walls[0]:.4f} s (prepare "
          f"{ragged_walls[1]:.4f} s, loop {ragged_walls[2]:.4f} s)")
    print("hybrid: " + ", ".join(f"{k} {w:.4f} s" for k, w in hybrid_walls.items()))
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
