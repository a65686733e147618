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
    a backward error of 10 n eps, kernel and plain alike; and every one of
    these solves, kernel and plain, against the float64 solution of the
    same system (forward and backward error printed, the backward error
    held to 10 n eps; ``against_f64``);
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
    on that QP (at least TOL; TOL is that multiple on phase 4's QPs), and
    its distance from the float64 steps printed beside the plain steps';
14. the het leg's map through ``DRTMD`` (``utils/probe.py::make_het_map(768,
    256)``, group "g"): ``fit_all(batched=True, dtype=float32)`` once and
    then three timed refits, the launch counters reset before each: every
    observation fitted, finite, rss >= 0, llh finite, and the EIS and hybrid
    observations' coefficients, specials and stored state bit for bit
    phases 12 and 13's ragged fits; ``get_fits_batched`` of all 1024 timed,
    and the first 64 (P, q) within 1e-9 of a float64 rebuild on the CPU
    (``load_fit_state``); ``resolve_group("g", psi_sort_dims=["i"])``
    windowed in float64 and coupled in float32 and float64, each called
    twice with the counters reset before the second: no warning, #4 and #2
    launched, the coupled KKT residuals within the JAX package's tolerance,
    the coupled float64 objective no higher than the windowed float64 one's
    and the float32 one no higher than that plus float32's resolution
    (eps32 |f|), the float32 coupled x within ``HET_F32_BOUND`` of the
    float64 one, and the windowed float64 solve of
    the 13 windows holding the first 64 observations at the CPU's IP
    iterations, x within 1e-8; rebuild, host assembly and solve walls, and
    one profiled call of the fit and of each resolve (busy share);
15. the het leg's post-fit map pipeline (``bench.py:349-379``) on phase 14's
    fitted map: ``utils/probe.py::run_postproc_pipeline`` on its ``obs_x``
    (1024 observations x 111 tau, psi "i"): ``assemble_ndx``, ``filter_ndx``,
    ``flag_bad_obs``, ``coef_to_ridges`` and ``optimize_extrema``, host numpy
    code, a first call and three more, each stage's host wall, ``bad_obs``
    and ``postproc_over_fit`` (the total over phase 14's ``fit_all`` refit
    wall); x_nd (1024, 111) and finite, the filtered map finite, bad_obs in
    [0, 1024], the masks boolean of x_nd's shape, no row with two troughs
    between adjacent ridges after ``optimize_extrema``, every call's outputs
    the first call's, and the shares of EIS and hybrid rows with a ridge
    within two supergrid points of each true relaxation (tau_2 = 1e-4 s,
    tau_1 = 10^(-2.8 + 1.2 p), ``bench.py:202-206``) at or above
    ``HET_TRUTH_FLOOR``; a digest of the bad observations and both masks;
16. the reference's defaults: (a) ``DRT().fit_eis`` of the quick start's
    spectrum (``probe.quickstart_eis``) in float64, warm, #1-#3 launched and
    every QP through the lane kernels, then ``predict_drt_ci``,
    ``find_peaks`` (both methods), ``quantify_peaks``,
    ``estimate_peak_distributions``, ``split_r_p``, ``integrate_drt``,
    ``predict_peak_prob``, ``fisher_matrix``, ``evaluate_rss/llh/bic/lml``,
    ``predict_sigma`` and ``evaluate_chi_sq`` against the same fit on the
    CPU: peak indices equal, the covariance, variances, CI band and peak
    probability within their conditioning bounds, rss, llh and bic within
    1e-9 on one fit state and lml within its log-det bound, and the quick
    start's truth (peaks within 0.1 decade, Rp within ``QS_R_MARGIN``);
    (b) ``make_het_map(48, 16)`` fitted by ``fit_all()`` (serial, float64),
    once: the wall, median wall per EIS and hybrid fit, launches and QP
    routes per fit; every observation fitted and finite, obs_drt_var
    finite and >= 0, every fit's QPs through #1-#3, and the share of
    observations that ``fit_all(batched=True, dtype=float64)`` fits to the
    same iterations and x within 1e-6 at or above the CPU's
    (``SERIAL_SHARE_FLOOR``); (c) ``estimate_obs_drt_var`` of phase 14's
    map, its wall, the first 64 within their readout bounds of the CPU's
    per-observation path; (d) ``resolve_group("g", psi_sort_dims=["i"])``
    with its defaults (dense windows of n = 658, float64) on (b)'s map: wall,
    IP iterations, every window through the library route and no lane
    kernel; x within ``DENSE_X_BOUND`` and the objective within
    ``DENSE_OBJ_RTOL`` of ``batched=True``'s, the first 13 windows at the
    CPU's iterations and x within 1e-8; then the same on phase 14's 1024
    observations (its first 256 where 13 windows' wall scaled to 205 passes
    ``DENSE_BIG_S``); (e) ``predict_drt_var``, ``predict_x_var``,
    ``predict_curv_prob`` and ``predict_peak_prob`` of (b)'s map: finite,
    probabilities in [0, 1], 8 observations within their bounds of the CPU's;
17. the rest of the fit surface: (a) phase 14's map refitted with
    ``qp_fused=True`` in its ``batch_fit_kw`` (``fit_all(batched=True,
    dtype=float32)``): both ragged fits launch ``ip_steps_lane`` (counted
    per fit), which is held on each fit's first warm QP within 6x the plain
    steps' spread against float64 (Queue 3 item 12's bound), the spread
    taken over P and P moved one ulp (``one_ulp``), in float32 and, on the
    same inputs, in float64 (``hold_fused_steps``); each half against phase 14's plain map by phase
    13's float32 bounds on the lanes converged in both where they are at
    least half, else (the EIS half, which converges almost no lane) on the
    lanes that stop at the same iteration in both (``fused_bounds``);
    the second call's wall and launches; (b) ``return_history=True`` on the
    ragged fit of the het leg's 768 EIS spectra and on
    ``BatchedHybridFitter`` at ``make_hybrid_batch(1024)`` (float32): each
    result bit for bit the fit without history, the history's last entry the
    final state; (c) on the quick start's spectrum in float64, ``series_neg``
    and ``weight_factor=2`` fits, ``generate_map_samples()`` (its pinned QPs
    one batch through #1-#3; launches and QP routes printed),
    ``get_parameter_quantile`` and ``estimate_posterior_mean``, each against
    the same call on the card with the plain lane versions (``PlainLanes``)
    and against the CPU, the samples on the CPU fit's state with its Laplace
    sigma (``REST_X_TOL``, ``REST_LP_RTOL``), and a serial map with the
    "detail" attributes saved and read back; (d) on het protocol 0's record
    in float64, ``fit_chrono`` with ``expdecay`` steps, with ``downsample``
    and with the static, dynamic and scaled GP backgrounds, each against the
    CPU (the same n_iter, x within ``REST_X_TOL``), ``chrono_mode="pot"``
    refused as in the JAX package, and the ragged fitter's ``downsample``
    fast path over the het leg's 256 hybrid observations (its first
    ``REST_CPU_OBS`` against the CPU);
18. the distribution of phasances (DOP): (a) ``BatchedEISFitter(fit_dop=True)``
    on ``make_dop_batch(8192, 71)`` (n = 143) in float32 with the bench's
    knobs, plain and fused, ``fit(adaptive="staged", collect="lazy")`` twice,
    the counters reset before the second call: every kernel of the path
    launched, x and x_dop finite, median relative residual < 0.02, the plain
    fit's converged share at least ``DOP_CONVERGED_FLOOR``, and the first 64
    spectra against the CPU's float64 fit within ``DOP_SPREAD_FACTOR`` times
    the JAX package's own float32 spread on them (``DOP_F32_SPREAD``, from
    ``tests/f32_spread.py dop``); (b) #1-#3 on the plain fit's first QP at
    (8192, 143) in float32 and on a float64 fit's at (1024, 143), held as
    phase 12 holds them (``hold_first_qp``), #4 on the first Mehrotra step's
    systems in both precisions, #5 on the fused fit's first warm QP
    (``hold_fused_steps``), and the five kernels, their plain versions and
    library calls timed at (8192, 143); (c) ``DRT.fit_eis`` with the DOP on
    tests/test_parallel.py:292's and tests/test_edge_cases.py:118's spectra,
    with the capacitance on a capacitive one and ``fit_hybrid`` with the
    DOP, float64 on the card against the CPU (the same n_iter, x, x_dop and
    C_inv within ``DOP_X_TOL`` of max |x|; ``predict_dop`` and
    ``predict_dop_ci``); (d) ``make_het_map(768, 256, fit_dop=True)``
    through ``DRTMD``: ``fit_all(batched=True, float32)`` twice (both halves
    through the ragged fitter), phase 14's guards, the first
    ``DOP_CPU_OBS`` rebuilt (P, q) against the CPU's, the coupled f32
    resolve of the whole map and the windowed f64 resolve of its first
    ``DOP_WINDOWED_OBS`` observations once each (KKT, no warning, #4 and #2
    launched, finite x and x_dop; ``DOP_CPU_WINDOWS`` windows solved again
    on the CPU, the same IP iterations and x within ``DOP_SPREAD_FACTOR``
    times their spread on the card under a one-ulp move of P) and
    ``predict_dop`` finite;
19. the other tau bases and ragged fits above the lane kernels' tile rule:
    (a) ``DRT`` single fits in float64 on the card (B = 1, #1-#3) on
    ``basis_probe``'s spectrum and record: ``fit_eis`` with the delta basis,
    Cole-Cole at epsilon 0.95 and at its default, and the gaussian with
    ``interpolate_integrals=False``; ``fit_chrono`` with Cole-Cole at 0.95
    and delta; ``fit_hybrid`` with delta; each against the port's CPU fit
    (the same n_iter, x within ``BASIS_X_TOL`` of max |x|); (b) the main
    leg's ``make_batch(8192, 71)`` as delta-basis EIS systems on its basis
    (n = 93) through ``BatchedRaggedFitter.from_systems`` in float32 with the
    benchmark's knobs, plain and fused, timed in turns; #1-#3 and #5 against
    their plain versions on the first QP's systems; the first 64 lanes
    against a float64 fit on the card (the Rp max and R_inf on the lanes
    that stop at the same iteration), each path within the larger of phase
    5's bound and 3x the JAX package's own float32 spread of the same path
    on these systems (``DELTA_F32_SPREAD``, from ``tests/f32_spread.py
    delta``; the JAX package's Rp max and R_inf exceed phase 5's 5e-3 on
    both paths); (c) the het leg's 768 EIS spectra on 40 points a decade
    (padded n above 268) in float32, plain and fused: every QP on the
    library route, the fused warm QPs on the plain steps (``fused_plain``),
    no lane-kernel launch, the first ``WIDE_CPU_LANES`` lanes against the
    CPU's float64 fit within phase 5's bounds (the CPU's fits run after the
    card's, before 19a, with nothing timed beside them).

The line before the last is a JSON object with one entry per kernel (its
launches from the path it serves: phase 5 and phase 13's timed fits for the
three fit Cholesky kernels, phase 6 and phase 13's fused fit for
``ip_steps_lane``, phase 8's two timed resolves for
``chol_factor_lane``, phase 14's timed fit and resolves for #1-#4, phase 16's
quick-start fit and serial ``fit_all`` for #1-#3, phase 17's fused map's
second call for #1-#3 and #5, and its single, sample and ragged fits for
#1-#3, phase 18's timed DOP fits, single fits and DOP map for #1-#5, phase
19's single fits for #1-#3 and its timed delta-basis batches for #1-#3 and
#5, phase
9's study for the four layout kernels, phase 10's study for
``ip_steps_loop``; the max_abs_err of #1-#4 takes in phase 18b's first DOP
QPs, and of #1-#3 phase 19b's first delta-basis QP, too);
the last line is ``{"ok": true,
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

    # #1-#3 against their plain versions on the first QP's inputs, and each
    # against the float64 solution of the same systems (hold_first_qp)
    errs = hold_first_qp("ragged", first)
    print(f"ragged: phase {time.time() - t_phase:.1f} s")
    return (wall, t_prep, t_loop), errs, res


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
    # ROADMAP Queue 3 item 12: each f32 solution, kernel and plain, held by
    # its backward error against the same bound as the cold start's
    for name, (fk, fp, bk, bp) in against_f64(label, inp).items():
        check(bk < bound_back and bp < bound_back,
              f"{label} {name}: backward errors {bk}, {bp} within {bound_back}")
    return errs


def f64_errors(a, b, x):
    """(forward, backward) error of f32 solutions x (B, n) of A x = b against
    the float64 solution of the same systems, the worst lane: max |x - x64|
    / max |x64|, and |A x - b| / (|A| |x| + |b|) in float64 (Frobenius and
    2-norms). ``a`` is read on its lower triangle, as the kernels read it."""
    f64 = torch.float64
    low = torch.tril(a.to(f64))
    a64 = low + torch.tril(low, -1).mT
    b64, x = b.to(f64), x.to(f64)
    x64 = torch.cholesky_solve(b64[..., None], torch.linalg.cholesky(a64))[..., 0]
    fwd = (x - x64).abs().amax(1) / x64.abs().amax(1)
    back = torch.linalg.norm(a64 @ x[..., None] - b64[..., None], dim=(1, 2)) / (
        torch.linalg.norm(a64, dim=(1, 2)) * torch.linalg.norm(x, dim=1)
        + torch.linalg.norm(b64, dim=1))
    return float(fwd.max()), float(back.max())


def against_f64(label, inp):
    """ROADMAP Queue 3 item 12: #1-#3's float32 results on a fit's first QP,
    the kernel's and its plain version's, each against the float64 solution
    of the same systems, forward and backward error (``f64_errors``): #1 and
    #3 on the first Mehrotra step's system, #2 on the first corrector's (the
    factor's L L^T), #3 on the cold start; and #1's factor by |A - L L^T| /
    |A|. Prints them; returns {case: (fwd kernel, fwd plain, back kernel,
    back plain)}."""
    from hybdrt_torch.ops import chol_lane as cl

    h, rhs = inp["chol_factor_solve_lane"]
    l, r = inp["chol_solve_factored_lane"]
    a, b0 = inp["chol_solve_lane"]
    f64 = torch.float64
    l64 = torch.tril(l.to(f64))
    llt = l64 @ l64.mT
    cases = {
        "chol_factor_solve_lane x": (h, rhs, cl.chol_factor_solve_lane(h, rhs)[0],
                                     cl.chol_factor_solve_lane_plain(h, rhs)[0]),
        "chol_solve_lane x": (h, rhs, cl.chol_solve_lane(h, rhs), cl.chol_solve_lane_plain(h, rhs)),
        "chol_solve_factored_lane x": (llt, r, cl.chol_solve_factored_lane(l, r),
                                       cl.chol_solve_factored_lane_plain(l, r)),
        "chol_solve_lane cold start x": (a, b0, cl.chol_solve_lane(a, b0),
                                         cl.chol_solve_lane_plain(a, b0)),
    }
    out = {}
    for name, (m, v, got, want) in cases.items():
        (fk, bk), (fp, bp) = f64_errors(m, v, got), f64_errors(m, v, want)
        out[name] = (fk, fp, bk, bp)
    low = torch.tril(h.to(f64))
    a64 = low + torch.tril(low, -1).mT

    def factor_back(lf):
        lf = torch.tril(lf.to(f64))
        return float(torch.max(torch.linalg.norm(a64 - lf @ lf.mT, dim=(1, 2))
                               / torch.linalg.norm(a64, dim=(1, 2))))

    out["chol_factor_solve_lane L"] = (
        float("nan"), float("nan"), factor_back(cl.chol_factor_solve_lane(h, rhs)[1]),
        factor_back(cl.chol_factor_solve_lane_plain(h, rhs)[1]))
    print(f"  item 12, {label}: float32 kernel / plain against the float64 solution of the same "
          f"systems, worst lane: forward error max |x - x64| / max |x64|, backward error "
          f"|A x - b| / (|A| |x| + |b|)")
    for name, (fk, fp, bk, bp) in out.items():
        print(f"    {name}: forward {fk:.3g} / {fp:.3g}, backward {bk:.3g} / {bp:.3g}")
    return out


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
            # item 12: the kernel's own distance from the float64 steps
            k32 = ip_lane.ip_steps_lane(*args, n_steps)
            spread_k = max(float(((a - b.float()).abs() / (1 + b.float().abs())).max())
                           for a, b in zip(k32, p64))
            print(f"  item 12: ip_steps_lane against the plain steps in float64 on that QP: "
                  f"kernel {spread_k:.3g}, plain float32 {spread:.3g}")

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
    return walls, errs, total, res


# Phase 14: the het map through DRTMD. The two ragged fits' medians in turns
# (PERF.md §5: torch_fit_walls.py --single and --hybrid, PRs 14-15)
HET_RAGGED_MEDIANS = (0.7046, 0.8274)
HET_CPU_OBS = 64
# max |x32 - x64| / max |x64| of the het map's coupled resolve: 3x the
# spread of the port's plain path on the CPU on the card's float32 fits,
# 3.455e-2 (torch_fit_walls.py --het), as RESOLVE_F32_BOUND for phase 8
HET_F32_BOUND = 0.1036


def same_bits(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def hold_het_fit(md, eis_res, hyb_res):
    """Every observation fitted, finite, rss >= 0, llh finite; the EIS and
    hybrid observations' obs_x, obs_special and obs_fit_attr bit for bit
    phase 12's and phase 13's ragged fits (the same knobs, the live-lane
    loop either way)."""
    n = md.num_obs
    check(bool(md.obs_fit_status.all()), f"het map: {int(md.obs_fit_status.sum())}/{n} fitted")
    check(bool(np.all(np.isfinite(md.obs_x)) and np.all(md.obs_rss >= 0)
               and np.all(np.isfinite(md.obs_llh))), "het map: finite x, rss >= 0, finite llh")
    kinds = {"EIS": ([i for i in range(n) if md.obs_data[i][0] is None], eis_res),
             "hybrid": ([i for i in range(n) if md.obs_data[i][0] is not None], hyb_res)}
    for label, (idx, res) in kinds.items():
        check(len(idx) == len(res.x), f"het map: {len(idx)} {label} observations")
        ns = res.x_raw.shape[1] - res.x.shape[1]
        bad = []
        for k, i in enumerate(idx):
            li, ri = res.tau_indices[k]
            w, attr, n_i = ri - li, md.obs_fit_attr[i], int(res.num_rows[k])
            ok = (md.obs_tau_indices[i] == (li, ri) and same_bits(md.obs_x[i, li:ri], res.x[k][:w])
                  and same_bits(md.obs_special["R_inf"][i], res.r_inf[k])
                  and same_bits(md.obs_special["inductance"][i], res.inductance[k])
                  and same_bits(attr["x_raw"], res.x_raw[k][:ns + w])
                  and same_bits(attr["weights"], res.weights[k][:n_i])
                  and same_bits(attr["rho"], res.rho[k])
                  and same_bits(attr["s_vectors"], res.s_vectors[k][:, :ns + w])
                  and attr["n_iter"] == int(res.n_iter[k]))
            if not ok:
                bad.append(i)
        print(f"  het map {label} observations bit for bit the ragged fit's of phase "
              f"{12 if label == 'EIS' else 13}: {len(idx) - len(bad)}/{len(idx)}")
        check(not bad, f"het map {label} fits bitwise the ragged fitter's: differ at {bad[:8]}")


def phase_het(eis_res, hyb_res):
    """Phase 14: the het leg's map through ``DRTMD``: ``make_het_map(768,
    256)``, ``fit_all(batched=True)`` in float32 (cold, then three timed
    refits), the rebuild of all 1024 (P, q) on the card against the CPU's on
    the first 64, and ``resolve_group`` windowed in float64 and coupled in
    float32 and float64, each twice, the launch counters reset before each
    timed call; one profiled call of each. Returns ({label: launches of #1,
    #2, #3, #4}, {label: wall})."""
    import warnings
    from hybdrt_torch.mapping import resolve
    from hybdrt_torch.mapping.drtmd import STATE_KEYS, load_fit_state, resolve_windows
    from hybdrt_torch.ops import chol_lane as cl
    from hybdrt_torch.utils.probe import make_het_map, profile

    t_phase = time.time()
    launches, walls = {}, {}
    md = make_het_map(768, 256)
    first = timed(lambda: md.fit_all(batched=True, dtype=torch.float32))
    fit_walls = []
    for _ in range(3):
        cl.reset_launch_counts()
        fit_walls.append(timed(lambda: md.fit_all(refit=True, batched=True,
                                                  dtype=torch.float32)))
    launches["fit_all"] = dict(cl.LAUNCHES)
    walls["fit_all"] = min(fit_walls)
    n_iter = np.array([a["n_iter"] for a in md.obs_fit_attr])
    print(f"het: DRTMD.fit_all(batched=True, float32) of {md.num_obs} observations (768 EIS on 3 "
          f"grids, 256 hybrid on 2 protocols): first call {first:.3f} s, refits "
          f"{[round(w, 4) for w in fit_walls]} s against the two ragged fits' medians "
          f"{HET_RAGGED_MEDIANS[0]} + {HET_RAGGED_MEDIANS[1]} = {sum(HET_RAGGED_MEDIANS):.4f} s; "
          f"n_iter mean {n_iter.mean():.2f}; launches per fit_all {launches['fit_all']}")
    hold_het_fit(md, eis_res, hyb_res)
    check(all(launches["fit_all"][k] > 0 for k in FIT_KERNELS), "het fit_all launched #1-#3")
    profile("het fit_all", lambda: md.fit_all(refit=True, batched=True, dtype=torch.float32))

    # The rebuild: every (P, q) on the card, the first 64 against the CPU's
    idx = np.arange(md.num_obs)
    cl.reset_launch_counts()
    t0 = time.time()
    fits = md.get_fits_batched(idx)
    walls["rebuild"] = time.time() - t0
    cpu = load_fit_state(make_het_map(768, 256, device="cpu"),
                         {k: getattr(md, k) for k in STATE_KEYS})
    sub = idx[:HET_CPU_OBS]
    t0 = time.time()
    cpu_fits = cpu.get_fits_batched(sub)
    t_cpu = time.time() - t0
    dpq = max(float(np.max(np.abs(fits[i].fit_parameters[k] - cpu_fits[i].fit_parameters[k]))
                    / np.max(np.abs(cpu_fits[i].fit_parameters[k])))
              for i in sub for k in ("p_matrix", "q_vector"))
    print(f"het: get_fits_batched of {len(idx)} observations on the card {walls['rebuild']:.4f} s "
          f"(launches {dict(cl.LAUNCHES)}); the first {len(sub)} rebuilt on the CPU in "
          f"{t_cpu:.3f} s: max |d(P, q)| / max |(P, q)| {dpq:.3g}")
    check(dpq < 1e-9, f"het rebuild on the card within 1e-9 of the CPU's: {dpq}")

    # The resolves: windowed f64, coupled f32 and f64, each twice
    forms = {"windowed f64": dict(batched=True, dtype=torch.float64),
             "coupled f32": dict(coupled=True, dtype=torch.float32),
             "coupled f64": dict(coupled=True, dtype=torch.float64)}
    outs, objective, captured = {}, {}, {}
    real_batch = resolve.solve_resolve_batch

    def capture(systems, **kw):
        out = real_batch(systems, **kw)
        captured["systems"], captured["out"] = systems, out
        return out

    for label, kw in forms.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cold = timed(lambda: md.resolve_group("g", psi_sort_dims=["i"], **kw))
            cl.reset_launch_counts()
            resolve.solve_resolve_batch = capture
            try:
                walls[label] = timed(lambda: md.resolve_group("g", psi_sort_dims=["i"], **kw))
            finally:
                resolve.solve_resolve_batch = real_batch
        launches[label] = dict(cl.LAUNCHES)
        info = md.resolve_info
        outs[label] = (md.obs_x_resolved.copy(), {k: v.copy() for k, v in
                                                  md.obs_special_resolved.items()}, info)
        objective[label] = md.group_objective("g", psi_sort_dims=["i"])
        n_it = np.atleast_1d(info["n_iter"])
        print(f"het: resolve {label}: cold {cold:.3f} s, warm {walls[label]:.4f} s (rebuild "
              f"{info['rebuild_s']:.4f} s, host assembly {info['assembly_s']:.4f} s, solve "
              f"{info['solve_s']:.4f} s); IP iterations max {int(n_it.max())}"
              + (f" over {info['windows']} windows" if not info["coupled"] else
                 f", KKT residual {info['kkt_residual']:.4g} (tolerance {info['kkt_tol']:.4g})")
              + f"; PCG solves {info['pcg_solves']}, CG iterations {info['cg_iterations']}, "
              f"host syncs {info['host_syncs']}; objective {objective[label]:.10g}; launches "
              f"{launches[label]}")
        check(not caught, f"het resolve {label}: no warning ({[str(w.message) for w in caught]})")
        check(launches[label]["chol_factor_lane"] > 0
              and launches[label]["chol_solve_factored_lane"] > 0,
              f"het resolve {label} launched #4 and #2")
        check(np.all(np.isfinite(md.obs_x_resolved)), f"het resolve {label}: finite")
        if info["coupled"]:
            check(info["kkt_residual"] <= info["kkt_tol"], f"het {label}: KKT within tolerance")
        else:
            windowed = (captured["systems"], captured["out"])
        profile(f"het resolve {label}",
                lambda: md.resolve_group("g", psi_sort_dims=["i"], **kw))

    # The coupled optimum lies below the windowed resolve's objective by a
    # few units in 8e9 on this map: the float64 coupled resolve is held to
    # it, the float32 one to it within what float32 resolves at |f|
    f_win = objective["windowed f64"]
    f_tol = np.finfo(np.float32).eps * abs(f_win)
    print(f"het: coupled objective minus the windowed f64 one: f64 "
          f"{objective['coupled f64'] - f_win:.6g}, f32 {objective['coupled f32'] - f_win:.6g} "
          f"(eps32 |f| {f_tol:.6g})")
    check(objective["coupled f64"] <= f_win,
          "het coupled f64 objective no higher than the windowed one's")
    check(objective["coupled f32"] <= f_win + f_tol,
          "het coupled f32 objective no higher than the windowed f64 one's plus eps32 |f|")
    x32, x64 = outs["coupled f32"][0], outs["coupled f64"][0]
    d32 = float(np.max(np.abs(x32 - x64)) / np.max(np.abs(x64)))
    print(f"het: coupled f32 against f64: max |dx| / max |x| {d32:.4g} (bound {HET_F32_BOUND})")
    check(d32 <= HET_F32_BOUND, "het coupled f32 within HET_F32_BOUND of f64")

    # The windowed f64 resolve on the card against the CPU on the windows
    # that hold the first 64 observations in psi order
    (systems, (xs, info)) = windowed
    starts = resolve_windows(md.num_obs, 7, 2)
    n_win = sum(1 for st, _ in starts if st < HET_CPU_OBS)
    t0 = time.time()
    xs_cpu, info_cpu = resolve.solve_resolve_batch(systems[:n_win], dtype=torch.float64,
                                                   device="cpu", return_info=True)
    t_cpu = time.time() - t0
    same = np.asarray(info["n_iter"])[:n_win] == np.asarray(info_cpu["n_iter"])
    dx = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b))) for a, b in zip(xs[:n_win], xs_cpu))
    print(f"het: windowed f64, card against CPU ({t_cpu:.2f} s) on the {n_win} windows holding "
          f"the first {HET_CPU_OBS} observations: same IP iteration in {int(same.sum())}/{n_win}, "
          f"max |dx| / max |x| {dx:.3g}")
    check(same.all() and dx < 1e-8, "het windowed f64: the CPU's iterations and x within 1e-8")
    print(f"het: phase {time.time() - t_phase:.1f} s")
    return launches, walls, md


# Shares of the het map's EIS and hybrid rows whose optimized ridge mask holds
# a ridge within two supergrid points of both true relaxations. The port's
# float64 fit of the map on the CPU reads 1.0 on both (768/768 EIS, 256/256
# hybrid rows; torch_fit_walls.py --het-truth, NVIDIA H100 80GB HBM3 host,
# 700.00 W), and so does the card's float32 fit; the floor leaves 2 % of the
# rows to float32 rounding, which moves the pipeline (bad_obs 23 in float64,
# 11 in float32 there)
HET_TRUTH_FLOOR = {"eis": 0.98, "hybrid": 0.98}
POSTPROC_CALLS = 4


def phase_postproc(md, fit_wall):
    """Phase 15: the post-fit map pipeline on phase 14's fitted het map
    (host code), its walls, checks and digest. Returns {stage: median wall
    of the calls after the first}."""
    from hybdrt_torch.utils.probe import (POSTPROC_STAGES, het_truth_shares,
                                          max_troughs_between_ridges, postproc_digest,
                                          run_postproc_pipeline)

    t_phase = time.time()
    calls = [run_postproc_pipeline(md, return_outputs=True) for _ in range(POSTPROC_CALLS)]
    timing, res = calls[0]
    stages = (*POSTPROC_STAGES, "total_s")
    print("postproc: first call " + ", ".join(f"{k} {timing[k]:.4f}" for k in stages)
          + f" s; bad_obs {timing['bad_obs']}")
    for k in stages:
        print(f"postproc: {k} over calls 2-{POSTPROC_CALLS} "
              f"{[round(c[0][k], 4) for c in calls[1:]]} s")
    warm = {k: float(np.median([c[0][k] for c in calls[1:]])) for k in stages}
    print(f"postproc: postproc_over_fit {warm['total_s'] / fit_wall:.4f} (median total "
          f"{warm['total_s']:.4f} s over phase 14's fit_all refit {fit_wall:.4f} s)")

    n, n_tau = md.num_obs, len(md.tau_supergrid)
    x_nd, digest = res["x_nd"], postproc_digest(res)
    check(x_nd.shape == (n, n_tau) and bool(np.isfinite(x_nd).all()),
          f"postproc: x_nd {x_nd.shape} finite (every psi measured)")
    check(bool(np.isfinite(res["x_filt"]).all()), "postproc: x_filt finite")
    check(0 <= timing["bad_obs"] <= n, f"postproc: bad_obs {timing['bad_obs']} in [0, {n}]")
    for key in ("ridge_mask", "trough_mask", "ridge_opt", "trough_opt"):
        check(res[key].dtype == bool and res[key].shape == x_nd.shape,
              f"postproc: {key} boolean of x_nd's shape")
    most = max_troughs_between_ridges(res["ridge_opt"], res["trough_opt"])
    check(most <= 1, f"postproc: at most one trough between adjacent ridges ({most})")
    same = all(postproc_digest(r) == digest and t["bad_obs"] == timing["bad_obs"]
               for t, r in calls[1:])
    check(same, "postproc: every call's outputs the first call's")

    # the optimized mask is held; coef_to_ridges' own is reported beside it
    for label in ("ridge_mask", "ridge_opt"):
        shares = het_truth_shares(md, res[label])
        print(f"postproc: rows with a ridge within 2 points of tau_1 / tau_2 / both ({label}): "
              + "; ".join(f"{kind} ({v['rows']}) {v['tau1']:.4f} / {v['tau2']:.4f} / "
                          f"{v['both']:.4f}" for kind, v in shares.items()))
    for kind, floor in HET_TRUTH_FLOOR.items():
        check(shares[kind]["both"] >= floor,
              f"postproc: {kind} rows near both relaxations {shares[kind]['both']:.4f} >= {floor}")
    print(f"postproc: digest (bad observations, optimized ridge and trough masks) {digest}")
    print(f"postproc: phase {time.time() - t_phase:.1f} s")
    return warm


# Phase 16: the reference's defaults. The quick start's truth (its ZARCs:
# 1.0 ohm at 1e-3 s, 0.8 ohm at 1e-1 s); the port's float64 fit on a CPU
# puts its peaks at 1.0042e-3 and 0.10042 s (0.002 decade off) and
# quantify_peaks at 1.0076 and 0.7852 ohm, so the margin on each peak's Rp
# is 3x the larger miss (0.0148), rounded up
QS_PEAK_TAU, QS_PEAK_DECADES = (1e-3, 1e-1), 0.1
QS_PEAK_R, QS_R_MARGIN = (1.0, 0.8), 0.05
# The serial het map: make_het_map(48, 16) fitted by fit_all(), against the
# same observations fitted by fit_all(batched=True, dtype=float64) with the
# DRT's own solver settings (batch_fit_kw={}): the share of observations at
# the same iteration count with obs_x within 1e-6 of max |x|, 49 of 64 with
# the port on a CPU (63 of 64 at the same count; tests/serial_map_floor.py),
# which the card's share may not fall below. The map is half the depth it
# had through PR 19 (96, 32), where the card read the CPU's 91 of 128: its
# serial fit took 115-181 s of the whole script
SERIAL_MAP = (48, 16)
SERIAL_SHARE_FLOOR = 49 / 64
# The default (dense) resolve against the batched windows of the same map:
# both land on one flat optimum in different places, in the JAX package too
# (ROADMAP Queue 3 item 16): the objectives agree to DENSE_OBJ_RTOL of |f|
# (1.8e-13 on a CPU), and x to 3x the CPU's max |dx| / max |x| on this map,
# 1.1757e-3 (tests/serial_map_floor.py); all 13 of its windows solved again
# on the CPU
DENSE_OBJ_RTOL = 1e-10
DENSE_X_BOUND = 3.527e-3
DENSE_CPU_WINDOWS = 13
# The 1024-observation default resolve runs where the serial map's 13
# windows' wall scaled to 205 stays within this (s), else on the first 256
# observations
DENSE_BIG_S = 30.0


# the least share of points a probability guard of phase 16 must hold
PROB_MIN_SHARE = 0.5


def report_probabilities(label, p, p_ref, bound):
    """Hold the card's probability map ``p`` against the CPU's ``p_ref``
    point by point, wherever the point's bound (``probe.prob_bounds``) is
    at most ``probe.PROB_HOLD``, on at least ``PROB_MIN_SHARE`` of the
    points; print how many points that leaves out."""
    from hybdrt_torch.utils.probe import PROB_HOLD, held_probabilities
    held, excess, d_held = held_probabilities(p, p_ref, bound)
    n_held = int(held.sum())
    print(f"  {label}: {n_held} of {held.size} points held (bound <= {PROB_HOLD}), "
          f"{held.size - n_held} left out; held max |d| {d_held:.3g}, their bounds up to "
          f"{float(np.max(bound[held])) if n_held else float('nan'):.3g}; max |d| over all points "
          f"{float(np.max(np.abs(p - p_ref))):.3g}")
    check(n_held >= PROB_MIN_SHARE * held.size, f"{label}: at least {PROB_MIN_SHARE} held")
    check(excess <= 0, f"{label} within its per-point CDF bound (excess {excess:.3g})")


def phase_quickstart():
    """Phase 16a: the quick start's single fit on the card (float64) and its
    posterior, peak and likelihood readouts, against the same fit on the
    CPU. Returns (walls, launches of the timed fit)."""
    import copy

    import hybdrt_torch
    from hybdrt_torch.ops import basis as basis_mod
    from hybdrt_torch.ops import chol_lane as cl
    from hybdrt_torch.utils.probe import (cov_bound, drt_prob_inputs, lml_bound, prob_bounds,
                                          quickstart_eis, quickstart_readouts, variance_errors)

    walls = {}
    freq, z = quickstart_eis()
    drt = hybdrt_torch.DRT()
    drt.fit_eis(freq, z)
    cl.reset_launch_counts()
    walls["fit_eis"] = timed(lambda: drt.fit_eis(freq, z))
    launches, routes = launch_counts(), dict(cl.QP_ROUTES)
    first = timed(lambda: quickstart_readouts(drt))
    t0 = time.time()
    card = quickstart_readouts(drt)
    torch.cuda.synchronize()
    walls["readouts"] = time.time() - t0
    print(f"defaults 16a: DRT().fit_eis of the quick start's spectrum, f64 on the card: warm "
          f"{walls['fit_eis']:.4f} s, n_iter {drt.qphb_params['n_iter']}; launches {launches}; "
          f"QPs by route {routes}; the readouts {first:.4f} s, then {walls['readouts']:.4f} s")
    check(all(launches[k] > 0 for k in FIT_KERNELS), f"16a fit launched #1-#3: {launches}")
    check(routes["library"] == 0 and routes["lane"] > 0, "16a QPs through the lane kernels")

    cpu = hybdrt_torch.DRT(device="cpu").fit_eis(freq, z)
    ref = quickstart_readouts(cpu)
    for key in ("peaks", "peaks_prob"):
        check(np.array_equal(card[key][2], ref[key][2]),
              f"16a {key} indices equal on the card and the CPU: {card[key][2]} {ref[key][2]}")
    p_g, p_c = (np.asarray(d.qphb_params["p_matrix"]) for d in (drt, cpu))
    bound = cov_bound(p_g, p_c)
    d_cov = float(np.max(np.abs(card["cov"] - ref["cov"])) / np.max(np.abs(ref["cov"])))
    tau, ns = card["tau"], drt.get_qp_mat_offset()
    em = basis_mod.func_eval_matrix_host(np.log(drt.basis_tau), np.log(tau), "gaussian",
                                         drt.tau_epsilon, 0)
    err, vb = variance_errors(card["var"], ref["var"], p_g, p_c, em, ns)
    mu = np.abs(cpu.predict_distribution(tau))
    ci_tol = 1e-6 * np.max(mu) + 1.96 * np.sqrt(ref["var"]) * (0.5 * vb + 1e-12)
    d_ci = max(float(np.max(np.abs(a - b) - ci_tol)) for a, b in zip(card["ci"], ref["ci"]))
    print(f"  card against CPU: cov max |d| / max |cov| {d_cov:.3g} (bound {bound:.3g}); "
          f"variances max rel {err.max():.3g} (bounds up to {vb.max():.3g}); CI band excess over "
          f"its bound {d_ci:.3g}; peaks {card['peaks'][0]} / prob {card['peaks_prob'][0]}")
    check(d_cov <= bound, "16a parameter covariance within cond(P) max(eps, dP)")
    check(np.all(err <= vb + 1e-12), "16a variances within their readout bounds")
    check(d_ci <= 0, "16a CI band within sigma's bound and the fit tolerance")
    # predict_peak_prob reads tau at 10 a decade; each point against its own bound
    inputs = drt_prob_inputs(drt, cpu, drt.get_tau_eval(10))
    check(inputs["var_excess"] <= 1e-12, "16a variances of orders 0-2 within their bounds")
    bound = prob_bounds("peak_prob", inputs["mus"], inputs["mus_ref"], inputs["var"],
                        inputs["var_ref"], floor=True)
    report_probabilities("16a peak_prob", card["peak_prob"], ref["peak_prob"], bound)
    # likelihoods: the card's on the CPU fit's state, and each on its own fit
    same = copy.copy(drt)
    same.qphb_params, same.fit_parameters = cpu.qphb_params, cpu.fit_parameters
    same.coefficient_scale = cpu.coefficient_scale
    rel = {fn: abs(getattr(same, f"evaluate_{fn}")() / ref[fn] - 1) for fn in ("rss", "llh", "bic")}
    qp_c = cpu.qphb_params
    d_lml = abs(same.evaluate_lml() - ref["lml"])
    lml_b = lml_bound(p_c, qp_c["rm"] * qp_c["weights"][:, None]) + 1e-9 * abs(ref["lml"])
    own = {fn: abs(card[fn] / ref[fn] - 1) for fn in ("rss", "llh", "bic", "lml")}
    print("  likelihoods on one state, card against CPU: " + ", ".join(
        f"{k} {v:.3g}" for k, v in rel.items()) + f", lml |d| {d_lml:.3g} (bound {lml_b:.3g}); "
          "each fit's own, relative: " + ", ".join(f"{k} {v:.3g}" for k, v in own.items()))
    check(all(v <= 1e-9 for v in rel.values()), "16a rss, llh, bic within 1e-9 on one state")
    check(d_lml <= lml_b, "16a lml within its log-det bound on one state")
    check(all(own[k] <= 1e-6 for k in ("rss", "llh", "bic")), "16a own-fit likelihoods")
    fim = card["fisher"]
    check(np.max(np.abs(same.fisher_matrix() - ref["fisher"])) <= 1e-12 * np.max(
        np.abs(ref["fisher"])), "16a Fisher matrix on one state within 1e-12")
    lam = np.linalg.eigvalsh(fim)
    check(lam.min() >= -fim.shape[0] * np.finfo(float).eps * lam.max(), "16a Fisher PSD")
    check(abs(card["chi_sq"] / ref["chi_sq"] - 1) <= 1e-6, "16a chi_sq")
    check(np.allclose(card["sigma"], ref["sigma"], rtol=1e-6), "16a predict_sigma")
    # the quick start's truth
    peaks = card["peaks"][0]
    print(f"  truth: peaks {peaks} s against {QS_PEAK_TAU}, quantify_peaks {card['quantify']} "
          f"against {QS_PEAK_R} (margin {QS_R_MARGIN}); split_r_p {card['split']}")
    check(len(peaks) == 2 and np.all(np.abs(np.log10(peaks / np.array(QS_PEAK_TAU)))
                                     <= QS_PEAK_DECADES), "16a peaks near the truth")
    check(np.all(np.abs(card["quantify"] - np.array(QS_PEAK_R)) <= QS_R_MARGIN),
          "16a quantify_peaks near the truth")
    for key in ("quantify", "split", "integral", "peak_drts"):
        check(np.allclose(card[key], ref[key], rtol=1e-6, atol=1e-10), f"16a {key} card vs CPU")
    return walls, launches


def phase_defaults(het_md):
    """Phase 16: the reference's defaults on the card: 16a the quick start's
    single fit and readouts; 16b the serial het map; 16c
    ``estimate_obs_drt_var`` on phase 14's map; 16d the default (dense)
    resolve; 16e the map's uncertainty readouts. Returns ({label: wall},
    {label: launches of #1-#3})."""
    from hybdrt_torch.mapping import resolve
    from hybdrt_torch.mapping.drtmd import STATE_KEYS, load_fit_state, resolve_windows
    from hybdrt_torch.ops import basis as basis_mod
    from hybdrt_torch.ops import chol_lane as cl
    from hybdrt_torch.utils.probe import (cov_bound, make_het_map, map_prob_inputs,
                                          posterior_definite, prob_bounds,
                                          serial_batched_agreement, serial_map, variance_errors)

    t_phase = time.time()
    walls, launches = {}, {}
    qs_walls, launches["quickstart fit_eis"] = phase_quickstart()
    walls.update({f"quickstart {k}": v for k, v in qs_walls.items()})

    # 16b: the serial map, one call in the process the phases before warmed
    cl.reset_launch_counts()
    md, log, walls["serial fit_all"] = serial_map(*SERIAL_MAP)
    torch.cuda.synchronize()
    launches["serial fit_all"] = launch_counts()
    summary = log.summary()
    print(f"defaults 16b: make_het_map{SERIAL_MAP} fit_all() (serial, f64) of {md.num_obs} "
          f"observations: {walls['serial fit_all']:.3f} s; launches "
          f"{launches['serial fit_all']}")
    for kind, row in summary.items():
        print(f"  {kind}: {row['n']} fits, median wall {row['median_wall']:.4f} s; per fit "
              + ", ".join(f"{k} {v[0]}-{v[1]}" for k, v in row.items()
                          if k not in ("n", "median_wall")))
    check(md.obs_fit_status.all(), "16b every observation fitted")
    check(all(np.isfinite(a).all() for a in (md.obs_x, md.obs_llh, md.obs_rss)),
          "16b obs_x, obs_llh, obs_rss finite")
    definite = posterior_definite(md, np.arange(md.num_obs))
    var_ok = np.isfinite(md.obs_drt_var).all(axis=1) & (md.obs_drt_var >= 0).all(axis=1)
    print(f"  obs_drt_var finite and >= 0 on {int(var_ok.sum())} of {md.num_obs} observations; "
          f"P without a float64 Cholesky factor (the general inverse, Queue 3 item 17) on "
          f"{int((~definite).sum())}: {np.flatnonzero(~definite).tolist()}")
    check(np.isfinite(md.obs_drt_var).all(), "16b obs_drt_var finite")
    check(var_ok[definite].all(), "16b obs_drt_var >= 0 wherever P factors")
    check(all(r[k] > 0 for r in log.per_obs for k in FIT_KERNELS) and
          all(r["qp_library"] == 0 and r["qp_lane"] > 0 for r in log.per_obs),
          "16b every serial fit's QPs launched #1-#3")
    mb = make_het_map(*SERIAL_MAP)
    mb.batch_fit_kw = {}
    mb.fit_all(batched=True, dtype=torch.float64)
    same_it, share = serial_batched_agreement(md, mb)
    print(f"  against fit_all(batched=True, float64) with the DRT's settings: same n_iter "
          f"{same_it:.4f}, and x within 1e-6 of max |x| {share:.4f} (CPU floor "
          f"{SERIAL_SHARE_FLOOR})")
    check(share >= SERIAL_SHARE_FLOOR, "16b serial against batched share at or above the CPU's")

    # 16c: the group variance of phase 14's map
    t0 = time.time()
    het_md.estimate_obs_drt_var(refresh=True)
    walls["obs_drt_var"] = time.time() - t0
    cpu = load_fit_state(make_het_map(768, 256, device="cpu"),
                         {k: getattr(het_md, k) for k in STATE_KEYS})
    sub = np.arange(HET_CPU_OBS)
    fits_g, fits_c = het_md.get_fits_batched(sub), cpu.get_fits_batched(sub)
    worst = 0.0
    for i in sub:
        dg, dc = fits_g[i], fits_c[i]
        own = np.diag(dc.estimate_distribution_cov(tau=het_md.tau_supergrid, extend_var=True))
        em = basis_mod.func_eval_matrix_host(np.log(dc.basis_tau), np.log(het_md.tau_supergrid),
                                             "gaussian", dc.tau_epsilon, 0)
        err, vb = variance_errors(het_md.obs_drt_var[i], own,
                                  np.asarray(dg.fit_parameters["p_matrix"]),
                                  np.asarray(dc.fit_parameters["p_matrix"]), em,
                                  dc.get_qp_mat_offset(), het_md.tau_supergrid, dc.basis_tau)
        check(np.all(err <= vb + 1e-12), f"16c obs {i}: variance within its readout bound")
        worst = max(worst, float(np.max(err / (vb + 1e-12))))
    print(f"defaults 16c: estimate_obs_drt_var of phase 14's {het_md.num_obs} observations "
          f"{walls['obs_drt_var']:.4f} s; the first {HET_CPU_OBS} against the CPU's "
          f"per-observation path: largest error over its bound {worst:.3g}")
    check(np.isfinite(het_md.obs_drt_var).all() and (het_md.obs_drt_var >= 0).all(),
          "16c variances finite and >= 0")

    # 16d: the default resolve, its windows captured for the CPU
    captured, real = [], resolve.solve_dense_window

    def capture(p, q, lb, **kw):
        out = real(p, q, lb, **kw)
        captured.append((p, q, lb, out))
        return out

    md.resolve_group("g", psi_sort_dims=["i"])
    cl.reset_launch_counts()
    resolve.solve_dense_window = capture
    try:
        walls["dense resolve"] = timed(lambda: md.resolve_group("g", psi_sort_dims=["i"]))
    finally:
        resolve.solve_dense_window = real
    info, routes = md.resolve_info, dict(cl.QP_ROUTES)
    n_it = np.asarray(info["n_iter"])
    print(f"defaults 16d: resolve_group('g') default (dense windows, f64) of the serial map: "
          f"{walls['dense resolve']:.4f} s ({info['windows']} windows of n = "
          f"{len(captured[0][1])}; rebuild {info['rebuild_s']:.4f} s, host assembly "
          f"{info['assembly_s']:.4f} s, solve {info['solve_s']:.4f} s); IP iterations "
          f"{n_it.tolist()}; QPs by route {routes}; lane launches {dict(cl.LAUNCHES)}")
    check(routes == {"lane": 0, "library": info["windows"], "fused_plain": 0},
          "16d every window's QP took the library route")
    check(all(v == 0 for v in cl.LAUNCHES.values()), "16d no lane kernel launched")
    check(np.isfinite(md.obs_x_resolved).all(), "16d finite")
    xd, fd = md.obs_x_resolved.copy(), md.group_objective("g", psi_sort_dims=["i"])
    md.resolve_group("g", psi_sort_dims=["i"], batched=True)
    xb, fb = md.obs_x_resolved.copy(), md.group_objective("g", psi_sort_dims=["i"])
    dx = float(np.max(np.abs(xd - xb)) / np.max(np.abs(xb)))
    print(f"  dense against batched=True f64: max |dx| / max |x| {dx:.4g} (bound "
          f"{DENSE_X_BOUND}), objective {fd:.12g} against {fb:.12g} (rel {(fd - fb) / abs(fb):.3g})")
    check(dx <= DENSE_X_BOUND, "16d dense x within DENSE_X_BOUND of the batched windows'")
    check(abs(fd - fb) <= DENSE_OBJ_RTOL * abs(fb), "16d objectives within DENSE_OBJ_RTOL")
    t0 = time.time()
    same, dxs = [], []
    for p, q, lb, (x, it) in captured[:DENSE_CPU_WINDOWS]:
        xc, itc = real(p, q, lb, device="cpu")
        same.append(it == itc)
        dxs.append(float(np.max(np.abs(x - xc)) / np.max(np.abs(xc))))
    print(f"  the first {DENSE_CPU_WINDOWS} windows on the CPU ({time.time() - t0:.2f} s): same "
          f"IP iterations {sum(same)}/{len(same)}, max |dx| / max |x| {max(dxs):.3g}")
    check(all(same) and max(dxs) < 1e-8, "16d windows at the CPU's iterations, x within 1e-8")

    # 16d: the 1024-observation map's default resolve, or its first 256
    n_win, n_16d = len(resolve_windows(het_md.num_obs, 7, 2)), info["windows"]
    estimate = walls["dense resolve"] * n_win / n_16d
    big = estimate <= DENSE_BIG_S
    groups = list(het_md.obs_group_id)
    if not big:
        het_md.obs_group_id = ["g" if i < 256 else "rest" for i in range(het_md.num_obs)]
    cl.reset_launch_counts()
    try:
        walls["dense resolve het"] = timed(lambda: het_md.resolve_group("g", psi_sort_dims=["i"]))
    finally:
        het_md.obs_group_id = groups
    info = het_md.resolve_info
    print(f"defaults 16d: the default resolve of phase 14's map, "
          f"{'all 1024' if big else 'its first 256'} observations ({n_16d} windows scaled to "
          f"{n_win}: {estimate:.1f} s against {DENSE_BIG_S} s): {walls['dense resolve het']:.4f} s, "
          f"{info['windows']} windows, IP iterations median {np.median(info['n_iter']):.0f} max "
          f"{int(np.max(info['n_iter']))}, solve {info['solve_s']:.4f} s, host assembly "
          f"{info['assembly_s']:.4f} s; QPs by route {dict(cl.QP_ROUTES)}")
    check(cl.QP_ROUTES == {"lane": 0, "library": info["windows"], "fused_plain": 0},
          "16d het windows took the library route")
    check(np.isfinite(het_md.obs_x_resolved).all(), "16d het resolve finite")

    # 16e: the map's uncertainty readouts, 8 observations against the CPU
    idx = md.fitted_obs_index()
    t0 = time.time()
    reads = {"drt_var": md.predict_drt_var(idx), "x_var": md.predict_x_var(idx),
             "curv_prob": md.predict_curv_prob(), "peak_prob": md.predict_peak_prob()}
    walls["readouts"] = time.time() - t0
    print(f"defaults 16e: predict_drt_var, predict_x_var, predict_curv_prob and "
          f"predict_peak_prob of {len(idx)} observations {walls['readouts']:.4f} s")
    ok = definite[idx]
    for k, v in reads.items():
        check(np.isfinite(v[ok]).all(), f"16e {k} finite wherever P factors")
    for k in ("curv_prob", "peak_prob"):
        check(np.all((reads[k][ok] >= 0) & (reads[k][ok] <= 1)), f"16e {k} in [0, 1]")
    cpu = load_fit_state(make_het_map(*SERIAL_MAP, device="cpu"),
                         {k: getattr(md, k) for k in STATE_KEYS})
    sub = idx[ok][:8]
    tau = md.get_tau_eval(10)
    fits = cpu.get_fits_batched(sub)
    inputs = map_prob_inputs(md, cpu, sub, tau)
    check(inputs["var_excess"] <= 1e-12, "16e drt_var of orders 0-2 within their bounds")
    for kind, fn in (("curv", "predict_curv_prob"), ("peak_prob", "predict_peak_prob")):
        report_probabilities(f"16e {fn}", getattr(md, fn)(obs_index=sub),
                             getattr(cpu, fn)(obs_index=sub),
                             prob_bounds(kind, inputs["mus"], inputs["mus_ref"],
                                         inputs["var"], inputs["var_ref"]))
    x_cov_c, x_var_g = cpu.predict_x_cov(sub), md.predict_x_var(sub)
    d_xvar = [float(np.max(np.abs(x_var_g[k] - np.diag(c))) / np.max(np.abs(c)))
              for k, c in enumerate(x_cov_c)]
    x_bound = [cov_bound(*(np.asarray(fits[i].fit_parameters["p_matrix"]),) * 2) for i in sub]
    print(f"  8 observations against the CPU: x_var max |d| / max |x_cov| {max(d_xvar):.3g} "
          f"(bounds down to {min(x_bound):.3g})")
    check(all(d <= b for d, b in zip(d_xvar, x_bound)), "16e x_var within the covariance bound")
    print(f"defaults: phase {time.time() - t_phase:.1f} s")
    return walls, launches


# Phase 17: the rest of the fit surface. The single fits of 17c-17d run in
# float64 on the card and are held to the CPU's: the same iterations, and
# max |dx| / max |x| within REST_X_TOL; the MAP samples on one fit state (the
# CPU fit's) with one Laplace sigma (the CPU's inverse: at these posteriors
# cond(P) is 3e15, and two LAPACKs' inverses part by 0.4 %), x within
# REST_X_TOL of max |x| and lp within REST_LP_RTOL
REST_X_TOL = 1e-6
REST_LP_RTOL = 1e-8
# 17d: the ragged downsampled fit's float64 reference on the CPU, its first
# observations (both protocols among them)
REST_CPU_OBS = 64


class PlainLanes:
    """Inside ``with``, the QP's lane kernels (#1-#4 and the fused steps)
    are their plain PyTorch versions, on the same card tensors: the same
    call with no kernel launched."""
    NAMES = ("chol_factor_solve_lane", "chol_solve_factored_lane", "chol_solve_lane",
             "chol_factor_lane")

    def __enter__(self):
        from hybdrt_torch.ops import chol_lane as cl, ip_lane, qp
        self.saved = [(cl, n, getattr(cl, n)) for n in self.NAMES]
        self.saved.append((qp, "ip_steps_lane", qp.ip_steps_lane))
        for n in self.NAMES:
            setattr(cl, n, getattr(cl, n + "_plain"))
        qp.ip_steps_lane = ip_lane.ip_steps_lane_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def one_ulp(a, seed=0):
    """``a`` (B, n, n) with every entry moved one ulp of its dtype up or down
    at random, symmetrically: the rounding another factor order could leave."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    sign = (torch.randint(0, 2, a.shape, generator=g) * 2 - 1).to(a.device, a.dtype)
    sign = torch.triu(sign) + torch.triu(sign, 1).mT
    return torch.nextafter(a, a + sign * torch.inf)


# one-ulp moves of P in hold_fused_steps' spread
ULP_SEEDS = (0, 1, 2)


def worst_lane(a, ref):
    """The worst lane's distance max |a - ref| / (1 + |ref|), in float64."""
    ref = ref.double()
    return float(((a.double() - ref).abs() / (1 + ref.abs())).amax(1).max())


def hold_fused_steps(label, inp):
    """#5 on a fit's first warm QP (ROADMAP Queue 3 item 12's bound: within
    6x the plain steps' spread against float64), in both precisions, on the
    same per-lane systems. A ragged fit's warm QPs are so ill-conditioned
    (cond(H) 1e6-1e9 on the het EIS half) that float32 steps land far from
    float64 and at random: on P moved one ulp (``one_ulp``) the plain float32
    steps' worst lane moves by several times. So the spread is the plain
    float32 steps' worst lane over P and its one-ulp moves (``ULP_SEEDS``),
    and the kernel's worst lane is held within 6x it plus TOL. In float64,
    where these systems keep their digits, the kernel on the same inputs is
    held to the plain float64 steps within 6x their own one-ulp spread plus
    1e-12. Prints every distance."""
    from hybdrt_torch.ops import ip_lane

    check(inp is not None, f"{label}: the fit called ip_steps_lane")
    args, n_steps = inp[:6], inp[6]
    a64 = [a.double() for a in args]
    p64 = ip_lane.ip_steps_lane_plain(*a64, n_steps)
    lines = []
    for dtype, inputs, ref in ((torch.float32, args, p64), (torch.float64, a64, None)):
        k = ip_lane.ip_steps_lane(*inputs, n_steps)
        p = ip_lane.ip_steps_lane_plain(*inputs, n_steps)
        moved = [ip_lane.ip_steps_lane_plain(one_ulp(inputs[0], seed), *inputs[1:], n_steps)
                 for seed in ULP_SEEDS]
        for part in range(3):
            base = p64[part] if ref is not None else p[part]
            d_k = worst_lane(k[part], base)
            spread = [worst_lane(v[part], base) for v in ([p] if ref is not None else []) + moved]
            floor = TOL if dtype == torch.float32 else 1e-12
            lines.append(f"{'xsz'[part]} {str(dtype)[6:]}: kernel {d_k:.3g}, plain "
                         + "/".join(f"{v:.3g}" for v in spread))
            check(d_k <= 6 * max(spread) + floor,
                  f"{label}: ip_steps_lane {'xsz'[part]} {dtype} within 6x the plain steps' "
                  f"spread ({d_k:.3g} against {max(spread):.3g})")
    print(f"  {label}: ip_steps_lane on the first warm QP {tuple(args[0].shape)}, {n_steps} "
          f"steps, worst lane's distance from the float64 plain steps (float32: the plain "
          f"steps on P, then on P moved one ulp; float64: the plain steps on P moved one ulp): "
          + "; ".join(lines))


def fused_bounds(label, rp, rp_ref, d_rinf, zrel, same, both):
    """Phase 13's bounds (Rp median and p95, the functional fit) on the
    lanes converged in both fits (``both``) where they are at least half, as
    phase 13 holds them; else on the lanes that stop at the same iteration
    in both (``same``), as phase 6 holds the fused fit: without
    ``pred_stop`` the het map's EIS half converges almost no lane (phase 12),
    while lanes that both run to ``max_iter`` on limit cycles part by more
    where a hybrid lane's cycle is wide. Every lane's numbers reported."""
    rel = np.abs(rp - rp_ref) / np.abs(rp_ref)

    def stats(m):
        if not m.any():
            return "none"
        return (f"Rp rel diff median {np.median(rel[m]):.3g} p95 {np.percentile(rel[m], 95):.3g} "
                f"max {np.max(rel[m]):.3g}, max |dR_inf| {np.max(d_rinf[m]):.3g}, functional "
                f"fit max {np.max(zrel[m]):.3g}")

    print(f"  {label}, {len(rp)} observations: {stats(np.ones(len(rp), dtype=bool))}; on the "
          f"{int(same.sum())} stopping at the same iteration: {stats(same)}; on the "
          f"{int(both.sum())} converged in both: {stats(both)}")
    held = both if both.sum() >= len(both) // 2 else same
    name = "converged in both" if held is both else "stopping at the same iteration"
    check(held.sum() >= len(held) // 2, f"{label}: half the lanes {name}")
    check(np.median(rel[held]) < 1e-3, f"{label} Rp median rel diff < 1e-3 ({name})")
    check(np.percentile(rel[held], 95) < 3e-3, f"{label} Rp p95 rel diff < 3e-3 ({name})")
    check(np.max(zrel[held]) < 1.5e-2, f"{label} functional fit rel diff < 1.5e-2 ({name})")
    print(f"  {label}: held on the lanes {name}")


def phase_fused_map(het_md):
    """Phase 17a: the het map fitted by ``DRTMD.fit_all(batched=True,
    dtype=float32)`` with ``qp_fused=True`` added to its ``batch_fit_kw``:
    both ragged fits launch #5, which is held on each fit's first warm QP
    within 6x its plain version's spread against float64, in float32 and in
    float64 (``hold_fused_steps``); the map against phase 14's plain map by phase
    13's float32 bounds; the second call's wall and launches. Returns
    (walls, launches, max abs err of #5)."""
    from types import SimpleNamespace

    from hybdrt_torch import BatchedRaggedFitter
    from hybdrt_torch.ops import basis, chol_lane as cl, ip_lane
    from hybdrt_torch.utils.probe import make_het_map

    md = make_het_map(768, 256)
    md.batch_fit_kw = dict(md.batch_fit_kw, qp_fused=True)
    n = md.num_obs
    fits = []
    real_fit = BatchedRaggedFitter.fit

    def fit(self, *args, **kw):
        """The ragged fit, its #5 launches and first warm QP, and each
        lane's prediction from its fit and from phase 14's plain fit of the
        same observation through this fit's design (the map's fitters are
        shared by both halves, so read it here)."""
        n0 = ip_lane.LAUNCHES["ip_steps_lane"]
        with FirstFusedInputs() as first:
            res = real_fit(self, *args, **kw)
        torch.cuda.synchronize()
        hybrid = res.num_chrono.max() > 0
        idx = [i for i in range(n) if (md.obs_data[i][0] is not None) == hybrid]
        x_plain = np.zeros_like(res.x_raw)
        for k, i in enumerate(idx):
            xr = het_md.obs_fit_attr[i]["x_raw"]
            x_plain[k, :len(xr)] = xr
        y = self.final_predictions(res)
        y_plain = self.final_predictions(SimpleNamespace(x_raw=x_plain))
        zrel = np.max(np.abs(y - y_plain), axis=1) / np.max(np.abs(self._last_batch["rzv"]),
                                                          axis=1)
        fits.append(("hybrid" if hybrid else "EIS", self.qp_fused, res, idx, zrel,
                     ip_lane.LAUNCHES["ip_steps_lane"] - n0, first.inputs))
        return res

    BatchedRaggedFitter.fit = fit
    try:
        first_wall = timed(lambda: md.fit_all(batched=True, dtype=torch.float32))
    finally:
        BatchedRaggedFitter.fit = real_fit
    check(len(fits) == 2 and all(f[1] for f in fits),
          f"17a: two fused ragged fits ({[f[1] for f in fits]})")
    area = basis.get_basis_func_area("gaussian", md.tau_epsilon)
    for label, _, res, idx, zrel, n5, inp in fits:
        print(f"rest 17a: the fused {label} half, {len(idx)} observations, n = "
              f"{res.x_raw.shape[1]}: ip_steps_lane launched {n5} times in the first call; "
              f"passes {int(res.n_iter.max())}, converged {int(res.converged.sum())}")
        check(n5 > 0, f"17a: the {label} half launched ip_steps_lane")
        hold_fused_steps(f"17a fused {label} ragged fit", inp)
        rp = np.sum(np.abs(md.obs_x[idx]), axis=1) * area
        rp_plain = np.sum(np.abs(het_md.obs_x[idx]), axis=1) * area
        d_rinf = np.abs(md.obs_special["R_inf"][idx] - het_md.obs_special["R_inf"][idx])
        both = np.array([md.obs_fit_attr[i]["converged"] and het_md.obs_fit_attr[i]["converged"]
                         for i in idx])
        same = np.array([md.obs_fit_attr[i]["n_iter"] == het_md.obs_fit_attr[i]["n_iter"]
                         for i in idx])
        fused_bounds(f"17a {label} half, fused against phase 14's plain map (f32)", rp, rp_plain,
                     d_rinf, zrel, same, both)
    cl.reset_launch_counts()
    ip_lane.reset_launch_counts()
    wall = timed(lambda: md.fit_all(refit=True, batched=True, dtype=torch.float32))
    launches = {**{k: cl.LAUNCHES[k] for k in FIT_KERNELS}, **ip_lane.LAUNCHES}
    print(f"rest 17a: fused fit_all of the het map (f32): first call {first_wall:.3f} s, second "
          f"{wall:.4f} s; launches {launches}")
    check(np.all(np.isfinite(md.obs_x)) and md.obs_fit_status.all(), "17a: fitted, finite")
    check(launches["ip_steps_lane"] > 0, "17a second call launched ip_steps_lane")
    return {"fused fit_all": wall}, launches


def same_fit(label, a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "tau_indices":
            ok = x == y
        elif x is None:
            ok = y is None
        else:
            ok = same_bits(x, y)
        check(ok, f"{label}: {f} with history bit for bit without")


def phase_histories():
    """Phase 17b: ``return_history=True`` on the het leg's 768 EIS spectra
    through the ragged fitter and on ``BatchedHybridFitter`` at
    ``make_hybrid_batch(1024)``, float32: each result bit for bit the same
    fit without history (a fresh fitter each, so both preps take the same
    path), and each lane's last history entry its final state. Returns
    walls."""
    import hybdrt_torch

    walls = {}
    obs, tau = make_het_eis(768, 256)
    t_, i_, f_, vb, zb = make_hybrid_batch(HYBRID_B, proto=0)
    cases = {
        "ragged EIS 768": (lambda: hybdrt_torch.BatchedRaggedFitter(
            tau, dtype=torch.float32, **HET_KW), (obs,)),
        f"BatchedHybridFitter {HYBRID_B}": (lambda: hybdrt_torch.BatchedHybridFitter(
            t_, i_, f_, dtype=torch.float32, **HET_KW), (vb, zb))}
    for label, (make, args) in cases.items():
        t0 = time.time()
        res, hist = make().fit(*args, return_history=True)
        torch.cuda.synchronize()
        walls[f"history {label}"] = time.time() - t0
        t0 = time.time()
        plain = make().fit(*args)
        torch.cuda.synchronize()
        walls[f"plain {label}"] = time.time() - t0
        same_fit(f"17b {label}", res, plain)
        it = hist["it"][:, -1]
        check(same_bits(hist["x"][:, -1], res.x_raw) and same_bits(it, res.n_iter)
              and same_bits(hist["converged"][:, -1], res.converged),
              f"17b {label}: the history's last entry is the final state")
        print(f"rest 17b: {label} with history {walls[f'history {label}']:.3f} s, without "
              f"{walls[f'plain {label}']:.3f} s (first calls); history "
              f"{ {k: v.shape for k, v in hist.items() if k in ('x', 'weights')} }, bit for bit")
    return walls


def cpu_sigma_inverse(cpu_drt):
    """``mat1d.invert_psd`` returning the inverse of ``cpu_drt``'s P computed
    on the CPU, for the card's MAP samples on the CPU fit's state."""
    from hybdrt_torch.ops import mat1d

    p_inv = mat1d.invert_psd(torch.as_tensor(cpu_drt.qphb_params["p_matrix"],
                                             dtype=torch.float64))

    def inverse(a, use_cholesky=True):
        return p_inv.to(a.device)

    return inverse


def phase_item5():
    """Phase 17c: the quick start's spectrum (f64): ``series_neg`` and
    ``weight_factor=2`` fits, the MAP samples at their defaults with their
    quantiles and posterior mean, and a serial map round-tripped with the
    "detail" attributes. Each held against the same call on the card with
    the plain lane versions and against the CPU. Returns (walls, launches of
    #1-#3, {kernel: max abs err})."""
    import tempfile

    import hybdrt_torch
    import hybdrt_torch.models.drt as drt_mod
    from hybdrt_torch.mapping.drtmd import DRTMD
    from hybdrt_torch.ops import chol_lane as cl
    from hybdrt_torch.utils.probe import quickstart_eis, small_map

    walls, total = {}, {k: 0 for k in FIT_KERNELS}
    freq, z = quickstart_eis()

    def fit(device, kw, plain=False):
        drt = hybdrt_torch.DRT(warn=False, device=device)
        if plain:
            with PlainLanes():
                drt.fit_eis(freq, z, **kw)
        else:
            drt.fit_eis(freq, z, **kw)
        return drt

    def dx(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b)))

    for label, kw in (("series_neg", dict(series_neg=True)),
                      ("weight_factor=2", dict(weight_factor=2))):
        fit(None, kw)
        cl.reset_launch_counts()
        t0 = time.time()
        card = fit(None, kw)
        torch.cuda.synchronize()
        walls[label] = time.time() - t0
        launches, routes = launch_counts(), dict(cl.QP_ROUTES)
        for k in FIT_KERNELS:
            total[k] += launches[k]
        plain, cpu = fit(None, kw, plain=True), fit("cpu", kw)
        n_it = [d.qphb_params["n_iter"] for d in (card, plain, cpu)]
        d_p = dx(card.fit_parameters["x"], plain.fit_parameters["x"])
        d_c = dx(card.fit_parameters["x"], cpu.fit_parameters["x"])
        print(f"rest 17c: DRT.fit_eis({label}), f64 on the card, n = "
              f"{card.qphb_params['p_matrix'].shape[0]}: {walls[label]:.4f} s warm; launches "
              f"{launches}; QPs by route {routes}; n_iter card / plain lanes / CPU {n_it}; max "
              f"|dx| / max |x| against plain lanes {d_p:.3g}, against the CPU {d_c:.3g}")
        check(all(launches[k] > 0 for k in FIT_KERNELS), f"17c {label} launched #1-#3")
        check(n_it[0] == n_it[1] == n_it[2] and d_p < REST_X_TOL and d_c < REST_X_TOL,
              f"17c {label}: the plain lanes' and the CPU's iterations and x")

    # The MAP samples: the card's own fit, then on the CPU fit's state
    card = fit(None, {})
    card.generate_map_samples()
    cl.reset_launch_counts()
    t0 = time.time()
    s_card = card.generate_map_samples(refresh=True)
    torch.cuda.synchronize()
    walls["map samples"] = time.time() - t0
    launches, routes = launch_counts(), dict(cl.QP_ROUTES)
    for k in FIT_KERNELS:
        total[k] += launches[k]
    n_s = len(s_card["lp"])
    print(f"rest 17c: generate_map_samples() on the card's fit: {n_s} pinned QPs of n = "
          f"{s_card['x'].shape[1]} in one batch, {walls['map samples']:.4f} s; launches "
          f"{launches}; QPs by route {routes}")
    check(all(launches[k] > 0 for k in FIT_KERNELS) and routes["library"] == 0,
          f"17c MAP samples through #1-#3: {launches} {routes}")
    check(np.all(np.isfinite(s_card["x"])) and np.all(s_card["lp"] <= s_card["lp_hat"] + 1e-7),
          "17c MAP samples finite, the refined MAP dominating")
    cpu = fit("cpu", {})
    s_cpu = cpu.generate_map_samples()
    q_cpu, m_cpu = cpu.get_parameter_quantile([0.025, 0.5, 0.975]), cpu.estimate_posterior_mean()
    real_inverse = drt_mod.mat1d.invert_psd
    drt_mod.mat1d.invert_psd = cpu_sigma_inverse(cpu)
    try:
        outs = {}
        for label, plain in (("kernels", False), ("plain lanes", True)):
            same = hybdrt_torch.DRT(warn=False).set_attributes(cpu.get_attributes())
            if plain:
                with PlainLanes():
                    s = same.generate_map_samples()
            else:
                s = same.generate_map_samples()
            outs[label] = (s, same.get_parameter_quantile([0.025, 0.5, 0.975]),
                           same.estimate_posterior_mean())
    finally:
        drt_mod.mat1d.invert_psd = real_inverse
    for ref_label, (s_ref, q_ref, m_ref) in (("the CPU", (s_cpu, q_cpu, m_cpu)),
                                             ("plain lanes", outs["plain lanes"])):
        s, q, m = outs["kernels"]
        d_x, d_q, d_m = dx(s["x"], s_ref["x"]), dx(q, q_ref), dx(m, m_ref)
        d_lp = float(np.max(np.abs(s["lp"] - s_ref["lp"]) / np.abs(s_ref["lp"])))
        print(f"  MAP samples on the CPU fit's state, the card's kernels against {ref_label}: "
              f"x {d_x:.3g}, lp {d_lp:.3g} rel, quantiles {d_q:.3g}, posterior mean {d_m:.3g}")
        check(d_x < REST_X_TOL and d_q < REST_X_TOL and d_m < REST_X_TOL
              and d_lp < REST_LP_RTOL, f"17c MAP samples against {ref_label}")

    # A serial map with the "detail" attributes, round-tripped through a file
    tau_s, obs = small_map("eis")
    md = DRTMD(tau_s, psi_dim_names=["T"], store_attr_categories=["config", "fit_core", "detail"],
               print_progress=False)
    for psi, c, e in obs[:3]:
        md.add_observation(psi, c, e, group_id="g")
    walls["serial map with detail"] = timed(lambda: md.fit_all())
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/detail.pkl"
        md.save_attributes(path)
        back = DRTMD.from_source(path)
    for i in range(md.num_obs):
        a, b = md.obs_fit_attr[i], back.obs_fit_attr[i]
        check({"qphb_history", "pfrt_result", "fit_matrices"} <= set(b) and b["pfrt_result"] is None
              and all(same_bits(a["fit_matrices"][k], b["fit_matrices"][k])
                      for k in ("impedance", "m0", "m1", "m2")),
              f"17c serial map observation {i}: the detail attributes round-trip")
    check(same_bits(back.obs_x, md.obs_x), "17c serial map round-trip: obs_x")
    print(f"rest 17c: serial map of {md.num_obs} observations with the detail attributes: fit "
          f"{walls['serial map with detail']:.3f} s; saved and read back, equal")
    return walls, total


def phase_item11():
    """Phase 17d: chrono options on het protocol 0's record (f64 on the card
    against the CPU): ``expdecay`` steps, ``downsample``, the three GP
    background modes; ``chrono_mode="pot"`` refused as the JAX package
    refuses it; and the ragged fitter's ``downsample`` fast path over the
    het leg's 256 hybrid observations (f64; its first ``REST_CPU_OBS`` on
    the CPU). Returns (walls, launches of #1-#3)."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl

    walls, total = {}, {k: 0 for k in FIT_KERNELS}
    obs, tau = make_het_hybrid()
    (times, i_sig, v), _ = obs[0]
    bkg = {"estimate_background_kw": {"gp_kw": {"n_grid": 4}}, "subtract_background": True}
    cases = {"expdecay": ({"step_model": "expdecay"}, {}),
             "downsample": ({}, {"downsample": True}),
             **{f"background {t}": ({}, dict(bkg, background_type=t))
                for t in ("static", "dynamic", "scaled")}}
    for label, (ctor, kw) in cases.items():
        cl.reset_launch_counts()
        card = hybdrt_torch.DRT(warn=False, **ctor)
        walls[label] = timed(lambda: card.fit_chrono(times, i_sig, v, **kw))
        launches = launch_counts()
        for k in FIT_KERNELS:
            total[k] += launches[k]
        cpu = hybdrt_torch.DRT(warn=False, device="cpu", **ctor).fit_chrono(times, i_sig, v, **kw)
        x, x_c = card.fit_parameters["x"], cpu.fit_parameters["x"]
        d = float(np.max(np.abs(x - x_c)) / np.max(np.abs(x_c)))
        it = (card.qphb_params["n_iter"], cpu.qphb_params["n_iter"])
        print(f"rest 17d: fit_chrono {label}, {len(card.get_fit_times())} of {len(times)} samples, "
              f"f64: {walls[label]:.3f} s (GP and prefit included); n_iter card / CPU {it}; "
              f"max |dx| / max |x| {d:.3g}; launches {launches}")
        check(it[0] == it[1] and d < REST_X_TOL, f"17d {label}: the CPU's iterations and x")
        check(all(launches[k] > 0 for k in FIT_KERNELS), f"17d {label} launched #1-#3")
    try:
        hybdrt_torch.DRT(chrono_mode="pot")
        raise RuntimeError("17d: chrono_mode='pot' was not refused")
    except ValueError as e:
        print(f"rest 17d: chrono_mode='pot' refused as in the JAX package: {e}")

    kw = dict(HET_KW, fit_kw={"downsample": True}, dtype=torch.float64)
    cl.reset_launch_counts()
    t0 = time.time()
    res = hybdrt_torch.BatchedRaggedFitter(tau, **kw).fit(obs)
    torch.cuda.synchronize()
    walls["ragged downsample"] = time.time() - t0
    launches = launch_counts()
    for k in FIT_KERNELS:
        total[k] += launches[k]
    n_ref = REST_CPU_OBS
    t0 = time.time()
    ref = hybdrt_torch.BatchedRaggedFitter(tau, device="cpu", **kw).fit(obs[:n_ref])
    t_cpu = time.time() - t0
    d = max(float(np.max(np.abs(res.x[k][:r - l] - ref.x[k][:r - l]))
                  / np.max(np.abs(ref.x[k][:r - l]))) for k, (l, r) in enumerate(ref.tau_indices))
    same_it = int(np.sum(res.n_iter[:n_ref] == ref.n_iter))
    n_times = np.array([len(c[0]) for c, _ in obs])
    print(f"rest 17d: ragged fit of the het leg's {len(obs)} hybrid observations with "
          f"downsample, f64: {walls['ragged downsample']:.3f} s (first call); chrono rows "
          f"{sorted(set(res.num_chrono.tolist()))} of {sorted(set(n_times.tolist()))} samples; "
          f"launches {launches}; the first {n_ref} on the CPU ({t_cpu:.2f} s): same n_iter "
          f"{same_it}/{n_ref}, max |dx| / max |x| {d:.3g}")
    check(np.all(res.num_chrono < n_times), "17d ragged: the chrono rows decimated")
    check(same_it == n_ref and d < REST_X_TOL, "17d ragged downsample: the CPU's n_iter and x")
    check(all(launches[k] > 0 for k in FIT_KERNELS), "17d ragged launched #1-#3")
    return walls, total


def phase_rest(het_md):
    """Phase 17 (17a-17d). Returns (walls, launches)."""
    t_phase = time.time()
    walls, launches = phase_fused_map(het_md)
    walls.update(phase_histories())
    w5, l5 = phase_item5()
    w11, l11 = phase_item11()
    walls.update(w5)
    walls.update(w11)
    for k in FIT_KERNELS:
        launches[k] += l5[k] + l11[k]
    print(f"rest: phase {time.time() - t_phase:.1f} s")
    return walls, launches


# Phase 18: the distribution of phasances (DOP). The main leg's spectra with
# a constant-phase term each (probe.make_dop_batch), n = 93 + 50 nu functions
DOP_N = 143
DOP_F64_B = 1024
# tests/f32_spread.py dop: the JAX package's own float32 DOP fit against its
# float64 fit on the same first 64 spectra, on a CPU (Rp median, p95 and max
# relative error, max |dR_inf|, the functional fit), the larger of its plain
# and fused fits' (fit(z)'s schedule; adaptive="staged" gives the same to
# three digits). R_inf moved by 2.24e-2 on the plain path and 2.43e-3 on the
# fused one there, by 1.35e-2 and 5.39e-3 in the port's own staged float32
# fits on the CPU, and by 2.91e-3 and 2.12e-2 in the card's: which path a
# lane's R_inf trades with the DOP on turns on rounding. The card's
# float32 fit is held to DOP_SPREAD_FACTOR times each against the CPU's
# float64 fit, as tests/test_f32_accuracy.py's bounds are about 3x its
# measured maxima. x_dop itself is not determined in float32 (the JAX
# package's moves by 4.3 max |x| there, trading mass with the DRT): it is
# reported and held finite
DOP_F32_SPREAD = dict(rp_median=3.055e-3, rp_p95=1.075e-2, rp_max=2.112e-2, r_inf=2.244e-2,
                      z=4.359e-3)
DOP_SPREAD_FACTOR = 3
# the share of lanes the plain DOP fit must converge (every one of the 64 in
# both precisions in the JAX package's fits of tests/f32_spread.py dop)
DOP_CONVERGED_FLOOR = 0.99
# 18c's single fits: the card's float64 fit against the CPU's, as phase 17
DOP_X_TOL = 1e-6
# 18d: the DOP het map's first observations rebuilt on the CPU, the
# observations its windowed f64 resolve takes, and its windows solved again
# on the CPU
DOP_CPU_OBS = 16
DOP_WINDOWED_OBS = 256
DOP_CPU_WINDOWS = 1
# the windows' x where the one-ulp spread is below it (16d's)
DOP_WINDOW_X_TOL = 1e-8


def dop_spread(fitter, res, ref, r64, z):
    """The card's float32 DOP fit ``res`` against the CPU's float64 ``r64``
    on the first 64 spectra of ``z``: {metric: value} on all 64 lanes, as
    tests/f32_spread.py dop measures the JAX package's, and the lanes that
    stop at the same iteration."""
    rp32, rp64 = fitter.predict_r_p(res)[:64], ref.predict_r_p(r64)
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)
    zrel = np.max(np.abs(fitter.predict_z(res)[:64] - ref.predict_z(r64)), axis=1) \
        / np.max(np.abs(z[:64]), axis=1)
    xmax = np.max(np.abs(r64.x), axis=1)
    return dict(rp_median=float(np.median(rel_rp)), rp_p95=float(np.percentile(rel_rp, 95)),
                rp_max=float(np.max(rel_rp)),
                r_inf=float(np.max(np.abs(res.r_inf[:64] - r64.r_inf))),
                z=float(np.max(zrel)),
                x_dop=float(np.max(np.max(np.abs(res.x_dop[:64] - r64.x_dop), axis=1) / xmax)),
                same=int(np.sum(res.n_iter[:64] == r64.n_iter)))


def phase_dop_slice(fused):
    """Phase 18a: ``BatchedEISFitter(fit_dop=True)`` on ``make_dop_batch(8192,
    71)`` (n = 143) in float32 with the bench's knobs, ``fit(adaptive=
    "staged", collect="lazy")`` twice, the counters reset before the second
    call. Returns (launches, wall, the first QP's #1-#3 inputs, the first
    warm QP's #5 inputs)."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane
    from hybdrt_torch.utils.probe import make_dop_batch

    label = "dop 18a " + ("fused" if fused else "plain")
    freq, z = make_dop_batch(B_BENCH, N_FREQ)
    kw = dict(FIT_KW, qp_fused=fused)
    fitter = hybdrt_torch.BatchedEISFitter(freq, fit_dop=True, dtype=torch.float32,
                                           device="cuda", **kw)
    check(fitter.rzm.shape[1] == DOP_N, f"{label}: n = {fitter.rzm.shape[1]}")
    with FirstKernelInputs() as first, FirstFusedInputs() as first_fused:
        first_s = timed(lambda: fitter.fit(z, adaptive="staged", collect="lazy"))
    cl.reset_launch_counts()
    ip_lane.reset_launch_counts()
    t0 = time.time()
    res = fitter.fit(z, adaptive="staged", collect="lazy")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**cl.LAUNCHES, **ip_lane.LAUNCHES}
    path = [*FIT_KERNELS, "ip_steps_lane"] if fused else FIT_KERNELS
    check(all(launches[k] > 0 for k in path), f"{label}: every kernel of the path launched")
    if fused:
        check(launches["ip_steps_lane"] <= int(res.n_iter.max()),
              f"{label}: ip_steps_lane at most once a pass")
    else:
        check(launches["ip_steps_lane"] == 0, f"{label}: the plain path does not fuse")
    check(bool(np.all(np.isfinite(res.x)) and np.all(np.isfinite(res.x_dop))
               and np.all(np.isfinite(res.r_inf))), f"{label}: finite x, x_dop and R_inf")
    med_rel = float(np.median(np.abs(fitter.predict_z(res) - z) / np.abs(z)))
    conv = int(res.converged.sum())
    print(f"{label}: B={B_BENCH} n={DOP_N} staged lazy f32: first call {first_s:.2f} s, second "
          f"call {wall:.4f} s -> {B_BENCH / wall:.1f} spectra/s; converged {conv}/{B_BENCH}; "
          f"median |z_hat - z|/|z| {med_rel:.4g}; n_iter p50/p90/max "
          f"{np.percentile(res.n_iter, [50, 90, 100]).tolist()}; launches {launches}")
    check(med_rel < 0.02, f"{label}: median relative residual {med_rel}")
    if not fused:
        check(conv >= DOP_CONVERGED_FLOOR * B_BENCH, f"{label}: converged {conv}/{B_BENCH}")

    ref = hybdrt_torch.BatchedEISFitter(freq, fit_dop=True, dtype=torch.float64, device="cpu",
                                        **kw)
    t0 = time.time()
    r64 = ref.fit(z[:64], adaptive="staged")
    got = dop_spread(fitter, res, ref, r64, z)
    jax_f32 = DOP_F32_SPREAD
    print(f"  f32 card vs f64 CPU, 64 spectra (CPU fit {time.time() - t0:.1f} s; "
          f"{got['same']} lanes at the same iteration): "
          + ", ".join(f"{k} {got[k]:.3g} (JAX f32 {jax_f32[k]:.3g})" for k in jax_f32)
          + f"; max |dx_dop| / max |x| {got['x_dop']:.3g}, reported")
    for k, v in jax_f32.items():
        check(got[k] <= DOP_SPREAD_FACTOR * v,
              f"{label}: {k} {got[k]:.3g} within {DOP_SPREAD_FACTOR}x the JAX package's own "
              f"float32 spread {v:.3g}")
    return launches, wall, first, first_fused.inputs


def phase_dop_kernels(first32, fused_inputs):
    """Phase 18b: #1-#5 against their plain versions at n = 143 on a DOP
    fit's systems: #1-#3 on the plain fit's first QP at (8192, 143) in f32
    and on a float64 fit's at (1024, 143), each held as phase 12 holds them
    (TOL and the backward errors); #4 on the first Mehrotra step's system in
    both precisions; #5 on the fused fit's first warm QP in both precisions
    (``hold_fused_steps``); each kernel, its plain version and its library
    call timed at (8192, 143) f32. Returns ({kernel: max abs err of #1-#4},
    {kernel: timing dict})."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane
    from hybdrt_torch.utils.probe import make_dop_batch

    errs = hold_first_qp("DOP f32", first32)
    freq, z = make_dop_batch(B_BENCH, N_FREQ)
    f64 = hybdrt_torch.BatchedEISFitter(freq, fit_dop=True, dtype=torch.float64, device="cuda",
                                        **dict(FIT_KW, max_iter=1))
    with FirstKernelInputs() as first64:
        f64.fit(z[:DOP_F64_B])
    check(tuple(first64.inputs["chol_factor_solve_lane"][0].shape) == (DOP_F64_B, DOP_N, DOP_N),
          "18b float64 first QP at (1024, 143)")
    for k, e in hold_first_qp("DOP f64", first64).items():
        errs[k] = max(errs[k], e)
    errs["chol_factor_lane"] = 0.0
    for label, inp in (("f32", first32.inputs), ("f64", first64.inputs)):
        h = inp["chol_factor_solve_lane"][0]
        h_in = h.clone()
        l, l_p = cl.chol_factor_lane(h), cl.chol_factor_lane_plain(h)
        d = (torch.tril(l) - l_p).abs()
        check(bool(torch.all(d <= TOL + TOL * l_p.abs())) and bool(torch.equal(h, h_in)),
              f"18b chol_factor_lane {label}: err {float(d.max())}, input unchanged")
        errs["chol_factor_lane"] = max(errs["chol_factor_lane"], float(d.max()))
        print(f"  chol_factor_lane vs plain on the first DOP QP's system {tuple(h.shape)} "
              f"{label}: max abs err {float(d.max()):.3g}")
    # held by the plain steps' own float32 spread on these systems, not by
    # TOL, as phases 13 and 17 hold #5 on a fit's QPs
    hold_fused_steps("DOP 18b", fused_inputs)
    steps = fused_inputs[6]

    h, rhs = first32.inputs["chol_factor_solve_lane"]
    l, r2 = first32.inputs["chol_solve_factored_lane"]
    b, n = rhs.shape
    mat, vec, low = h.numel() * 4, rhs.numel() * 4, lower_bytes(b, n)
    l_p = cl.chol_factor_lane_plain(h)
    turns = in_turns({"chol_factor_solve_lane": lambda: cl.chol_factor_solve_lane(h, rhs),
                      "chol_solve_lane": lambda: cl.chol_solve_lane(h, rhs),
                      "chol_solve_factored_lane": lambda: cl.chol_solve_factored_lane(l, r2),
                      "chol_factor_lane": lambda: cl.chol_factor_lane(h)})
    times = {
        "chol_factor_solve_lane": dict(
            ms=float(np.mean(turns["chol_factor_solve_lane"])),
            plain_ms=cuda_ms(lambda: cl.chol_factor_solve_lane_plain(h, rhs)), library_ms=None,
            bound=bound(2 * mat + 2 * vec, chol_ops(b, n) + 2 * solve_ops(b, n))),
        "chol_solve_factored_lane": dict(
            ms=float(np.mean(turns["chol_solve_factored_lane"])),
            plain_ms=cuda_ms(lambda: cl.chol_solve_factored_lane_plain(l_p, r2)),
            library_ms=cuda_ms(lambda: torch.cholesky_solve(r2[:, :, None], l_p)),
            bound=bound(low + 2 * vec, 2 * solve_ops(b, n))),
        "chol_solve_lane": dict(
            ms=float(np.mean(turns["chol_solve_lane"])),
            plain_ms=cuda_ms(lambda: cl.chol_solve_lane_plain(h, rhs)),
            library_ms=cuda_ms(lambda: torch.linalg.solve(h, rhs)),
            bound=bound(low + 2 * vec, chol_ops(b, n) + 2 * solve_ops(b, n))),
        "chol_factor_lane": dict(
            ms=float(np.mean(turns["chol_factor_lane"])),
            plain_ms=cuda_ms(lambda: cl.chol_factor_lane_plain(h)),
            library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(h)),
            bound=bound(2 * mat, chol_ops(b, n))),
    }
    args = fused_inputs[:6]
    bf = args[0].shape[0]
    times["ip_steps_lane"] = dict(
        ms=cuda_ms(lambda: ip_lane.ip_steps_lane(*args, steps)),
        plain_ms=cuda_ms(lambda: ip_lane.ip_steps_lane_plain(*args, steps)), library_ms=None,
        bound=ip_steps_bound(bf, n, steps))
    for k, t in times.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        shape = f"B={bf}, {steps} steps" if k == "ip_steps_lane" else f"B={b}"
        print(f"  DOP {k}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {lib}, "
              f"bound {t['bound'][0]:.4f} ms by {t['bound'][1]} ({shape}, n={n}, f32, the "
              f"first DOP QP's systems, CUDA events, mean of 20)")
    return errs, times


def dop_spectra():
    """18c's spectra: tests/test_parallel.py:292's and
    tests/test_edge_cases.py:118's, and a ZARC with a series 1 F capacitor."""
    rng = np.random.default_rng(0)
    f1 = np.logspace(5, -2, 51)
    w = 2j * np.pi * f1
    z1 = 0.4 + 1.0 / (1 + (w * 1e-2) ** 0.9) + 0.05 * (w ** -0.5)
    z1 = z1 + rng.normal(0, 1e-3, 51) + 1j * rng.normal(0, 1e-3, 51)
    rng = np.random.default_rng(8)
    f2 = np.logspace(5, -1, 51)
    z2 = 0.4 + 1.0 / (1 + (2j * np.pi * f2 * 1e-2) ** 0.9) + 2j * np.pi * f2 * 1e-6
    z2 = z2 + rng.normal(0, 1e-3, 51) + 1j * rng.normal(0, 1e-3, 51)
    rng = np.random.default_rng(5)
    f3 = np.logspace(5, -1, 41)
    w = 2j * np.pi * f3
    z3 = 0.4 + 1.0 / (1 + (w * 1e-3) ** 0.9) + 1 / w
    z3 = z3 + rng.normal(0, 1e-3, 41) + 1j * rng.normal(0, 1e-3, 41)
    return {"parallel": (f1, z1), "inductive": (f2, z2), "capacitive": (f3, z3)}


def phase_dop_single():
    """Phase 18c: ``DRT(fit_dop=True).fit_eis`` in float64 on the card on
    tests/test_parallel.py:292's and tests/test_edge_cases.py:118's spectra,
    ``fit_capacitance`` on a capacitive one and ``fit_hybrid(fit_dop=True)``
    on hybrid_data's record, each against the CPU's fit (the same n_iter, x
    and x_dop within DOP_X_TOL of max |x|), with ``predict_dop`` and
    ``predict_dop_ci`` finite and the card's within the fit tolerance of the
    CPU's. Returns ({label: warm wall}, launches of #1-#3)."""
    import hybdrt_torch
    from hybdrt_torch.ops import basis as basis_mod, chol_lane as cl

    walls, total = {}, {k: 0 for k in FIT_KERNELS}
    spectra = dop_spectra()
    cases = {"dop parallel": ({"fit_dop": True}, "eis", spectra["parallel"]),
             "dop inductive": ({"fit_dop": True}, "eis", spectra["inductive"]),
             "capacitance": ({"fit_capacitance": True}, "eis", spectra["capacitive"]),
             "dop hybrid": ({"fit_dop": True}, "hybrid", hybrid_data())}

    def fit(device, ctor, kind, data):
        drt = hybdrt_torch.DRT(warn=False, device=device, **ctor)
        return drt.fit_eis(*data) if kind == "eis" else drt.fit_hybrid(*data)

    for label, (ctor, kind, data) in cases.items():
        fit(None, ctor, kind, data)
        cl.reset_launch_counts()
        t0 = time.time()
        card = fit(None, ctor, kind, data)
        torch.cuda.synchronize()
        walls[label] = time.time() - t0
        launches = launch_counts()
        for k in FIT_KERNELS:
            total[k] += launches[k]
        cpu = fit("cpu", ctor, kind, data)
        xm = float(np.max(np.abs(cpu.fit_parameters["x"])))
        keys = [k for k in ("x", "x_dop", "C_inv", "R_inf") if k in cpu.fit_parameters]
        dx = {k: float(np.max(np.abs(np.asarray(card.fit_parameters[k])
                                     - np.asarray(cpu.fit_parameters[k])))) / xm for k in keys}
        n_it = (card.qphb_params["n_iter"], cpu.qphb_params["n_iter"])
        line = (f"dop 18c: {label} ({kind}, n = {card.qphb_params['p_matrix'].shape[0]}) f64 "
                f"on the card {walls[label]:.4f} s warm; launches {launches}; n_iter card / CPU "
                f"{n_it}; max |d| / max |x| " + ", ".join(f"{k} {v:.3g}" for k, v in dx.items()))
        if card.fit_dop:
            dop, (lo, hi) = card.predict_dop(), card.predict_dop_ci()
            d_dop = float(np.max(np.abs(dop - cpu.predict_dop()))) / xm
            # a linear map of x_dop: its rows' |entries| summed carry x_dop's
            # tolerance
            em = basis_mod.func_eval_matrix_host(card.basis_nu, np.linspace(-1, 1, 201),
                                                 card.nu_basis_type, card.nu_epsilon, 0)
            gain = float(np.max(np.sum(np.abs(em), axis=1)))
            line += f"; predict_dop max |d| / max |x| {d_dop:.3g}"
            check(np.all(np.isfinite(dop)) and np.all(np.isfinite(lo)) and np.all(hi >= lo),
                  f"18c {label}: predict_dop and predict_dop_ci finite, ordered")
            check(d_dop < gain * DOP_X_TOL, f"18c {label}: predict_dop against the CPU's")
        print(line)
        check(all(launches[k] > 0 for k in FIT_KERNELS), f"18c {label} launched #1-#3")
        check(n_it[0] == n_it[1] and max(dx.values()) < DOP_X_TOL,
              f"18c {label}: the CPU's iterations and coefficients")
    return walls, total


def phase_dop_map():
    """Phase 18d: ``make_het_map(768, 256, fit_dop=True)`` through DRTMD on
    the card: ``fit_all(batched=True, float32)`` (both halves through the
    ragged fitter, padded n = 144), phase 14's guards (every observation
    fitted, finite, rss >= 0, finite llh; the rebuild on the card against
    the CPU's on the first observations), ``resolve_group`` coupled in f32 on
    the whole map and windowed in f64 on its first DOP_WINDOWED_OBS
    observations (finite, x_dop resolved, #4 and #2 launched, the coupled
    KKT within tolerance, DOP_CPU_WINDOWS windows at the CPU's iterations
    and x within DOP_SPREAD_FACTOR times their spread under a one-ulp move
    of P),
    ``predict_dop`` finite. Returns
    ({label: launches}, {label: wall})."""
    import warnings
    from hybdrt_torch.mapping.drtmd import STATE_KEYS, load_fit_state
    from hybdrt_torch.ops import chol_lane as cl
    from hybdrt_torch.utils.probe import make_het_map

    launches, walls = {}, {}
    md = make_het_map(768, 256, fit_dop=True)
    first = timed(lambda: md.fit_all(batched=True, dtype=torch.float32))
    cl.reset_launch_counts()
    walls["fit_all"] = timed(lambda: md.fit_all(refit=True, batched=True, dtype=torch.float32))
    launches["fit_all"] = dict(cl.LAUNCHES)
    fitters = {type(f).__name__ for f in md._fitter_cache.values()}
    n_pad = sorted(f._uniq["rzm"].shape[-1] for f in md._fitter_cache.values())
    n = md.num_obs
    n_iter = np.array([a["n_iter"] for a in md.obs_fit_attr])
    print(f"dop 18d: DRTMD(fit_dop=True).fit_all(batched=True, float32) of {n} observations: "
          f"first call {first:.3f} s, refit {walls['fit_all']:.4f} s; fitters {sorted(fitters)}, "
          f"padded n {n_pad}; n_iter mean {n_iter.mean():.2f}; launches "
          f"{launches['fit_all']}")
    check(fitters == {"BatchedRaggedFitter"}, "18d: both halves through the ragged fitter")
    check(bool(md.obs_fit_status.all()), f"18d: {int(md.obs_fit_status.sum())}/{n} fitted")
    check(bool(np.all(np.isfinite(md.obs_x)) and np.all(np.isfinite(md.obs_special["x_dop"]))
               and np.all(md.obs_rss >= 0) and np.all(np.isfinite(md.obs_llh))),
          "18d: finite x and x_dop, rss >= 0, finite llh")
    check(all(launches["fit_all"][k] > 0 for k in FIT_KERNELS), "18d fit_all launched #1-#3")

    sub = np.arange(DOP_CPU_OBS)
    fits = md.get_fits_batched(sub)
    cpu = load_fit_state(make_het_map(768, 256, device="cpu", fit_dop=True),
                         {k: getattr(md, k) for k in STATE_KEYS})
    cpu_fits = cpu.get_fits_batched(sub)
    dpq = max(float(np.max(np.abs(fits[i].fit_parameters[k] - cpu_fits[i].fit_parameters[k]))
                    / np.max(np.abs(cpu_fits[i].fit_parameters[k])))
              for i in sub for k in ("p_matrix", "q_vector"))
    print(f"dop 18d: the first {len(sub)} (P, q) rebuilt on the card against the CPU: max "
          f"|d(P, q)| / max |(P, q)| {dpq:.3g}")
    check(dpq < 1e-9, f"18d rebuild on the card within 1e-9 of the CPU's: {dpq}")

    # the coupled f32 resolve of the whole map, and the windowed f64 resolve
    # of its first DOP_WINDOWED_OBS observations (as 16d resolves phase 14's
    # map), its windows captured; each form runs once, its counters reset
    from hybdrt_torch.mapping import resolve as resolve_mod
    captured, real = [], resolve_mod.solve_resolve_batch

    def capture(systems, **kw):
        out = real(systems, **kw)
        captured.append((systems, kw, out))
        return out

    groups = list(md.obs_group_id)
    forms = {"coupled f32": (dict(coupled=True, dtype=torch.float32), n),
             "windowed f64": (dict(batched=True, dtype=torch.float64), DOP_WINDOWED_OBS)}
    for label, (kw, n_obs) in forms.items():
        md.obs_group_id = ["g" if i < n_obs else "rest" for i in range(n)]
        resolve_mod.solve_resolve_batch = capture
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                cl.reset_launch_counts()
                walls[label] = timed(lambda: md.resolve_group("g", psi_sort_dims=["i"], **kw))
        finally:
            md.obs_group_id = groups
            resolve_mod.solve_resolve_batch = real
        launches[label] = dict(cl.LAUNCHES)
        info = md.resolve_info
        n_it = np.atleast_1d(info["n_iter"])
        moved = float(np.max(np.abs(md.obs_special_resolved["x_dop"][:n_obs]
                                    - md.obs_special["x_dop"][:n_obs])))
        print(f"dop 18d: resolve {label} of {n_obs} observations: {walls[label]:.4f} s (the "
              f"first call); IP iterations max {int(n_it.max())}"
              + (f", KKT residual {info['kkt_residual']:.4g} (tolerance {info['kkt_tol']:.4g})"
                 if info["coupled"] else f" median {np.median(n_it):.0f} over "
                 f"{info['windows']} windows")
              + f"; x_dop moved by up to {moved:.3g}; launches {launches[label]}")
        check(not caught, f"18d resolve {label}: no warning ({[str(w.message) for w in caught]})")
        check(launches[label]["chol_factor_lane"] > 0
              and launches[label]["chol_solve_factored_lane"] > 0,
              f"18d resolve {label} launched #4 and #2")
        check(bool(np.all(np.isfinite(md.obs_x_resolved[:n_obs]))
                   and np.all(np.isfinite(md.obs_special_resolved["x_dop"][:n_obs]))),
              f"18d resolve {label}: finite x and x_dop")
        if info["coupled"]:
            check(info["kkt_residual"] <= info["kkt_tol"], f"18d {label}: KKT within tolerance")
    check(len(captured) == 1, "18d the windowed resolve solved its windows in one batch")
    # the window(s) that took the card fewest iterations solved again on the
    # CPU (the windows of a batch are independent), and on the card with P
    # moved one ulp (ULP_SEEDS): the card's x is held within
    # DOP_SPREAD_FACTOR times the spread of that move, or DOP_WINDOW_X_TOL
    systems, kw, (xs, info) = captured[0]
    order = np.argsort(info["n_iter"], kind="stable")[:DOP_CPU_WINDOWS]
    chosen = [systems[i] for i in order]
    k = len(chosen)
    moved_p = [(one_ulp(torch.as_tensor(p), seed).numpy(), *rest)
               for seed in ULP_SEEDS for p, *rest in chosen]
    x_moved, _ = real(chosen + moved_p, **kw)

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    spread = max(rel(x_moved[k + j], x_moved[j % k]) for j in range(len(moved_p)))
    bound = max(DOP_WINDOW_X_TOL, DOP_SPREAD_FACTOR * spread)
    t0 = time.time()
    xc, info_c = real(chosen, **dict(kw, device="cpu"))
    same = [int(info["n_iter"][i]) == int(info_c["n_iter"][j]) for j, i in enumerate(order)]
    dxs = [rel(xs[i], xc[j]) for j, i in enumerate(order)]
    print(f"  window(s) {order.tolist()} on the CPU ({time.time() - t0:.2f} s): IP iterations "
          f"card {[int(info['n_iter'][i]) for i in order]}, CPU {info_c['n_iter'].tolist()}; "
          f"max |dx| / max |x| {max(dxs):.3g}, the card's spread with P moved one ulp "
          f"{spread:.3g} (bound {bound:.3g})")
    check(all(same) and max(dxs) <= bound,
          "18d windows at the CPU's iterations, x within the one-ulp spread")
    dop = md.predict_dop()
    check(dop.shape == (n, 201) and bool(np.all(np.isfinite(dop))), "18d predict_dop finite")
    return launches, walls


def phase_dop():
    """Phase 18 (18a-18d). Returns (walls, {kernel: launches}, {kernel: max
    abs err}, {kernel: timing at n = 143})."""
    t_phase = time.time()
    launches = {k: 0 for k in (*FIT_KERNELS, "ip_steps_lane", "chol_factor_lane")}
    walls = {}
    l_plain, walls["plain B=8192"], first32, _ = phase_dop_slice(fused=False)
    l_fused, walls["fused B=8192"], _, fused_inputs = phase_dop_slice(fused=True)
    for counts in (l_plain, l_fused):
        for k in launches:
            launches[k] += counts.get(k, 0)
    errs, times = phase_dop_kernels(first32, fused_inputs)
    w_single, l_single = phase_dop_single()
    walls.update(w_single)
    map_launches, w_map = phase_dop_map()
    walls.update({f"map {k}": w for k, w in w_map.items()})
    for counts in [l_single, *map_launches.values()]:
        for k in launches:
            launches[k] += counts.get(k, 0)
    print(f"dop: phase {time.time() - t_phase:.1f} s; launches {launches}")
    return walls, launches, errs, times


# Phase 19: the other tau bases, and ragged fits above the lane kernels'
# tile rule. (a)'s single fits, float64 on the card against the CPU's:
# ctor keywords, data
BASIS_CASES = {
    "delta eis": ({"tau_basis_type": "delta"}, "eis"),
    "Cole-Cole 0.95 eis": ({"tau_basis_type": "Cole-Cole", "tau_epsilon": 0.95}, "eis"),
    "Cole-Cole default eis": ({"tau_basis_type": "Cole-Cole"}, "eis"),
    "gaussian trapz eis": ({"interpolate_integrals": False}, "eis"),
    "Cole-Cole 0.95 chrono": ({"tau_basis_type": "Cole-Cole", "tau_epsilon": 0.95}, "chrono"),
    "delta chrono": ({"tau_basis_type": "delta"}, "chrono"),
    "delta hybrid": ({"tau_basis_type": "delta"}, "hybrid"),
}
BASIS_X_TOL = 1e-8
# (b): the main leg's padded n on its basis. Phase 5's bounds, and the JAX
# package's own float32 spread on the first 64 delta-basis systems, each
# path's (tests/f32_spread.py delta, "jax plain" and "jax fused": the Rp
# median and p95 and the functional fit on all lanes, the Rp max and R_inf
# on the lanes that stop at the same iteration), where phase 5's bound is
# below DELTA_SPREAD_FACTOR times it, as phase 18a holds the DOP fit
MAIN_N = 93
PHASE5_BOUNDS = dict(rp_median=1e-3, rp_p95=3e-3, z=1.5e-2, rp_max=5e-3, r_inf=5e-3)
DELTA_F32_SPREAD = {
    "plain": dict(rp_median=1.068e-4, rp_p95=1.068e-3, z=5.192e-4, rp_max=6.238e-3,
                  r_inf=8.162e-3),
    "fused": dict(rp_median=7.549e-5, rp_p95=1.140e-3, z=5.300e-4, rp_max=5.338e-3,
                  r_inf=6.975e-3)}
DELTA_SPREAD_FACTOR = 3
# (c): the het leg's EIS spectra on a supergrid of 40 points a decade, and
# the lanes held against the CPU's float64 fit (16 lanes take 28 s there,
# beside phase 19's 60 s)
WIDE_TAU = np.logspace(-8, 3, 441)
WIDE_CPU_LANES = 8


def basis_fit(device, ctor, kind, data):
    import hybdrt_torch

    (times, i_sig, v), (freq, z) = data
    drt = hybdrt_torch.DRT(warn=False, device=device, **ctor)
    if kind == "eis":
        return drt.fit_eis(freq, z)
    if kind == "chrono":
        return drt.fit_chrono(times, i_sig, v)
    return drt.fit_hybrid(times, i_sig, v, freq, z)


def phase_bases_single():
    """Phase 19a: single fits of the other bases on ``basis_probe``'s
    spectrum and record, float64 on the card (B = 1, #1-#3), each against
    the port's fit on the CPU: the same n_iter and x within BASIS_X_TOL of
    max |x|. Returns ({label: wall}, {kernel: launches})."""
    from hybdrt_torch.ops import chol_lane as cl
    from hybdrt_torch.utils.probe import basis_probe

    data = basis_probe()
    walls, total = {}, {k: 0 for k in FIT_KERNELS}
    for label, (ctor, kind) in BASIS_CASES.items():
        cl.reset_launch_counts()
        t0 = time.time()
        card = basis_fit(None, ctor, kind, data)
        torch.cuda.synchronize()
        walls[label] = time.time() - t0
        launches = launch_counts()
        for k in FIT_KERNELS:
            total[k] += launches[k]
        cpu = basis_fit("cpu", ctor, kind, data)
        x, x_ref = card.fit_parameters["x"], cpu.fit_parameters["x"]
        dx = float(np.max(np.abs(x - x_ref)) / np.max(np.abs(x_ref)))
        n_it = (card.qphb_params["n_iter"], cpu.qphb_params["n_iter"])
        print(f"bases 19a: {label} ({card.tau_basis_type}, epsilon {card.tau_epsilon:.4g}, "
              f"{card.integrate_method}), f64 on the card, n = "
              f"{card.qphb_params['p_matrix'].shape[0]}: {walls[label]:.4f} s (first call); "
              f"n_iter card / CPU {n_it}; Rp {card.predict_r_p():.6g}; max |dx| / max |x| "
              f"{dx:.3g}")
        print(f"bases 19a: {label} launches {launches}")
        check(bool(np.all(np.isfinite(x))), f"19a {label}: finite x")
        check(all(launches[k] > 0 for k in FIT_KERNELS), f"19a {label} launched #1-#3")
        check(n_it[0] == n_it[1] and dx < BASIS_X_TOL,
              f"19a {label}: the CPU's iterations and coefficients ({dx:.3g})")
    return walls, total


def ragged_holds(label, fitter, res, ref, r64, n_lanes, area, same_only, bounds=None):
    """``bounds`` (phase 5's by default) on a ragged fit's first ``n_lanes``
    lanes, float32 ``res`` against float64 ``r64``: the Rp median and p95 and
    the functional fit on all of them; the Rp max and R_inf on the lanes
    that stop at the same iteration (``same_only``) or on all."""
    bounds = PHASE5_BOUNDS if bounds is None else bounds
    rp32 = np.sum(np.abs(res.x[:n_lanes]), axis=1) * area
    rp64 = np.sum(np.abs(r64.x[:n_lanes]), axis=1) * area
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)
    d_rinf = np.abs(res.r_inf[:n_lanes] - r64.r_inf[:n_lanes])
    y32, y64 = fitter.final_predictions(res)[:n_lanes], ref.final_predictions(r64)[:n_lanes]
    rows = res.num_rows[:n_lanes]
    zrel = [np.max(np.abs(y32[k, :r] - y64[k, :r])) / np.max(np.abs(y64[k, :r]))
            for k, r in enumerate(rows)]
    same = res.n_iter[:n_lanes] == r64.n_iter[:n_lanes]
    held = same if same_only else np.ones(n_lanes, dtype=bool)
    print(f"  {label}: f32 against f64 on {n_lanes} lanes: Rp rel err median "
          f"{np.median(rel_rp):.3g} p95 {np.percentile(rel_rp, 95):.3g} max {np.max(rel_rp):.3g}, "
          f"max |dR_inf| {np.max(d_rinf):.3g}; functional fit max {max(zrel):.3g}; "
          f"{int(same.sum())} lanes at the same n_iter; Rp max and R_inf held on "
          f"{int(held.sum())} lanes: {np.max(rel_rp[held]):.3g}, {np.max(d_rinf[held]):.3g}")
    got = dict(rp_median=np.median(rel_rp), rp_p95=np.percentile(rel_rp, 95), z=max(zrel),
               rp_max=np.max(rel_rp[held]), r_inf=np.max(d_rinf[held]))
    check(held.sum() >= min(16, n_lanes), f"{label}: {int(held.sum())} lanes held")
    for k, v in got.items():
        check(v < bounds[k], f"{label}: {k} {v:.4g} < {bounds[k]:.4g}")


def phase_bases_batch():
    """Phase 19b: ``make_batch(8192, 71)`` as delta-basis EIS systems on the
    main leg's basis (``probe.eis_systems``: one system that
    ``DRT(tau_basis_type="delta")`` prepares, each spectrum's own scaled
    data vector) through ``BatchedRaggedFitter.from_systems`` in float32 with
    the benchmark's knobs, plain and fused: a first call of each (the first
    QP's #1-#3 and first warm QP's #5 inputs kept), then two timed calls of
    each in turns, the counters reset before each; #1-#3 and #5 against
    their plain versions on those inputs; the first 64 lanes against a
    float64 fit on the card, the Rp max and R_inf on the lanes that stop at
    the same iteration, each path within the larger of phase 5's bound and
    DELTA_SPREAD_FACTOR times the JAX package's own float32 spread of that
    path on these systems (``DELTA_F32_SPREAD``). Returns ({label: wall}, {kernel: launches},
    {kernel: max abs err})."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane
    from hybdrt_torch.utils.probe import eis_systems

    freq, z = make_batch(B_BENCH, N_FREQ)
    drt = hybdrt_torch.DRT(tau_basis_type="delta", warn=False, device="cpu")
    t0 = time.time()
    systems = eis_systems(drt, freq, z)
    prep = time.time() - t0
    n = systems[0]["rzm"].shape[1]
    print(f"bases 19b: {B_BENCH} delta-basis EIS systems, n = {n} (the main leg's {MAIN_N}), "
          f"prepared in {prep:.3f} s")
    check(n == MAIN_N, f"19b n = {n}")
    fitters = {fused: hybdrt_torch.BatchedRaggedFitter.from_systems(
        systems, drt.basis_tau, dtype=torch.float32, qp_fused=fused, **FIT_KW)
        for fused in (False, True)}
    firsts = {}
    for fused, fitter in fitters.items():
        with FirstKernelInputs() as first, FirstFusedInputs() as first_fused:
            res = fitter.fit(adaptive="staged")
        torch.cuda.synchronize()
        firsts[fused] = (first, first_fused.inputs, res)
    walls, launches = {}, {}
    for turn in range(2):
        for fused, fitter in fitters.items():
            label = "fused" if fused else "plain"
            cl.reset_launch_counts()
            ip_lane.reset_launch_counts()
            t0 = time.time()
            res = fitter.fit(adaptive="staged")
            torch.cuda.synchronize()
            walls.setdefault(label, []).append(time.time() - t0)
            launches[label] = {**launch_counts(), **ip_lane.LAUNCHES}
    for fused in (False, True):
        label = "fused" if fused else "plain"
        res = firsts[fused][2]
        print(f"bases 19b: delta batch {label} f32, B={B_BENCH} n={n}: second and third calls "
              f"{walls[label][0]:.4f}, {walls[label][1]:.4f} s (in turns); converged "
              f"{int(res.converged.sum())}/{B_BENCH}; n_iter mean {res.n_iter.mean():.2f}")
        print(f"bases 19b: delta batch {label} launches {launches[label]}")
        path = [*FIT_KERNELS, "ip_steps_lane"] if fused else FIT_KERNELS
        check(all(launches[label][k] > 0 for k in path), f"19b {label}: #1-#3 (and #5) launched")
        if not fused:
            check(launches[label]["ip_steps_lane"] == 0, "19b plain: no fused steps")
        check(bool(np.all(np.isfinite(res.x_raw))), f"19b {label}: finite coefficients")
    errs = hold_first_qp("19b delta", firsts[False][0])
    hold_fused_steps("19b delta", firsts[True][1])
    for fused in (False, True):
        label = "fused" if fused else "plain"
        delta_bounds = {k: max(v, DELTA_SPREAD_FACTOR * DELTA_F32_SPREAD[label][k])
                        for k, v in PHASE5_BOUNDS.items()}
        print(f"  19b {label} bounds: "
              + ", ".join(f"{k} {v:.4g}" for k, v in delta_bounds.items()))
        ref = hybdrt_torch.BatchedRaggedFitter.from_systems(
            systems[:64], drt.basis_tau, dtype=torch.float64, qp_fused=fused, **FIT_KW)
        r64 = ref.fit(adaptive="staged")
        ragged_holds(f"19b delta {label}", fitters[fused], firsts[fused][2], ref, r64, 64, 1.0,
                     same_only=True, bounds=delta_bounds)
    return {f"delta batch {k}": min(w) for k, w in walls.items()}, \
        {k: launches["plain"][k] + launches["fused"][k]
         for k in (*FIT_KERNELS, "ip_steps_lane")}, errs


def wide_card_fits():
    """Phase 19c's card part: the het leg's 768 EIS spectra on WIDE_TAU (40
    points a decade), padded n above the lane kernels' float32 tile rule,
    through ``BatchedRaggedFitter`` in float32 with the het leg's knobs,
    plain and fused, one call each with the counters reset before it: every
    QP on the library route, the fused fit's warm QPs on the plain steps
    (``fused_plain``), and no lane-kernel launch. Returns (observations,
    {label: (fitter, result)}, {label: wall})."""
    import hybdrt_torch
    from hybdrt_torch.ops import chol_lane as cl, ip_lane, qp

    obs, _ = make_het_eis()
    fits, walls = {}, {}
    for fused in (False, True):
        label = "fused" if fused else "plain"
        fitter = hybdrt_torch.BatchedRaggedFitter(WIDE_TAU, dtype=torch.float32, qp_fused=fused,
                                                  **HET_KW)
        cl.reset_launch_counts()
        ip_lane.reset_launch_counts()
        t0 = time.time()
        res = fitter.fit(obs, adaptive="staged")
        torch.cuda.synchronize()
        walls[f"wide {label}"] = time.time() - t0
        routes, lane = dict(cl.QP_ROUTES), {**launch_counts(), **ip_lane.LAUNCHES}
        n = res.x_raw.shape[1]
        print(f"bases 19c: {len(obs)} het EIS spectra on {len(WIDE_TAU)} taus, {label} f32, "
              f"padded n = {n}: {walls[f'wide {label}']:.4f} s (first call); n_iter mean "
              f"{res.n_iter.mean():.2f}")
        print(f"bases 19c: wide {label} QP routes {routes}; lane kernel launches {lane}")
        check(not cl.admitted(n, torch.float32), f"19c n = {n} above the tile rule")
        check(qp.fused_route(n, torch.float32) == "fused_plain", "19c fused route plain")
        check(routes["library"] > 0 and routes["lane"] == 0, f"19c {label}: library route")
        check((routes["fused_plain"] > 0) == fused, f"19c {label}: fused_plain routes")
        check(all(v == 0 for v in lane.values()), f"19c {label}: no lane kernel launched")
        check(bool(np.all(np.isfinite(res.x_raw))), f"19c {label}: finite coefficients")
        fits[label] = (fitter, res)
    return obs, fits, walls


def wide_cpu_refs(obs):
    """Phase 19c's references: the port's float64 fits of the first
    WIDE_CPU_LANES observations on the CPU, plain and fused, {label:
    (fitter, result, seconds)}."""
    import hybdrt_torch

    refs = {}
    for fused in (False, True):
        t0 = time.time()
        ref = hybdrt_torch.BatchedRaggedFitter(WIDE_TAU, dtype=torch.float64, device="cpu",
                                               qp_fused=fused, **HET_KW)
        r64 = ref.fit(obs[:WIDE_CPU_LANES], adaptive="staged")
        refs["fused" if fused else "plain"] = (ref, r64, time.time() - t0)
    return refs


def wide_holds(fits, refs):
    """Phase 19c's holds: the first WIDE_CPU_LANES lanes of each card fit
    against the CPU's float64 fit within phase 5's bounds."""
    from hybdrt_torch.ops import basis

    area = basis.get_basis_func_area("gaussian", 1 / np.mean(np.diff(np.log(WIDE_TAU))))
    for label, (fitter, res) in fits.items():
        ref, r64, secs = refs[label]
        print(f"  19c: the CPU's f64 {label} fit of {WIDE_CPU_LANES} lanes {secs:.1f} s")
        ragged_holds(f"19c wide {label}", fitter, res, ref, r64, WIDE_CPU_LANES, area,
                     same_only=False)


def phase_bases():
    """Phase 19: 19c's card fits first, while no other fit moves the QP
    route counts, then their CPU references and holds, then 19a and 19b,
    each with nothing else running. Returns (walls, {kernel: launches},
    {kernel: max abs err})."""
    t_phase = time.time()
    obs, wide_fits, wide_walls = wide_card_fits()
    t_refs = time.time()
    wide_holds(wide_fits, wide_cpu_refs(obs))
    t_a = time.time()
    walls, launches = phase_bases_single()
    t_b = time.time()
    w_batch, l_batch, errs = phase_bases_batch()
    t_c = time.time()
    walls.update(w_batch)
    walls.update(wide_walls)
    launches["ip_steps_lane"] = 0
    for k, v in l_batch.items():
        launches[k] += v
    print(f"bases: phase {t_c - t_phase:.1f} s (19c's card fits {t_refs - t_phase:.1f} s, "
          f"their CPU references and holds {t_a - t_refs:.1f} s, 19a {t_b - t_a:.1f} s, "
          f"19b {t_c - t_b:.1f} s); launches {launches}")
    return walls, launches, errs


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
    ragged_walls, ragged_err, eis_res = phase_ragged()
    hybrid_walls, hybrid_err, hybrid_launches, hyb_res = phase_hybrid()
    het_launches, het_walls, het_md = phase_het(eis_res, hyb_res)
    postproc_walls = phase_postproc(het_md, het_walls["fit_all"])
    default_walls, default_launches = phase_defaults(het_md)
    rest_walls, rest_launches = phase_rest(het_md)
    for k, n in rest_launches.items():
        launches[k] += n
    dop_walls, dop_launches, dop_err, dop_times = phase_dop()
    for k, n in dop_launches.items():
        launches[k] += n
    for k, e in dop_err.items():
        max_err[k] = max(max_err[k], e)
    bases_walls, bases_launches, bases_err = phase_bases()
    for k, n in bases_launches.items():
        launches[k] += n
    for k, e in bases_err.items():
        max_err[k] = max(max_err[k], e)
    for k, e in {**ragged_err, **hybrid_err}.items():
        max_err[k] = max(max_err[k], e)
    for k, n in hybrid_launches.items():
        launches[k] += n
    for counts in het_launches.values():
        for k in (*FIT_KERNELS, "chol_factor_lane"):
            launches[k] += counts[k]
    for counts in default_launches.values():
        for k in FIT_KERNELS:
            launches[k] += counts[k]
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
    print("het map: " + ", ".join(f"{k} {w:.4f} s" for k, w in het_walls.items())
          + "; launches " + ", ".join(f"{k} {v}" for k, v in het_launches.items()))
    print("het post-fit pipeline (host), medians: "
          + ", ".join(f"{k} {w:.4f} s" for k, w in postproc_walls.items()))
    print("the reference's defaults: " + ", ".join(f"{k} {w:.4f} s"
                                                  for k, w in default_walls.items()))
    print("the rest of the fit surface: " + ", ".join(f"{k} {w:.4f} s"
                                                     for k, w in rest_walls.items()))
    print("DOP: " + ", ".join(f"{k} {w:.4f} s" for k, w in dop_walls.items())
          + "; kernels at n = 143: " + ", ".join(f"{k} {t['ms']:.4f} ms (bound "
                                                 f"{t['bound'][0]:.4f})"
                                                 for k, t in dop_times.items()))
    print("other bases and wide ragged fits: " + ", ".join(f"{k} {w:.4f} s"
                                                          for k, w in bases_walls.items()))
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
