"""Wall time of the port's batched fit on one CUDA card, plain against fused
warm QPs (``qp_fused``), taken in turns in one process, and one profiled call.

Run from the repository root on a machine with a CUDA card:

    python3 torch_fit_walls.py [--rounds 3] [--batch 8192] [--no-profile]
                               [--frames | --stream | --history | --single | --hybrid | --het
                                | --het-truth | --serial]

The fit is ``chip_smoke.py``'s main path: ``make_batch(batch, 71)``
(``hybdrt_torch/utils/probe.py``, the benchmark's spectra),
float32, the benchmark's knobs, ``fit(adaptive="staged", collect="lazy")``.
After one warm-up call per fitter, each round times plain, fused, fused,
plain (host clock around a call that ends in ``torch.cuda.synchronize()``).
The profiled call (``torch.profiler``, CUDA activity) of each fitter prints
the summed kernel time, the busy share of its wall, and the kernels with the
most device time. Prints the card's name and power limit first.

With ``--frames`` it times operando frames instead: ``make_frames(batch, 71,
2, 0.02)``, frame 1 fitted cold against frame 1 fitted warm from frame 0's
lazy result (``fit(z, warm_from=prev, collect="lazy")``), each round cold,
warm, warm, cold, for the plain and then the fused fitter, with the
iteration counts of both fits, and one profiled warm call per fitter with
the lane kernels' launches.

With ``--stream`` it times a stream of four batches, ``make_stream(batch,
71)`` (``make_batch``'s spectra, batch, batch, batch / 2 and batch lanes,
the batches of ``chip_smoke.py`` phase 6c): the four fitted one after
another (``fit(z, adaptive="staged", collect="lazy")``) against
``fit_stream`` over them, in its design (a) (the package's: copies on a side
stream, the loops in this thread) and in design (b) (``stream_threaded``
here: a worker thread fits every other batch on its own stream while this
thread fits the one before it), each round sequential, (a), (b), (b), (a),
sequential, plain and then fused. Each design's results are first checked
bitwise against the sequential fits'; then one profiled run of each prints
its summed device time against its wall.

With ``--history`` it times ``fit(z, return_history=True)`` of the plain
fitter with the package's history buffers (``fitcore.History``: pinned host
memory copied into each pass) against buffers on the card with one transfer
per field at the end (``CardHistory`` here), each round device, pinned,
pinned, device, beside the plain fit, and prints the history's bytes.

With ``--single`` it times the single-spectrum and ragged fits of
``chip_smoke.py`` phases 11 and 12: ``DRT().fit_eis`` on the golden spectrum
(float64), the B = 1 float32 ``BatchedEISFitter`` fit of the benchmark's
single-fit leg, and the het leg's 768 EIS spectra (``make_het_eis``) through
``BatchedRaggedFitter`` in float32 with its settings, each round DRT, B = 1,
ragged, ragged, B = 1, DRT; then the ragged fit's ``prepare`` and loop apart,
and one profiled call of each with the lane kernels' launches.

With ``--hybrid`` it times the hybrid fits of ``chip_smoke.py`` phase 13:
``BatchedHybridFitter`` on ``make_hybrid_batch(1024)`` (het protocol 0,
float32, the het leg's QP caps, ``fit(adaptive="staged", collect="lazy")``),
plain and ``qp_fused``, and the het leg's 256 hybrid observations
(``make_het_hybrid``) through ``BatchedRaggedFitter`` in float32 with
``fit(adaptive="staged")``, each round plain, fused, ragged, ragged, fused,
plain; then the ragged fit's ``prepare`` and loop apart, and one profiled
call of each with the lane kernels' launches.

With ``--het`` it times the het leg's map through ``DRTMD``
(``chip_smoke.py`` phase 14): ``make_het_map(768, 256)``,
``fit_all(refit=True, batched=True, dtype=float32)`` and ``resolve_group("g",
psi_sort_dims=["i"])`` windowed in float64 and coupled in float32 and
float64, each round fit, windowed, coupled f32, coupled f64 and back; the
resolves' rebuild, host assembly and solve walls (``resolve_info``); then one
profiled call of each with the lane kernels' launches (the fit's with
``key_averages``' sums beside the raw events' that ``probe.profile`` prints).
Then the card's fits go to a map on the CPU (``load_fit_state``), which
resolves the group coupled in float32 and float64 through the port's plain
path: 3x that float32-vs-float64 spread of ``obs_x_resolved`` is the bound
that ``chip_smoke.py`` phase 14 holds the card's float32 coupled resolve to
(``HET_F32_BOUND``). Last, the post-fit map pipeline
(``probe.run_postproc_pipeline``, ``bench.py:349-379``) on the card's
float32 fit: one first call, then six calls, each stage's host wall (these
stages run on the host CPU, not the card).

With ``--het-truth`` it reads the het map's truth through that pipeline
(``chip_smoke.py`` phase 15's floor): ``make_het_map(768, 256)`` fitted by
the port in float64 on the CPU (``device="cpu"``) and in float32 on the card,
each map's ``obs_x`` through the pipeline, and the shares of EIS and hybrid
rows whose optimized ridge mask has a ridge within two supergrid points of
each true relaxation (``probe.het_truth_shares``), with ``bad_obs``, the
most troughs between adjacent ridges and the outputs' digest.

With ``--serial`` it times the reference's defaults of ``chip_smoke.py``
phase 16: ``DRT().fit_eis`` of the quick start's spectrum (float64), its
readouts (``probe.quickstart_readouts``), ``fit_all()`` (serial, float64) of
``make_het_map(96, 32)`` and that map's default resolve (one dense QP a
window, float64), each round fit, readouts, fit_all, resolve and back; then
one ``fit_all`` under ``probe.SerialFits`` (median wall, launches and QP
routes per EIS and hybrid fit), and one profiled call of each (of the serial
fit, its first 16 observations).
"""
import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import hybdrt_torch
from hybdrt_torch.mapping.drtmd import STATE_KEYS, load_fit_state
from hybdrt_torch.ops import chol_lane, ip_lane
from hybdrt_torch.solver import fitcore
from hybdrt_torch.utils.probe import (GOLDEN_HYPERS, POSTPROC_STAGES, card_line, golden_fit,
                                      het_truth_shares, make_batch, make_frames, make_het_eis,
                                      make_het_hybrid, make_het_map, make_hybrid_batch,
                                      make_stream, max_troughs_between_ridges, postproc_digest,
                                      profile, quickstart_eis, quickstart_readouts,
                                      run_postproc_pipeline, serial_map, SerialFits, timed)

KW = dict(max_iter=50, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--no-profile", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--frames", action="store_true")
    mode.add_argument("--stream", action="store_true")
    mode.add_argument("--history", action="store_true")
    mode.add_argument("--single", action="store_true")
    mode.add_argument("--hybrid", action="store_true")
    mode.add_argument("--het", action="store_true")
    mode.add_argument("--het-truth", action="store_true")
    mode.add_argument("--serial", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fit_walls.py needs a CUDA card")
    print(card_line())
    for flag, fn in (("frames", frames), ("stream", stream), ("history", history),
                     ("single", single), ("hybrid", hybrid), ("het", het),
                     ("het_truth", het_truth), ("serial", serial)):
        if getattr(args, flag):
            fn(args)
            return

    freq, z = make_batch(args.batch, 71)
    fitters = {name: hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda",
                                                   qp_fused=fused, **KW)
               for name, fused in (("plain", False), ("fused", True))}

    def fit(name):
        return timed(lambda: fitters[name].fit(z, adaptive="staged", collect="lazy"))

    for name in fitters:
        fit(name)
    walls = {"plain": [], "fused": []}
    for _ in range(args.rounds):
        for name in ("plain", "fused", "fused", "plain"):
            walls[name].append(fit(name))
    for name, w in walls.items():
        print(f"{name}: B={args.batch} walls {[round(v, 4) for v in w]} s, median "
              f"{np.median(w):.4f} s -> {args.batch / np.median(w):.1f} spectra/s")
    print(f"fused / plain median wall: {np.median(walls['fused']) / np.median(walls['plain']):.3f}")
    if not args.no_profile:
        for name, f in fitters.items():
            profile(name, lambda: f.fit(z, adaptive="staged", collect="lazy"), top=12)


def frames(args):
    """Cold against warm walls of one operando frame, plain and fused."""
    freq, z = make_frames(args.batch, 71, 2, 0.02)
    for name, fused in (("plain", False), ("fused", True)):
        fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda",
                                               qp_fused=fused, **KW)
        prev = fitter.fit(z[0], collect="lazy")
        fits = {"cold": lambda: fitter.fit(z[1], collect="lazy"),
                "warm": lambda: fitter.fit(z[1], warm_from=prev, collect="lazy")}
        res = {k: fn() for k, fn in fits.items()}
        walls = {"cold": [], "warm": []}
        for _ in range(args.rounds):
            for k in ("cold", "warm", "warm", "cold"):
                walls[k].append(timed(fits[k]))
        for k, w in walls.items():
            r = res[k]
            print(f"{name} {k}: B={args.batch} walls {[round(v, 4) for v in w]} s, median "
                  f"{np.median(w):.4f} s; n_iter p50/p90/max "
                  f"{np.percentile(r.n_iter, [50, 90, 100]).tolist()} mean "
                  f"{r.n_iter.mean():.4g}, converged {int(r.converged.sum())}/{args.batch}")
        print(f"{name} warm / cold median wall: "
              f"{np.median(walls['warm']) / np.median(walls['cold']):.3f}")
        if not args.no_profile:
            chol_lane.reset_launch_counts()
            ip_lane.reset_launch_counts()
            profile(f"{name} warm", fits["warm"], top=12)
            launches = dict(chol_lane.LAUNCHES, **ip_lane.LAUNCHES)
            print(f"{name} warm, lane kernel launches: {launches}")


def single(args):
    """The single DRT fit, the B = 1 batched fit and the ragged fit, in turns."""
    freq, z, _ = golden_fit()
    drt = hybdrt_torch.DRT()
    freq1, z1 = make_batch(1, 71, seed=9)
    b1 = hybdrt_torch.BatchedEISFitter(freq1, dtype=torch.float32, **KW)
    obs, tau = make_het_eis()
    ragged = hybdrt_torch.BatchedRaggedFitter(tau, dtype=torch.float32, qp_max_iter=20,
                                              qp_max_iter_warm=4)
    fits = {"drt": lambda: drt.fit_eis(freq, z, **GOLDEN_HYPERS), "b1": lambda: b1.fit(z1),
            "ragged": lambda: ragged.fit(obs, adaptive="staged")}
    for fn in fits.values():
        fn()
    walls = {k: [] for k in fits}
    for _ in range(args.rounds):
        for k in ("drt", "b1", "ragged", "ragged", "b1", "drt"):
            walls[k].append(timed(fits[k]))
    for k, w in walls.items():
        print(f"{k}: walls {[round(v, 4) for v in w]} s, median {np.median(w):.4f} s")
    prep = [timed(lambda: ragged.prepare(obs)) for _ in range(5)]

    def loop():
        loop_args, loop_kw = ragged._loop_args(ragged._device_arrays(ragged._last_batch))
        return fitcore.qphb_fit_loop(*loop_args, **loop_kw)

    loops = [timed(loop) for _ in range(5)]
    print(f"ragged prepare: median {np.median(prep):.4f} s; loop (upload, weight init, passes): "
          f"median {np.median(loops):.4f} s (five calls each)")
    if not args.no_profile:
        for k, fn in fits.items():
            chol_lane.reset_launch_counts()
            profile(k, fn, top=10)
            print(f"{k}, lane kernel launches: {dict(chol_lane.LAUNCHES)}")


def hybrid(args):
    """The uniform hybrid fit, plain and fused, and the ragged hybrid fit, in
    turns."""
    knobs = dict(qp_max_iter=20, qp_max_iter_warm=4)
    t, i, f, v, z = make_hybrid_batch(1024, proto=0)
    uniform = {name: hybdrt_torch.BatchedHybridFitter(t, i, f, dtype=torch.float32,
                                                      qp_fused=fused, **knobs)
               for name, fused in (("plain", False), ("fused", True))}
    obs, tau = make_het_hybrid()
    ragged = hybdrt_torch.BatchedRaggedFitter(tau, dtype=torch.float32, **knobs)
    fits = {"plain": lambda: uniform["plain"].fit(v, z, adaptive="staged", collect="lazy"),
            "fused": lambda: uniform["fused"].fit(v, z, adaptive="staged", collect="lazy"),
            "ragged": lambda: ragged.fit(obs, adaptive="staged")}
    res = {k: fn() for k, fn in fits.items()}
    walls = {k: [] for k in fits}
    for _ in range(args.rounds):
        for k in ("plain", "fused", "ragged", "ragged", "fused", "plain"):
            walls[k].append(timed(fits[k]))
    for k, w in walls.items():
        r, b = res[k], len(res[k].n_iter)
        print(f"{k}: B={b} walls {[round(x, 4) for x in w]} s, median {np.median(w):.4f} s -> "
              f"{b / np.median(w):.1f} obs/s; passes {int(r.n_iter.max())}, n_iter mean "
              f"{r.n_iter.mean():.4g}, converged {int(r.converged.sum())}/{b}")
    prep = [timed(lambda: ragged.prepare(obs)) for _ in range(5)]

    def loop():
        loop_args, loop_kw = ragged._loop_args(ragged._device_arrays(ragged._last_batch))
        return fitcore.qphb_fit_loop(*loop_args, **loop_kw)

    loops = [timed(loop) for _ in range(5)]
    print(f"ragged prepare: median {np.median(prep):.4f} s; loop (upload, weight init, passes): "
          f"median {np.median(loops):.4f} s (five calls each)")
    if not args.no_profile:
        for k, fn in fits.items():
            chol_lane.reset_launch_counts()
            ip_lane.reset_launch_counts()
            profile(k, fn, top=10)
            print(f"{k}, lane kernel launches: {dict(chol_lane.LAUNCHES, **ip_lane.LAUNCHES)}")


def het(args):
    """The het map's fit_all and its three resolves, in turns."""
    md = make_het_map(768, 256)
    md.fit_all(batched=True, dtype=torch.float32)
    resolve = lambda **kw: md.resolve_group("g", psi_sort_dims=["i"], **kw)
    runs = {"fit_all": lambda: md.fit_all(refit=True, batched=True, dtype=torch.float32),
            "windowed f64": lambda: resolve(batched=True, dtype=torch.float64),
            "coupled f32": lambda: resolve(coupled=True, dtype=torch.float32),
            "coupled f64": lambda: resolve(coupled=True, dtype=torch.float64)}
    for fn in runs.values():
        fn()
    walls = {k: [] for k in runs}
    parts = {k: [] for k in runs if k != "fit_all"}
    order = list(runs)
    for _ in range(args.rounds):
        for k in order + order[::-1]:
            walls[k].append(timed(runs[k]))
            if k in parts:
                parts[k].append([md.resolve_info[f] for f in ("rebuild_s", "assembly_s",
                                                              "solve_s")])
    for k, w in walls.items():
        line = f"het {k}: walls {[round(x, 4) for x in w]} s, median {np.median(w):.4f} s"
        if k in parts:
            med = np.median(np.array(parts[k]), axis=0)
            line += (f"; medians: rebuild {med[0]:.4f} s, host assembly {med[1]:.4f} s, "
                     f"solve {med[2]:.4f} s")
        print(line)
    if not args.no_profile:
        for k, fn in runs.items():
            chol_lane.reset_launch_counts()
            profile(f"het {k}", fn, top=10, key_averages=k == "fit_all")
            print(f"het {k}, lane kernel launches: {dict(chol_lane.LAUNCHES)}")

    # The coupled resolve in float32 against float64, on the card and on the
    # CPU's plain path, on the same fits
    cpu = load_fit_state(make_het_map(768, 256, device="cpu"),
                         {k: getattr(md, k) for k in STATE_KEYS})
    xs = {}
    for name, m in (("card", md), ("CPU", cpu)):
        for dt in (torch.float32, torch.float64):
            t0 = time.time()
            m.resolve_group("g", psi_sort_dims=["i"], coupled=True, dtype=dt)
            xs[name, dt] = m.obs_x_resolved.copy()
            print(f"het coupled {dt} on the {name}: {time.time() - t0:.2f} s, KKT residual "
                  f"{m.resolve_info['kkt_residual']:.4g} (tolerance "
                  f"{m.resolve_info['kkt_tol']:.4g}), objective "
                  f"{m.group_objective('g', psi_sort_dims=['i']):.10g}")
    spread = {name: float(np.max(np.abs(xs[name, torch.float32] - xs[name, torch.float64]))
                          / np.max(np.abs(xs[name, torch.float64]))) for name in ("card", "CPU")}
    print(f"het coupled f32 against f64, max |dx| / max |x|: card {spread['card']:.4g}, CPU "
          f"plain path {spread['CPU']:.4g}; 3x the CPU's {3 * spread['CPU']:.4g}")

    # The post-fit pipeline on the card's float32 fit, on the host
    first = run_postproc_pipeline(md)
    calls = [run_postproc_pipeline(md) for _ in range(6)]
    print(f"het post-fit pipeline (host), first call: "
          f"{ {k: round(v, 4) for k, v in first.items() if k != 'bad_obs'} }, bad_obs "
          f"{first['bad_obs']}")
    for k in (*POSTPROC_STAGES, "total_s"):
        w = [c[k] for c in calls]
        print(f"het post-fit {k}: six calls {[round(x, 4) for x in w]} s, median "
              f"{np.median(w):.4f} s")


def het_truth(args):
    """The het map's truth through the post-fit pipeline: the port's float64
    fit on the CPU and float32 fit on the card."""
    for device, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
        md = make_het_map(768, 256, device=device)
        t0 = time.time()
        md.fit_all(batched=True, dtype=dtype)
        t_fit = time.time() - t0
        timing, res = run_postproc_pipeline(md, return_outputs=True)
        for label in ("ridge_mask", "ridge_opt"):
            print(f"het truth, {dtype} fit on {device} ({t_fit:.1f} s), {label}: "
                  f"{het_truth_shares(md, res[label])}")
        print(f"het truth, {dtype} fit on {device}: bad_obs {timing['bad_obs']}, most troughs "
              f"between adjacent ridges "
              f"{max_troughs_between_ridges(res['ridge_opt'], res['trough_opt'])}, x_nd finite "
              f"{bool(np.isfinite(res['x_nd']).all())}, digest {postproc_digest(res)}, "
              f"pipeline {timing['total_s']:.4f} s")


def serial(args):
    """The reference's defaults of chip_smoke.py phase 16, in turns."""
    freq, z = quickstart_eis()
    drt = hybdrt_torch.DRT()
    drt.fit_eis(freq, z)
    md, _, cold = serial_map(96, 32)
    print(f"serial fit_all, first call: {cold:.3f} s")
    runs = {"quickstart fit_eis": lambda: drt.fit_eis(freq, z),
            "quickstart readouts": lambda: quickstart_readouts(drt),
            "serial fit_all": lambda: md.fit_all(refit=True),
            "dense resolve": lambda: md.resolve_group("g", psi_sort_dims=["i"])}
    for fn in runs.values():
        fn()
    walls = {k: [] for k in runs}
    order = list(runs)
    for _ in range(args.rounds):
        for k in order + order[::-1]:
            walls[k].append(timed(runs[k]))
    for k, w in walls.items():
        print(f"{k}: walls {[round(x, 4) for x in w]} s, median {np.median(w):.4f} s")
    info = md.resolve_info
    print(f"dense resolve: {info['windows']} windows, IP iterations {list(info['n_iter'])}, "
          f"rebuild {info['rebuild_s']:.4f} s, host assembly {info['assembly_s']:.4f} s, solve "
          f"{info['solve_s']:.4f} s (last call)")
    with SerialFits(md) as log:
        md.fit_all(refit=True)
    for kind, row in log.summary().items():
        print(f"serial fit_all, {kind}: {row['n']} fits, median wall {row['median_wall']:.4f} s; "
              "per fit " + ", ".join(f"{k} {v[0]}-{v[1]}" for k, v in row.items()
                                     if k not in ("n", "median_wall")))
    if not args.no_profile:
        # the whole serial fit makes millions of kernel events: its first 16
        # observations (13 EIS, 3 hybrid) stand for it
        runs["serial fit_all"] = lambda: md.fit_observations(np.arange(16))
        for k, fn in runs.items():
            chol_lane.reset_launch_counts()
            profile(k if k != "serial fit_all" else "serial fits of observations 0-15", fn,
                    top=10)
            print(f"{k}, lane kernel launches: {dict(chol_lane.LAUNCHES)}; QPs by route "
                  f"{dict(chol_lane.QP_ROUTES)}")


def stream_threaded(fitter, batches, collect="lazy"):
    """Design (b) of a stream: a worker thread fits batch k+1 with ``fit`` on
    its own CUDA stream while this thread fits batch k on the current one;
    yields the results in input order. The kernels' ctypes launchers and the
    loop's syncs take the calling thread's current stream."""
    dev = fitter.device
    side = torch.cuda.Stream(dev)

    def on_side(z):
        with torch.cuda.stream(side):
            res = fitter.fit(z, adaptive="staged", collect=collect)
        side.synchronize()
        return res

    pending = iter(batches)
    with ThreadPoolExecutor(1) as pool:
        for z in pending:
            nxt = next(pending, None)
            job = None if nxt is None else pool.submit(on_side, nxt)
            yield fitter.fit(z, adaptive="staged", collect=collect)
            if job is not None:
                res = job.result()
                # the lazy fields were allocated on the side stream
                if collect == "lazy":
                    for t in (res.weights, res.s_vectors):
                        t.record_stream(torch.cuda.current_stream(dev))
                yield res


def assert_same(a, b, label):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        same = (x is None and y is None) or (
            torch.equal(x, y) if isinstance(x, torch.Tensor) else np.array_equal(x, y))
        if not same:
            raise SystemExit(f"{label}: field {f} differs from the sequential fit's")


def stream(args):
    """Four sequential fits against fit_stream (a) and the threaded (b)."""
    freq, batches = make_stream(args.batch, 71)
    lanes = sum(len(z) for z in batches)
    for name, fused in (("plain", False), ("fused", True)):
        fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda",
                                               qp_fused=fused, **KW)
        runs = {"sequential": lambda: [fitter.fit(z, adaptive="staged", collect="lazy")
                                       for z in batches],
                "a": lambda: list(fitter.fit_stream(batches)),
                "b": lambda: list(stream_threaded(fitter, batches))}
        first = {k: fn() for k, fn in runs.items()}
        torch.cuda.synchronize()
        for k in ("a", "b"):
            for want, got in zip(first["sequential"], first[k]):
                assert_same(want, got, f"{name} design ({k})")
        print(f"{name}: designs (a) and (b) give the sequential fits' results bitwise "
              f"(batches {[len(z) for z in batches]}, n_iter max "
              f"{[int(r.n_iter.max()) for r in first['sequential']]})")
        del first
        walls = {k: [] for k in runs}
        for _ in range(args.rounds):
            for k in ("sequential", "a", "b", "b", "a", "sequential"):
                walls[k].append(timed(runs[k]))
        for k, w in walls.items():
            print(f"{name} {k}: {lanes} lanes in 4 batches, walls {[round(v, 4) for v in w]} s, "
                  f"median {np.median(w):.4f} s -> {lanes / np.median(w):.1f} spectra/s")
        seq = np.median(walls["sequential"])
        print(f"{name} median wall / sequential: (a) {np.median(walls['a']) / seq:.4f}, "
              f"(b) {np.median(walls['b']) / seq:.4f}")
        if not args.no_profile:
            for k, fn in runs.items():
                profile(f"{name} {k}", fn, top=6)


class CardHistory(fitcore.History):
    """The history's buffers on the card, one transfer per field at the end:
    the variant that the package's pinned host buffers were chosen over."""

    def __init__(self, state, max_iter):
        self.pinned, self.t = False, 0
        self.bufs = {f: torch.empty((max_iter, *getattr(state, f).shape),
                                    dtype=getattr(state, f).dtype, device=state.x.device)
                     for f in fitcore.HISTORY_FIELDS}


def history(args):
    """The history fit with device against pinned-host buffers."""
    from hybdrt_torch.solver.fitcore import HISTORY_FIELDS

    freq, z = make_batch(args.batch, 71)
    fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, device="cuda", **KW)

    def fit_history(history_cls):
        package_cls, fitcore.History = fitcore.History, history_cls
        try:
            return fitter.fit(z, adaptive=False, return_history=True)
        finally:
            fitcore.History = package_cls

    fits = {"device": lambda: fit_history(CardHistory),
            "pinned": lambda: fit_history(fitcore.History),
            "plain fit": lambda: fitter.fit(z)}
    out = {k: fn() for k, fn in fits.items()}
    hist = out["device"][1]
    for k in HISTORY_FIELDS:
        if not np.array_equal(hist[k], out["pinned"][1][k]):
            raise SystemExit(f"history field {k} differs between device and pinned buffers")
    n_bytes = sum(hist[k].nbytes for k in HISTORY_FIELDS)
    print(f"history: B={args.batch}, max_iter {fitter.fcfg.max_iter}, {n_bytes / 1e6:.1f} MB "
          f"({', '.join(f'{k} {hist[k].nbytes / 1e6:.1f}' for k in HISTORY_FIELDS)}); "
          f"device and pinned buffers give the same history")
    walls = {k: [] for k in fits}
    for _ in range(args.rounds):
        for k in ("device", "pinned", "plain fit", "plain fit", "pinned", "device"):
            walls[k].append(timed(fits[k]))
    for k, w in walls.items():
        print(f"history {k}: walls {[round(v, 4) for v in w]} s, median {np.median(w):.4f} s")
    if not args.no_profile:
        for k in ("device", "pinned"):
            profile(f"history {k}", fits[k], top=6)


if __name__ == "__main__":
    main()
