"""Wall time and float32-vs-float64 spread of the port's group resolve on the
map that ``chip_smoke.py`` resolves in its phase 8, and the factor kernel
beside its library call.

Run from the repository root:

    python3 torch_resolve_walls.py [--device cpu] [--n-obs 1024] [--rounds 3] [--no-profile]
                                   [--walls-only]

Fits ``resolve_map(n_obs)`` (``hybdrt_torch/utils/probe.py``) in float32
(``qp_max_iter=20``, ``qp_max_iter_warm=4``), then for the windowed (windows
of 7, overlap 2) and the coupled resolve prints, from one float32 and one
float64 resolve of the same blocks, max |x32 - x64| / max |x64|, the IP
iterations and the largest Rp error against the map's truth, and the group
objective of both float32 resolves.

On the CUDA card (the default) the same blocks (the card's fit) are also
solved on the CPU, the port's plain path: it prints that path's float32-vs-
float64 spread (what ``chip_smoke.py``'s ``RESOLVE_F32_BOUND`` is set from),
and per precision the card against the CPU: max |dx| / max |x| and the
windows that stop at the same IP iteration. It prints the card's name and
power limit; times ``rounds`` rounds of float32 resolves in turns (windowed,
coupled, coupled, windowed; host clock around a call that ends in a
synchronize, after one warm-up each); profiles one call of each
(``torch.profiler``, CUDA activity: kernel time, busy share of the wall, the
kernels with the most device time); and times ``chol_factor_lane``,
``chol_factor_solve_lane`` and ``torch.linalg.cholesky_ex`` in turns by CUDA
events at the resolve's (1435, 94) and the fit's (8192, 93). ``--walls-only``
skips the float32-vs-float64 and card-vs-CPU solves (a few minutes of CPU
time at 1024 observations) and goes straight to the walls.
"""
import argparse
import time

import numpy as np
import torch

import hybdrt_torch
from hybdrt_torch.mapping.drtmd import group_objective
from hybdrt_torch.utils.probe import card_line, in_turns, profile, resolve_map, spd_batch, timed

FORMS = {"windowed": dict(batched=True, batch_size=7, overlap=2), "coupled": dict(coupled=True)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def factor_turns():
    from hybdrt_torch.ops import chol_lane as cl

    for b, n in ((1435, 94), (8192, 93)):
        a, rhs = spd_batch(b, n, torch.float32, seed=n)
        fns = {"chol_factor_lane": lambda: cl.chol_factor_lane(a),
               "chol_factor_solve_lane": lambda: cl.chol_factor_solve_lane(a, rhs),
               "cholesky_ex": lambda: torch.linalg.cholesky_ex(a)}
        ms = in_turns(fns)
        print(f"in turns at B={b} n={n} f32 (CUDA events, mean of 20): "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in ms.items()))


def spread(a, b):
    return np.abs(a.x - b.x).max() / np.abs(b.x).max()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card when omitted")
    ap.add_argument("--n-obs", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--walls-only", action="store_true")
    args = ap.parse_args()
    on_card = args.device is None or torch.device(args.device).type == "cuda"
    if on_card:
        print(card_line())

    freq, tau_super, p, z = resolve_map(args.n_obs)
    fitter = hybdrt_torch.BatchedEISFitter(freq, tau_supergrid=tau_super, dtype=torch.float32,
                                           device=args.device, qp_max_iter=20,
                                           qp_max_iter_warm=4)
    t0 = time.time()
    res = fitter.fit(z, adaptive="staged", collect="lazy")
    if on_card:
        torch.cuda.synchronize()
    print(f"{args.n_obs} obs on {fitter.device}: fit f32 {time.time() - t0:.2f} s, "
          f"converged {int(res.converged.sum())}/{args.n_obs}")

    def run(form, dtype, device=args.device):
        return hybdrt_torch.resolve_group(fitter, res, z, psi=p, dtype=dtype, device=device,
                                          **FORMS[form])

    outs = {}
    for form in ([] if args.walls_only else FORMS):
        r = {}
        for where in (["card", "cpu"] if on_card else ["cpu"]):
            for name, dtype in DTYPES.items():
                t0 = time.time()
                r[where, name] = run(form, dtype, None if where == "card" else "cpu")
                n_iter = np.atleast_1d(r[where, name].info["n_iter"])
                rp_err = np.abs(fitter.predict_r_p(r[where, name]) - (1 + 0.5 * p)).max()
                print(f"  {form} {name} on the {where}: {time.time() - t0:.2f} s, IP iterations "
                      f"max {int(n_iter.max())}, max |Rp - truth| {rp_err:.4g}")
            print(f"{form} on the {where}: max |x32 - x64| / max |x64| = "
                  f"{spread(r[where, 'f32'], r[where, 'f64']):.6g}")
        if on_card:
            for name in DTYPES:
                same = (np.atleast_1d(r["card", name].info["n_iter"])
                        == np.atleast_1d(r["cpu", name].info["n_iter"]))
                print(f"{form} {name}, card vs CPU on the same blocks: max |dx| / max |x| = "
                      f"{spread(r['card', name], r['cpu', name]):.6g}; same IP iteration in "
                      f"{int(same.sum())} of {same.size}")
        outs[form] = r[("card" if on_card else "cpu"), "f32"]
    if outs:
        print("group objective f32: " + ", ".join(
            f"{form} {group_objective(fitter, res, z, p, out):.10g}" for form, out in outs.items()))
    if not on_card:
        return

    walls = {form: [] for form in FORMS}
    for _ in range(args.rounds):
        for form in ("windowed", "coupled", "coupled", "windowed"):
            walls[form].append(timed(lambda: run(form, torch.float32)))
    for form, w in walls.items():
        print(f"{form} resolve f32, {args.n_obs} obs: walls {[round(v, 4) for v in w]} s, "
              f"median {np.median(w):.4f} s")
    if not args.no_profile:
        for form in FORMS:
            profile(f"{form} resolve", lambda: run(form, torch.float32))
    factor_turns()


if __name__ == "__main__":
    main()
