"""Wall time of the port's batched fit on one CUDA card, plain against fused
warm QPs (``qp_fused``), taken in turns in one process, and one profiled call.

Run from the repository root on a machine with a CUDA card:

    python3 torch_fit_walls.py [--rounds 3] [--batch 8192] [--no-profile]

The fit is ``chip_smoke.py``'s main path: ``make_batch(batch, 71)``
(``hybdrt_torch/utils/probe.py``, the benchmark's spectra),
float32, the benchmark's knobs, ``fit(adaptive="staged", collect="lazy")``.
After one warm-up call per fitter, each round times plain, fused, fused,
plain (host clock around a call that ends in ``torch.cuda.synchronize()``).
The profiled call (``torch.profiler``, CUDA activity) of each fitter prints
the summed kernel time, the busy share of its wall, and the kernels with the
most device time. Prints the card's name and power limit first.
"""
import argparse

import numpy as np
import torch

import hybdrt_torch
from hybdrt_torch.utils.probe import card_line, make_batch, profile, timed

KW = dict(max_iter=50, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fit_walls.py needs a CUDA card")
    print(card_line())

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


if __name__ == "__main__":
    main()
