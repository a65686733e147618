"""The Cholesky layout study on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python -m hybdrt_torch.experiments.layouts [B] [n]

With no arguments it runs at (B, n) = (8192, 93), the fit's shape, and at
(1024, 93), the shape the TPU experiments were measured at. At each shape,
on seeded SPD matrices (``spd_batch``), float32:

1. every layout variant is held against its plain version on the same
   tensors, within rtol = atol = 2e-4 (L on its lower triangle);
2. the plain versions and the library calls are timed once each;
3. each layout is timed in turns with its yardstick, the production lane
   kernel of the same function (the list, then the list backwards; CUDA
   events, mean of 20 after a warm-up):

   - ``chol_factor_solve_lane_blocked`` at kb in {4, 8, 16}, against
     ``chol_factor_solve_lane`` (the same skeleton with panels of 4);
   - ``chol_solve_batched`` at block_batch in {1, 2, 4, 6}, the default
     (the TPU kernel's 8) and the most that fit (12 at n = 93 in float32),
     against ``chol_solve_lane``;
   - ``chol_solve_blocked`` (the same kernel in panels) at nb in {8, 16},
     each at block_batch in {1, 4, 6}, the default 8 and the most that fit,
     against ``chol_solve_lane``;
   - ``smem_sol`` against ``chol_factor_lane`` and ``chol_factor_solve_lane``
     (``smem_sol.sol_ratios``).

Each time is printed beside its bound (``utils/probe.py::bound``), its plain
version's time and the library call's: ``torch.linalg.solve`` for the two
solves (the same function only on SPD input, where no pivot fails) and
``a * w`` with the probe's closed-form weights; none returns both x and L.
The last line is one JSON object with every number. Nothing is written to
disk.
"""
import json
import sys

import torch

from ..ops import chol_lane
from ..utils.probe import (bound, card_line, chol_ops, cuda_ms, in_turns, lower_bytes,
                           solve_ops, spd_batch)
from . import chol_blocked, chol_column, chol_lane_blocked, smem_sol

TOL = 2e-4
SHAPES = ((8192, 93), (1024, 93))
KB = (4, 8, 16)
BLOCK_BATCH = (1, 2, 4, 6)
BLOCKED_BLOCK_BATCH = (1, 4, 6)
NB = (8, 16)
# The variant each kernel's headline numbers come from (the TPU kernels'
# defaults: 8 matrices per block, or the most that fit)
DEFAULT = {"chol_factor_solve_lane_blocked": "kb=8", "chol_solve_batched": "block_batch={bb}",
           "chol_solve_blocked": "nb=16 block_batch={bb}", "smem_sol": "probe"}
YARDSTICK = {"chol_factor_solve_lane_blocked": "chol_factor_solve_lane",
             "chol_solve_batched": "chol_solve_lane", "chol_solve_blocked": "chol_solve_lane"}


def variants(n):
    """{kernel: {label: fn(a, b)}}: the layout variants the study times at n."""
    most = chol_column.max_block_batch(n)

    def fits(block_batches):
        return [k for k in sorted({*block_batches, chol_column.block_batch_for(n), most})
                if k <= most]

    return {
        "chol_factor_solve_lane_blocked": {
            f"kb={kb}": (lambda a, b, kb=kb:
                         chol_lane_blocked.chol_factor_solve_lane_blocked(a, b, kb=kb))
            for kb in KB},
        "chol_solve_batched": {
            f"block_batch={k}": (lambda a, b, k=k:
                                 chol_column.chol_solve_batched(a, b, block_batch=k))
            for k in fits(BLOCK_BATCH)},
        "chol_solve_blocked": {
            f"nb={nb} block_batch={k}": (lambda a, b, nb=nb, k=k:
                                         chol_blocked.chol_solve_blocked(a, b, k, nb))
            for nb in NB for k in fits(BLOCKED_BLOCK_BATCH)},
        "smem_sol": {"probe": lambda a, b: smem_sol.smem_sol(a)},
    }


def default_label(kernel, n):
    return DEFAULT[kernel].format(bb=chol_column.block_batch_for(n))


def plain(kernel, a, b):
    if kernel == "chol_factor_solve_lane_blocked":
        return chol_lane_blocked.chol_factor_solve_lane_blocked_plain(a, b)
    if kernel == "smem_sol":
        return smem_sol.smem_sol_plain(a)
    return chol_column.chol_solve_batched_plain(a, b)


def max_err(got, want, what):
    """max |got - want|; raises unless within rtol = atol = TOL."""
    err = (got - want).abs()
    if not bool(torch.all(err <= TOL + TOL * want.abs())):
        raise RuntimeError(f"{what}: max abs err {float(err.max())} beyond rtol = atol = {TOL}")
    return float(err.max())


def check_variants(a, b):
    """Every variant of each kernel against its plain version on (a, b);
    returns {kernel: max abs err over its variants}, raising on a
    disagreement (the factor is compared on its lower triangle)."""
    errs = {}
    for kernel, fns in variants(a.shape[-1]).items():
        want = plain(kernel, a, b)
        errs[kernel] = 0.0
        for label, fn in fns.items():
            got = fn(a, b)
            what = f"{kernel} {label} at {tuple(a.shape)}"
            if kernel == "chol_factor_solve_lane_blocked":
                e = max(max_err(got[0], want[0], what),
                        max_err(torch.tril(got[1]), want[1], what))
            else:
                e = max_err(got, want, what)
            errs[kernel] = max(errs[kernel], e)
    return errs


def bounds(b, n):
    """{kernel: (bound_ms, bound_by)} at (b, n), float32: each input read
    once, each output written once; the factor's and substitutions'
    operations. The two solves are defined on the lower triangle and read
    only that; the factor-solve and the probe return the input's upper
    triangle, so they read and write all of the matrix."""
    mat, vec, low = b * n * n * 4, b * n * 4, lower_bytes(b, n)
    solve = chol_ops(b, n) + 2 * solve_ops(b, n)
    return {"chol_factor_solve_lane_blocked": bound(2 * mat + 2 * vec, solve),
            "chol_solve_batched": bound(low + 2 * vec, solve),
            "chol_solve_blocked": bound(low + 2 * vec, solve),
            "smem_sol": bound(2 * mat, smem_sol.sol_ops(b, n))}


def study(b, n, reps=20, check=True):
    """The study at (b, n) on the card; prints a line per measurement and
    returns a dict of every number. ``check=False`` skips step 1 (a caller
    that has held the kernels to their plain versions already)."""
    a, rhs = spd_batch(b, n, torch.float32, seed=n)
    out = {"B": b, "n": n, "max_abs_err": check_variants(a, rhs) if check else None,
           "kernels": {}}
    bnd = bounds(b, n)
    w = smem_sol.sol_weights(n, torch.float32, a.device)
    library = {"chol_factor_solve_lane_blocked": None,
               "chol_solve_batched": lambda: torch.linalg.solve(a, rhs),
               "smem_sol": lambda: a * w}
    library["chol_solve_blocked"] = library["chol_solve_batched"]
    for kernel, fns in variants(n).items():
        plain_ms = cuda_ms(lambda: plain(kernel, a, rhs), reps)
        lib_ms = None if library[kernel] is None else cuda_ms(library[kernel], reps)
        if kernel == "smem_sol":
            ms, ratios = smem_sol.sol_ratios(a, rhs, reps)
            ms["probe"] = ms.pop(smem_sol.NAME)
        else:
            yard = YARDSTICK[kernel]
            yard_fn = getattr(chol_lane, yard)
            ms = in_turns({yard: lambda: yard_fn(a, rhs),
                           **{k: (lambda fn=fn: fn(a, rhs)) for k, fn in fns.items()}}, reps)
            ratios = None
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        label = default_label(kernel, n)
        out["kernels"][kernel] = {
            "ms": mean[label], "default": label, "variants_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bnd[kernel][0], "bound_by": bnd[kernel][1],
            "probe_over_factor": ratios}
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"{kernel} at B={b} n={n} f32 (CUDA events, mean of {reps}, in turns): plain "
              f"{plain_ms:.4f} ms, library {lib}, bound {bnd[kernel][0]:.4f} ms by "
              f"{bnd[kernel][1]}")
        for k, v in ms.items():
            share = bnd[kernel][0] / mean[k] if k in fns else None
            print(f"  {k}: {' / '.join(f'{t:.4f}' for t in v)} ms"
                  + (f" ({share:.1%} of the bound)" if share is not None else " (yardstick)"))
        if ratios:
            print("  t_probe / t_factor: " + ", ".join(f"{k} {r:.3f}" for k, r in ratios.items()))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("the layout study needs a CUDA card")
    shapes = SHAPES if not argv else ((int(argv[0]), int(argv[1]) if len(argv) > 1 else 93),)
    card = card_line()
    print(card)
    results = [study(b, n) for b, n in shapes]
    print(json.dumps({"card": card, "results": results}))


if __name__ == "__main__":
    main()
