"""SHA-256 digests of the production lane kernels' outputs, to show that two
checkouts compute bitwise the same results, and each kernel's time.

The Cholesky kernels (``hybdrt_torch/ops/chol_lane.py``) run on
``spd_batch`` matrices (``utils/probe.py``, seed B + n) with lane 7 (lane 1
at B <= 64) given a non-positive pivot in column n // 2, at the fit's (8192,
93), (1024, 93), the resolve's (1435, 94) and (130, 17) in float32, and at
(64, 93) and (64, 94) in float64. Each line prints the digest of one
kernel's outputs: x and L of ``chol_factor_solve_lane``, x of
``chol_solve_factored_lane`` (against that L, right-hand side b / 2 - 1), x
of ``chol_solve_lane`` and L of ``chol_factor_lane``. The fused steps
``ip_steps_lane`` (``ops/ip_lane.py``) run on ``qp_batch`` box QPs (seed B +
n) at the fused fit's (8192, 93, 4 steps), the IP-loop experiment's (1024,
95, 8) and (130, 17, 8) with lane 7 made indefinite, in float32, and at (64,
93, 8) in float64; their line prints the digest of x, s and z, and at
(8192, 93, 4) a line does the same for the IP-loop experiment's
``ip_steps_loop``. At the float32 shapes of (8192, 93), (1024, 93) and
(1435, 94), and at (8192, 93, 4) and (1024, 95, 8), each line also gives the
kernel's time, the mean of 20 calls by CUDA events after a warm-up. The
layout study's probe ``smem_sol`` (``experiments/smem_sol.py``) runs on
``spd_batch`` matrices (seed B + n) at (8192, 93), timed, and (130, 17),
float32; its line prints the digest of its output. The other three layout
kernels (``hybdrt_torch/experiments/``) run on ``spd_batch`` matrices (seed
B + n) with lane 7 given a non-positive pivot in column n // 2, at (8192,
93), timed, and (130, 17), float32: ``chol_factor_solve_lane_blocked`` (x and
L) at kb = 3, 4, 8 and 16, ``chol_solve_batched`` (x) at block_batch = 1 and
its default, and ``chol_solve_blocked`` (x) at nb = 3, 5, 8, 16 and n (one
panel), each at its default block_batch, at 1 and at the most that fit by
the rule of ROOT's wrapper (the label does not name that count, which the
rule sets); each line calls a wrapper signature that every tree since the
layout study's port has. A line after each shape's says whether
``chol_solve_blocked`` at nb = n gave ``chol_solve_batched``'s x bit for
bit. Run from the repository root on a machine with a CUDA card:

    python hybdrt_torch/utils/kernel_digest.py [ROOT]

The kernels come from the ``hybdrt_torch`` of the checkout ROOT (default:
this one), built there at first use; the inputs always come from this
checkout's ``probe.py``, so that an older checkout gets the same inputs. Run
it on one card for two checkouts, in the order parent, change, change,
parent, and compare the lines: equal digests mean bitwise equal outputs.
"""
import hashlib
import importlib.util
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CHOL_CASES = ((8192, 93, torch.float32), (1024, 93, torch.float32), (1435, 94, torch.float32),
              (130, 17, torch.float32), (64, 93, torch.float64), (64, 94, torch.float64))
IP_CASES = ((8192, 93, 4, torch.float32), (1024, 95, 8, torch.float32),
            (130, 17, 8, torch.float32), (64, 93, 8, torch.float64))
CHOL_TIMED = {(8192, 93), (1024, 93), (1435, 94)}
IP_TIMED = {(8192, 93, 4), (1024, 95, 8)}
LOOP_CASES = {(8192, 93, 4)}
SOL_CASES = ((8192, 93), (130, 17))
SOL_TIMED = {(8192, 93)}
LAYOUT_CASES = ((8192, 93), (130, 17))
LAYOUT_TIMED = {(8192, 93)}
LAYOUT_BAD = 7
KB = (3, 4, 8, 16)
NB = (3, 5, 8, 16, "n")
FROZEN = {130: 7}


def _probe():
    spec = importlib.util.spec_from_file_location("_kernel_digest_probe", HERE / "probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def sha(*tensors):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in tensors)).hexdigest()


def chol_lines(probe, cl):
    for b, n, dtype in CHOL_CASES:
        a, rhs = probe.spd_batch(b, n, dtype, b + n)
        bad = 1 if b <= 64 else 7
        a[bad, n // 2, n // 2] = -1.0
        rhs2 = rhs * 0.5 - 1.0
        x, l = cl.chol_factor_solve_lane(a, rhs)
        calls = {"chol_factor_solve_lane": (lambda: cl.chol_factor_solve_lane(a, rhs), (x, l)),
                 "chol_solve_factored_lane": (lambda: cl.chol_solve_factored_lane(l, rhs2), None),
                 "chol_solve_lane": (lambda: cl.chol_solve_lane(a, rhs), None),
                 "chol_factor_lane": (lambda: cl.chol_factor_lane(a), None)}
        for name, (fn, out) in calls.items():
            out = fn() if out is None else out
            out = out if isinstance(out, tuple) else (out,)
            timing = (f", {probe.cuda_ms(fn):.4f} ms" if (b, n) in CHOL_TIMED else "")
            print(f"{name} ({b}, {n}) {str(dtype)[6:]}, lane {bad} bad pivot: "
                  f"sha256 {sha(*out)}{timing}")


def ip_lines(probe, ip_lane, ip_loop):
    for b, n, n_steps, dtype in IP_CASES:
        args = probe.qp_batch(b, n, dtype, b + n)
        if b in FROZEN:
            probe.freeze_lane(args, FROZEN[b])
        out = ip_lane.ip_steps_lane(*args, n_steps)
        timing = (f", {probe.cuda_ms(lambda: ip_lane.ip_steps_lane(*args, n_steps)):.4f} ms"
                  if (b, n, n_steps) in IP_TIMED else "")
        print(f"ip_steps_lane ({b}, {n}, {n_steps} steps) {str(dtype)[6:]}: "
              f"sha256 {sha(*out)}{timing}")
        if (b, n, n_steps) in LOOP_CASES:
            loop = ip_loop.ip_steps_loop(*args, n_steps)
            ms = probe.cuda_ms(lambda: ip_loop.ip_steps_loop(*args, n_steps))
            print(f"ip_steps_loop ({b}, {n}, {n_steps} steps) {str(dtype)[6:]}: "
                  f"sha256 {sha(*loop)}, {ms:.4f} ms")


def sol_lines(probe, smem_sol):
    for b, n in SOL_CASES:
        a, _ = probe.spd_batch(b, n, torch.float32, b + n)
        out = smem_sol.smem_sol(a)
        timing = (f", {probe.cuda_ms(lambda: smem_sol.smem_sol(a)):.4f} ms"
                  if (b, n) in SOL_TIMED else "")
        print(f"smem_sol ({b}, {n}) float32: sha256 {sha(out)}{timing}")


def layout_lines(probe, lane_blocked, column, blocked):
    for b, n in LAYOUT_CASES:
        a, rhs = probe.spd_batch(b, n, torch.float32, b + n)
        a[LAYOUT_BAD, n // 2, n // 2] = -1.0
        calls = {f"{lane_blocked.NAME} kb={kb}":
                 (lambda kb=kb: lane_blocked.chol_factor_solve_lane_blocked(a, rhs, kb=kb))
                 for kb in KB}
        calls[f"{column.NAME} block_batch=1"] = lambda: column.chol_solve_batched(a, rhs,
                                                                                  block_batch=1)
        calls[f"{column.NAME} default"] = lambda: column.chol_solve_batched(a, rhs)
        most = column.max_block_batch(n, blocked.smem_bytes)
        for nb in NB:
            for bb, tag in ((None, ""), (1, " block_batch=1"), (most, " block_batch=most")):
                calls[f"{blocked.NAME} nb={nb}{tag}"] = (
                    lambda nb=n if nb == "n" else nb, bb=bb:
                    blocked.chol_solve_blocked(a, rhs, block_batch=bb, nb=nb))
        digests = {}
        for label, fn in calls.items():
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            digests[label] = sha(*out)
            timing = f", {probe.cuda_ms(fn):.4f} ms" if (b, n) in LAYOUT_TIMED else ""
            print(f"{label} ({b}, {n}) float32, lane {LAYOUT_BAD} bad pivot: "
                  f"sha256 {digests[label]}{timing}")
        same = digests[f"{blocked.NAME} nb=n"] == digests[f"{column.NAME} default"]
        print(f"{blocked.NAME} nb=n equals {column.NAME} ({b}, {n}): {same}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("the digests need a CUDA card")
    root = Path(argv[0]).resolve() if argv else HERE.parents[1]
    probe = _probe()
    sys.path.insert(0, str(root))
    from hybdrt_torch.experiments import (chol_blocked, chol_column, chol_lane_blocked, ip_loop,
                                          smem_sol)
    from hybdrt_torch.ops import chol_lane, ip_lane

    print(probe.card_line())
    print(f"kernels from {Path(chol_lane.__file__).resolve().parents[1]}")
    chol_lines(probe, chol_lane)
    ip_lines(probe, ip_lane, ip_loop)
    sol_lines(probe, smem_sol)
    layout_lines(probe, chol_lane_blocked, chol_column, chol_blocked)


if __name__ == "__main__":
    main()
