"""The fused interior-point loop experiment: the port of
``experiments/pallas_ip_loop.py``.

``ip_steps_loop(P, q, lb, x0, s0, z0, n_steps=8) -> (x, s, z)`` runs
``n_steps`` Mehrotra predictor-corrector steps per lane of a batch of box QPs
(min 1/2 x'Px + q'x s.t. x >= lb) with P kept on chip, no convergence test
and a latched per-lane freeze on a non-finite x or z, as the experiment's
TPU kernel ``ip_steps_lane`` (``pallas_ip_loop.py:160``) does. Its corrector
step is that kernel's ``min(1, 0.99 ratio)`` with the fraction-to-boundary
ratio unclamped (``:136-137``), a full step wherever one is feasible. The
CUDA kernel is the production fused kernel of ``hybdrt_torch/csrc/
ip_lane.cu`` instantiated with that rule (``ip_steps_loop_f32``): the two
TPU kernels compute the same steps, and the production one
(``ops/ip_lane.py::ip_steps_lane``) follows ``_ip_steps_single``'s
``min(1, 0.99 min(1, ratio))`` instead.

- ``ip_steps_loop_plain``: the same steps in plain PyTorch, with the
  kernel's rule (``ops/ip_lane.py::ip_steps_lane_plain(full_step=True)``).
- ``ip_steps_ref``: the experiment's own reference (``pallas_ip_loop.py:
  206-252``), whose corrector step is ``min(1, 0.99 min(1, ratio))``:
  ``ops/ip_lane.py::ip_steps_lane_plain``.
- ``make_problems``: the experiment's seeded problems (``:255-268``).

P is (B, n, n) and q, lb, x0, s0, z0 are (B, n), contiguous float32, as the
TPU kernel was. A CPU tensor runs the plain version; a CUDA tensor launches
the kernel or raises, and each launch adds one to ``LAUNCHES``. Nothing on a
fit or resolve path calls it, as nothing in the JAX package calls the
experiment.

Run from the repository root on a machine with a CUDA card:

    python -m hybdrt_torch.experiments.ip_loop [B] [n] [T]

With no arguments it runs at (B, n, T) = (1024, 95, 8), the experiment's own
shape, and at (8192, 93, 4), the fused fit's (``qp_max_iter_warm = 4``). At
each shape, on ``make_problems`` inputs (``study``):

1. the kernel against ``ip_steps_loop_plain`` on the same tensors, within
   rtol = atol = 2e-4 on x, s and z;
2. the experiment's own check: the kernel's x against ``ip_steps_ref``,
   max |dx| / max |x_ref| < 2e-2 (``pallas_ip_loop.py:292``);
3. the kernel and the production ``ip_steps_lane`` timed in turns (CUDA
   events, mean of 20 after a warm-up), the plain version and the reference
   once each, beside the bound; no single PyTorch call computes these steps,
   so there is no library time. The mean s.z/n after the T steps is printed
   for both rules.

The last line is one JSON object with every number. Nothing is written to
disk.
"""
import json
import sys

import numpy as np
import torch

from ..csrc import build as _build
from ..ops import ip_lane
from ..utils.probe import card_line, check_steps, cuda_ms, in_turns, ip_steps_bound

NAME = "ip_steps_loop"
LAUNCHES = {NAME: 0}
DTYPES = (torch.float32,)
# Kernel against plain, float32: ip_steps_lane's tolerance (chip_smoke.py)
TOL = 2e-4
# The experiment's own bound on the kernel against its reference on the chip
REF_RTOL = 2e-2
SHAPES = ((1024, 95, 8), (8192, 93, 4))

ip_steps_ref = ip_lane.ip_steps_lane_plain


def reset_launch_counts():
    LAUNCHES[NAME] = 0


def ip_steps_loop_plain(P, q, lb, x0, s0, z0, n_steps=8):
    return ip_lane.ip_steps_lane_plain(P, q, lb, x0, s0, z0, n_steps, full_step=True)


def ip_steps_loop(P, q, lb, x0, s0, z0, n_steps=8):
    """``n_steps`` full-step Mehrotra steps on every lane from (x0, s0, z0)
    -> (x, s, z)."""
    n_steps = int(n_steps)
    if n_steps < 0:
        raise ValueError(f"{NAME}: n_steps={n_steps} must be >= 0")
    vecs = (q, lb, x0, s0, z0)
    if ip_lane.on_cpu(NAME, P, *vecs, dtypes=DTYPES):
        return ip_steps_loop_plain(P, *vecs, n_steps)
    x, s, z = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    bsz, n = q.shape
    if bsz:
        _build.launch(NAME, (P, *vecs, x, s, z),
                      (bsz, n, n_steps, ip_lane.geometry(n, P.dtype)[0]), P.device)
        LAUNCHES[NAME] += 1
    return x, s, z


def make_problems(b, n, seed=0, dtype=torch.float32, device="cuda"):
    """The experiment's problems (``pallas_ip_loop.py::_make_problems``):
    Jacobi-equilibrated A A'/n + 0.1 I, lb = 0, a strictly interior start.
    Returns (P, q, lb, x0, s0, z0)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n))
    p = a @ np.transpose(a, (0, 2, 1)) / n + np.eye(n) * 0.1
    dd = 1.0 / np.sqrt(np.einsum("bii->bi", p))
    p = p * dd[:, :, None] * dd[:, None, :]
    q = rng.normal(size=(b, n))
    lb = np.zeros((b, n))
    x0 = np.abs(rng.normal(size=(b, n))) + 0.1
    s0 = x0 - lb
    z0 = np.abs(rng.normal(size=(b, n))) + 0.1
    return tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in (p, q, lb, x0, s0, z0))


def study(b, n, n_steps, reps=20):
    """The experiment at (b, n, n_steps) on the card; prints a line per
    measurement and returns a dict of every number."""
    args = make_problems(b, n)
    errs = check_steps(NAME, ip_steps_loop, ip_steps_loop_plain, args, n_steps, TOL)
    out = {"B": b, "n": n, "n_steps": n_steps, "max_abs_err": max(errs)}
    x, s, z = ip_steps_loop(*args, n_steps)
    x_ref = ip_steps_ref(*args, n_steps)[0]
    out["ref_rel"] = rel = float((x - x_ref).abs().max() / x_ref.abs().max())
    print(f"fused-vs-reference max |dx| / max |x_ref|: {rel:.3e} (the experiment's bound "
          f"{REF_RTOL})")
    if not rel < REF_RTOL:
        raise RuntimeError(f"{NAME} does not match the reference IP steps: rel {rel}")

    ms = in_turns({NAME: lambda: ip_steps_loop(*args, n_steps),
                   "ip_steps_lane": lambda: ip_lane.ip_steps_lane(*args, n_steps)}, reps)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    plain_ms = cuda_ms(lambda: ip_steps_loop_plain(*args, n_steps), reps)
    ref_ms = cuda_ms(lambda: ip_steps_ref(*args, n_steps), reps)
    bound_ms, bound_by = ip_steps_bound(b, n, n_steps)
    s5, z5 = ip_lane.ip_steps_lane(*args, n_steps)[1:]
    mu = {NAME: float((s * z).mean()), "ip_steps_lane": float((s5 * z5).mean())}
    out.update(ms=mean[NAME], turns_ms=ms, plain_ms=plain_ms, ref_ms=ref_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by, mu=mu)
    print(f"{NAME} at B={b} n={n} {n_steps} steps f32 (CUDA events, mean of {reps}, in turns "
          f"with ip_steps_lane): plain {plain_ms:.4f} ms, reference {ref_ms:.4f} ms, library "
          f"none, bound {bound_ms:.4f} ms by {bound_by}")
    for k, v in ms.items():
        print(f"  {k}: {' / '.join(f'{t:.4f}' for t in v)} ms, {mean[k] / n_steps:.4f} ms per "
              f"step ({bound_ms / mean[k]:.1%} of the bound); mean s.z/n after the steps "
              f"{mu[k]:.4g}")
    print(f"  {NAME} / ip_steps_lane: {mean[NAME] / mean['ip_steps_lane']:.4f}")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("the IP-loop experiment needs a CUDA card")
    defaults = (None, 95, 8)
    shapes = SHAPES if not argv else (tuple(int(argv[i]) if i < len(argv) else defaults[i]
                                            for i in range(3)),)
    card = card_line()
    print(card)
    results = [study(b, n, t) for b, n, t in shapes]
    print(json.dumps({"card": card, "results": results}))


if __name__ == "__main__":
    main()
