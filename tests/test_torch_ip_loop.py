"""Port parity: the fused interior-point loop experiment of
hybdrt_torch/experiments/ip_loop.py.

On the CPU ``ip_steps_loop`` runs its plain version, ``ip_steps_loop_plain``:
the fused Mehrotra steps with the TPU kernels' corrector step
min(1, 0.99 ratio), the ratio unclamped. That version is held, float32
within atol = 2e-5 (the float32 bound of tests/test_torch_ip_lane.py), to the
experiment's TPU kernel (experiments/pallas_ip_loop.py::ip_steps_lane) and to
the production TPU kernel (hybdrt_tpu/ops/pallas_ip_lane.py::ip_steps_lane,
the JAX package's fused path on a TPU), both in Pallas interpret mode. The
port's ``ip_steps_ref`` is held to the experiment's ``ip_steps_ref``: float64
within rtol = 1e-9, atol = 1e-12 (the same steps; only LAPACK summation
order differs), float32 within atol = 2e-5. The experiment file is loaded by
path: ``experiments/`` is not a package. The CUDA kernel is held to the
plain version on a GPU by tests/test_torch_cuda.py.
"""
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hybdrt_tpu.ops.pallas_ip_lane import ip_steps_lane as tpu_ip_steps_lane
from hybdrt_torch.experiments import ip_loop
from hybdrt_torch.ops import ip_lane
from hybdrt_torch.utils.probe import check_steps, freeze_lane, ip_steps_bound, qp_batch
from test_torch_ip_lane import _corrector_ratios, _problems

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

F32 = dict(rtol=0, atol=2e-5)
F64 = dict(rtol=1e-9, atol=1e-12)
EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"

_spec = importlib.util.spec_from_file_location("_experiment_pallas_ip_loop",
                                               EXPERIMENTS / "pallas_ip_loop.py")
_IP_LOOP = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_IP_LOOP)

# Interpret-mode outputs per kernel, step count and inputs: each run takes seconds
_JAX = {}


def _tpu(kernel, args, n_steps):
    key = (kernel, n_steps, hashlib.sha256(b"".join(a.tobytes() for a in args)).hexdigest())
    if key not in _JAX:
        fn = _IP_LOOP.ip_steps_lane if kernel == "loop" else tpu_ip_steps_lane
        out = fn(*map(jnp.asarray, args), n_steps=n_steps, interpret=True)
        _JAX[key] = [np.asarray(o) for o in out]
    return _JAX[key]


def _experiment_problems(b, n, dtype=np.float32):
    return [np.array(a) for a in _IP_LOOP._make_problems(b, n, dtype=dtype)]


def _box_problems(b, n, seed, dtype=np.float32):
    return [a.astype(dtype) for a in _problems(b, n, seed)]


CASES = {"experiment (8, 23)": lambda: _experiment_problems(8, 23),
         "box (130, 17)": lambda: _box_problems(130, 17, seed=17)}


def _port(fn, args, n_steps, dtype=torch.float32):
    return [o.numpy() for o in fn(*(torch.as_tensor(a, dtype=dtype) for a in args), n_steps)]


@pytest.mark.parametrize("case,n_steps", [("experiment (8, 23)", 5), ("box (130, 17)", 1),
                                          ("box (130, 17)", 4)])
def test_plain_matches_experiment_kernel(case, n_steps):
    args = CASES[case]()
    want = _tpu("loop", args, n_steps)
    got = _port(ip_loop.ip_steps_loop, args, n_steps)
    for name, g, w in zip("xsz", got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, err_msg=name, **F32)


def test_plain_matches_production_tpu_kernel():
    """The JAX package's fused path on a TPU runs pallas_ip_lane.py's kernel,
    which takes the same full step and returns what the experiment's kernel
    returns, bit for bit (the two differ only in the span of the factor's
    trailing update, of which only the lower triangle is read)."""
    args = CASES["box (130, 17)"]()
    want = _tpu("lane", args, 4)
    got = _port(ip_loop.ip_steps_loop_plain, args, 4)
    for name, g, w, w7 in zip("xsz", got, want, _tpu("loop", args, 4)):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)
        np.testing.assert_array_equal(w, w7)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case,n_steps", [("experiment", 8), ("box", 4)])
def test_ref_matches_experiment_ref(case, n_steps, dtype):
    args = (_experiment_problems(8, 23, dtype) if case == "experiment"
            else _box_problems(64, 19, seed=4, dtype=dtype))
    want = [np.asarray(o) for o in _IP_LOOP.ip_steps_ref(*map(jnp.asarray, args), n_steps)]
    got = _port(ip_loop.ip_steps_ref, args, n_steps,
                torch.float64 if dtype == np.float64 else torch.float32)
    for name, g, w in zip("xsz", got, want):
        assert g.dtype == w.dtype == dtype
        np.testing.assert_allclose(g, w, err_msg=name, **(F64 if dtype == np.float64 else F32))


def test_indefinite_lane_keeps_its_input():
    """A lane whose H has a negative pivot gets NaN from the factor, and the
    NaN corrector ratio (min(1, 0.99 NaN) is NaN, as jnp.minimum's) reaches
    the freeze test: the lane keeps its input in both packages while its
    neighbours step."""
    args = _box_problems(6, 9, seed=5, dtype=np.float64)
    freeze_lane(args, 2)
    args = [a.astype(np.float32) for a in args]
    got = _port(ip_loop.ip_steps_loop, args, 4)
    want = _tpu("loop", args, 4)
    for g, w, inp in zip(got, want, args[3:]):
        np.testing.assert_array_equal(g[2], inp[2])
        np.testing.assert_array_equal(w[2], inp[2])
        assert np.all(g[[0, 1, 3, 4, 5]] != inp[[0, 1, 3, 4, 5]])
        np.testing.assert_allclose(g, w, **F32)


def test_full_step_departs_from_the_capped_rule():
    """After one step the full-step rule and ip_steps_lane's capped rule
    agree on every lane whose corrector ratios are both at most 1, and
    differ where one exceeds 1/0.99 (test_torch_ip_lane.py's construction)."""
    args = _problems(128, 17, seed=0)
    a32 = [a.astype(np.float32) for a in args]
    full = _port(ip_loop.ip_steps_loop_plain, a32, 1)
    capped = _port(ip_lane.ip_steps_lane_plain, a32, 1)
    err = np.max([np.abs(f - c).max(-1) for f, c in zip(full, capped)], axis=0)
    r_s, r_z = _corrector_ratios(*args)
    clamp_free = (r_s <= 1) & (r_z <= 1)
    full_step = (r_s > 1 / 0.99) | (r_z > 1 / 0.99)
    assert clamp_free.sum() >= 64 and full_step.sum() >= 1
    assert np.max(err[clamp_free]) <= 2e-5
    assert np.any(err[full_step] > 1e-3)
    # the experiment's reference takes the capped rule
    for c, r in zip(capped, _port(ip_loop.ip_steps_ref, a32, 1)):
        np.testing.assert_array_equal(c, r)


def test_zero_steps_and_bad_arguments():
    args = [torch.as_tensor(a, dtype=torch.float32) for a in _problems(3, 5, seed=1)]
    for got, inp in zip(ip_loop.ip_steps_loop(*args, 0), args[3:]):
        assert torch.equal(got, inp)
    with pytest.raises(ValueError):
        ip_loop.ip_steps_loop(*args, -1)
    P, v = args[0], args[1]
    with pytest.raises(ValueError, match="CUDA"):
        ip_lane.check_args(ip_loop.NAME, P, v, v, v, v, v, dtypes=ip_loop.DTYPES)
    # the block at the experiment's n = 95: two panel buffers of 96 x 4 and 13
    # vectors, 8 KB (P stays in device memory, H in registers)
    assert ip_lane.smem_bytes(95, torch.float32) == 8012


def test_cpu_calls_do_not_count_launches():
    ip_loop.reset_launch_counts()
    ip_lane.reset_launch_counts()
    args = [torch.as_tensor(a, dtype=torch.float32) for a in _problems(3, 5, seed=2)]
    ip_loop.ip_steps_loop(*args, 2)
    ip_loop.ip_steps_loop_plain(*args, 2)
    assert ip_loop.LAUNCHES == {ip_loop.NAME: 0}
    assert ip_lane.LAUNCHES == {"ip_steps_lane": 0}


def test_make_problems_is_the_experiments():
    """The port's seeded problems are the experiment's, bit for bit, and the
    bound at the experiment's shape is set by operations."""
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        got = ip_loop.make_problems(8, 23, dtype=dtype, device="cpu")
        for g, w in zip(got, _experiment_problems(8, 23, np_dtype)):
            np.testing.assert_array_equal(g.numpy(), w)
    bound_ms, bound_by = ip_steps_bound(1024, 95, 8)
    assert bound_by == "operations" and round(bound_ms, 4) == 0.0416
    assert round(ip_steps_bound(8192, 93, 4)[0], 4) == 0.1565


def test_check_steps_holds_a_version_to_its_plain_one():
    """The comparison that chip_smoke.py and the study run on the card: it
    passes the CPU path against its plain version, frozen lane included, and
    refuses the capped rule in place of the full step."""
    args = qp_batch(128, 17, torch.float32, 0, "cpu")
    freeze_lane(args, 7)
    errs = check_steps(ip_loop.NAME, ip_loop.ip_steps_loop, ip_loop.ip_steps_loop_plain, args,
                       4, ip_loop.TOL, frozen=7)
    assert errs == [0.0, 0.0, 0.0]
    with pytest.raises(RuntimeError, match="beyond rtol"):
        check_steps(ip_loop.NAME, ip_lane.ip_steps_lane_plain, ip_loop.ip_steps_loop_plain, args,
                    4, ip_loop.TOL)
