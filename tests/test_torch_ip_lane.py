"""Port parity: the fused Mehrotra steps of hybdrt_torch/ops/ip_lane.py.

On the CPU ``ip_steps_lane`` runs its plain PyTorch version. That version is
held to ``jax.vmap`` of ``hybdrt_tpu.ops.qp._ip_steps_single``, the JAX
package's plain loop, on the same seeded equilibrated problems: float64
within rtol=1e-9, atol=1e-12 (the same steps; only LAPACK summation order
differs), float32 within atol=2e-5 (the float32-vs-float64 spread of
``_ip_steps_single`` on such unit-diagonal problems is a few 1e-6).

The TPU kernel (``hybdrt_tpu/ops/pallas_ip_lane.py::ip_steps_lane``, Pallas
interpret mode) departs from ``_ip_steps_single`` at
``pallas_ip_lane.py:133-134``: its corrector step is min(1, 0.99 ratio), not
min(1, 0.99 min(1, ratio)), so it takes a full step where ``_ip_steps_single``
takes 0.99. ``test_tpu_kernel_departs_where_a_full_step_is_feasible`` pins
that: the port follows ``_ip_steps_single``. The CUDA kernel is held to the
plain version on a GPU by tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hybdrt_tpu.ops import qp as jqp
from hybdrt_tpu.ops.pallas_ip_lane import ip_steps_lane as tpu_ip_steps_lane
from hybdrt_torch.ops import chol_lane, ip_lane
from test_torch_cuda import IP_SIZES

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)


def _problems(b, n, seed):
    """Equilibrated (unit-diagonal) SPD box QPs with a strictly interior
    warm start, as solve_qp_box hands them to the fused steps."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, n))
    a = g @ np.swapaxes(g, 1, 2) / n + 0.1 * np.eye(n)
    dinv = 1 / np.sqrt(np.einsum("bii->bi", a))
    P = a * dinv[:, :, None] * dinv[:, None, :]
    q = rng.normal(size=(b, n))
    lb = np.where(rng.uniform(size=(b, n)) < 0.25, -1.0, 0.0)
    s0 = rng.uniform(0.05, 2.0, size=(b, n))
    z0 = rng.uniform(0.05, 2.0, size=(b, n))
    return [P, q, lb, lb + s0, s0, z0]


def _jax_steps(args, n_steps):
    out = jax.vmap(lambda *a: jqp._ip_steps_single(*a, n_steps))(*map(jnp.asarray, args))
    return [np.asarray(o) for o in out]


def _port_steps(args, n_steps, dtype):
    out = ip_lane.ip_steps_lane(*(torch.as_tensor(a, dtype=dtype) for a in args), n_steps)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_steps", [1, 4, 8])
@pytest.mark.parametrize("b,n", [(130, 17), (64, 33)])
def test_plain_matches_ip_steps_single(b, n, n_steps, dtype):
    args = _problems(b, n, seed=n)
    if dtype == torch.float32:
        args = [a.astype(np.float32) for a in args]
        tol = dict(rtol=0, atol=2e-5)
    else:
        tol = dict(rtol=1e-9, atol=1e-12)
    want = _jax_steps(args, n_steps)
    got = _port_steps(args, n_steps, dtype)
    for name, g, w in zip("xsz", got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_indefinite_lane_freezes(dtype):
    """A lane whose H has a negative pivot gets NaN from the factor and keeps
    its input for every step; its neighbours step on as in JAX."""
    args = _problems(6, 9, seed=5)
    args[0][2] = -args[0][2]
    args[4][2] = 1.0   # s: z/s cannot lift the negated diagonal
    args[5][2] = 0.1
    args[3][2] = args[2][2] + args[4][2]
    args = [a.astype(np.float32 if dtype == torch.float32 else np.float64) for a in args]
    got = _port_steps(args, 4, dtype)
    want = _jax_steps(args, 4)
    for g, w, inp in zip(got, want, args[3:]):
        np.testing.assert_array_equal(g[2], inp[2])
        np.testing.assert_array_equal(w[2], inp[2])
        assert np.all(g[[0, 1, 3, 4, 5]] != inp[[0, 1, 3, 4, 5]])
        np.testing.assert_allclose(g, w, rtol=1e-9 if dtype == torch.float64 else 0,
                                   atol=1e-12 if dtype == torch.float64 else 2e-5)


def _corrector_ratios(P, q, lb, x, s, z):
    """The unclamped fraction-to-boundary ratios of one step's corrector
    direction, for s and for z (float64, dense solves)."""
    n = q.shape[-1]
    d = z / s
    r_d = np.einsum("bij,bj->bi", P, x) + q - z
    r_p = s - (x - lb)
    mu = np.sum(s * z, -1) / n
    H = P + d[:, :, None] * np.eye(n)

    def ratio(v, dv):
        return np.where(dv < 0, -v / np.where(dv < 0, dv, -1.0), np.inf).min(-1)

    dx_aff = np.linalg.solve(H, (-r_d - z + d * r_p)[..., None])[..., 0]
    ds_aff = dx_aff - r_p
    dz_aff = -z - d * ds_aff
    a_p = np.minimum(1, ratio(s, ds_aff))[:, None]
    a_d = np.minimum(1, ratio(z, dz_aff))[:, None]
    mu_aff = np.sum((s + a_p * ds_aff) * (z + a_d * dz_aff), -1) / n
    sigma = np.clip((mu_aff / np.maximum(mu, 1e-30)) ** 3, 0, 1)
    r_c = s * z + ds_aff * dz_aff - (sigma * mu)[:, None]
    dx = np.linalg.solve(H, (-r_d - r_c / s + d * r_p)[..., None])[..., 0]
    ds = dx - r_p
    return ratio(s, ds), ratio(z, -r_c / s - d * ds)


def test_tpu_kernel_departs_where_a_full_step_is_feasible():
    """pallas_ip_lane.py:133-134 steps min(1, 0.99 ratio); _ip_steps_single
    and the port step min(1, 0.99 min(1, ratio)). After one step the two
    agree on every lane whose corrector ratios are both at most 1, and the
    TPU kernel lands elsewhere on lanes where a ratio exceeds 1/0.99."""
    args = _problems(128, 17, seed=0)
    a32 = [a.astype(np.float32) for a in args]
    tpu = tpu_ip_steps_lane(*map(jnp.asarray, a32), n_steps=1, interpret=True)
    port = _port_steps(a32, 1, torch.float32)
    err = np.max([np.abs(p - np.asarray(t)).max(-1) for p, t in zip(port, tpu)], axis=0)
    r_s, r_z = _corrector_ratios(*args)
    clamp_free = (r_s <= 1) & (r_z <= 1)
    full_step = (r_s > 1 / 0.99) | (r_z > 1 / 0.99)
    assert clamp_free.sum() >= 64 and full_step.sum() >= 1
    assert np.max(err[clamp_free]) <= 2e-5
    assert np.any(err[full_step] > 1e-3)
    # the port is _ip_steps_single's rule on every lane
    want = _jax_steps(a32, 1)
    for p, w in zip(port, want):
        np.testing.assert_allclose(p, w, rtol=0, atol=2e-5)


def test_zero_steps_and_bad_arguments():
    args = [torch.as_tensor(a) for a in _problems(3, 5, seed=1)]
    for got, inp in zip(ip_lane.ip_steps_lane(*args, 0), args[3:]):
        assert torch.equal(got, inp)
    with pytest.raises(ValueError):
        ip_lane.ip_steps_lane(*args, -1)


def test_cpu_calls_do_not_count_launches():
    ip_lane.reset_launch_counts()
    ip_lane.ip_steps_lane(*(torch.as_tensor(a) for a in _problems(3, 5, seed=2)), 2)
    assert ip_lane.LAUNCHES == {"ip_steps_lane": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    P = torch.eye(4).expand(2, 4, 4).contiguous()
    v = torch.ones(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ip_lane.check_args("ip_steps_lane", P, v, v, v, v, v)
    # H in registers, at most 4 tiles a thread in float32 and 2 in float64 on
    # 384 threads: the bench's n = 93 and the largest admitted n (216 and
    # 152, above the 166 and 117 that P and H in shared memory allowed) pass
    # to the device check, and the next n is refused for its tiles
    for dtype, largest in ((torch.float32, 216), (torch.float64, 152)):
        for n in (93, largest):
            assert ip_lane.admitted(n, dtype)
            P = torch.eye(n, dtype=dtype).expand(1, n, n).contiguous()
            v = torch.ones(1, n, dtype=dtype)
            with pytest.raises(ValueError, match="CUDA"):
                ip_lane.check_args("ip_steps_lane", P, v, v, v, v, v)
        n = largest + 1
        assert not ip_lane.admitted(n, dtype)
        P = torch.eye(n, dtype=dtype).expand(1, n, n).contiguous()
        v = torch.ones(1, n, dtype=dtype)
        with pytest.raises(ValueError, match="lower tiles"):
            ip_lane.check_args("ip_steps_lane", P, v, v, v, v, v)


_IP_SOURCE = Path(__file__).resolve().parents[1] / "hybdrt_torch" / "csrc" / "ip_lane.cu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [93, 94])
def test_geometry_mirrors_the_source(n, dtype):
    """``ip_lane.geometry`` at the fused fit's n = 93 and the resolve's 94:
    the shared bytes are those of ``smem_bytes`` in csrc/ip_lane.cu (two
    panel buffers, kVectors vectors), the tiles a thread within what the
    source instantiates (kMaxTPT, which MAX_TILES_PER_THREAD mirrors), and
    the launcher's bounds (whole warps, at most kRegThreadsMax) hold."""
    src = _IP_SOURCE.read_text()
    regs = _IP_SOURCE.with_name("lane_regs.cuh").read_text()
    n_vectors = int(re.search(r"constexpr int kVectors = (\d+);", src).group(1))
    max_tpt = {torch.float32: int(re.search(r"constexpr int kMaxTPT = (\d+);", src).group(1)),
               torch.float64: int(re.search(r"constexpr int kMaxTPT<double> = (\d+);",
                                            src).group(1))}
    threads_max = int(re.search(r"constexpr int kRegThreadsMax = (\d+);", regs).group(1))
    assert max_tpt == ip_lane.MAX_TILES_PER_THREAD and threads_max == chol_lane.REG_THREADS_MAX
    threads, tpt, smem = ip_lane.geometry(n, dtype)
    np_ = 4 * -(-n // 4)
    assert smem == torch.finfo(dtype).bits // 8 * (2 * 4 * np_ + n_vectors * n)
    assert tpt == -(-chol_lane.lower_tiles(n) // threads) <= max_tpt[dtype]
    assert threads % 32 == 0 and threads <= threads_max
    # the production geometry: three warps of four tiles in float32, five of
    # two in float64, at both n
    assert (threads, tpt) == {torch.float32: (96, 4), torch.float64: (160, 2)}[dtype]
    # the admitted n are 1 .. largest, the largest needs every tile a thread
    # the source instantiates, and the GPU tests' sizes run each
    # instantiation
    ns = [m for m in range(1, 400) if ip_lane.admitted(m, dtype)]
    assert ns == list(range(1, ns[-1] + 1))
    assert ip_lane.geometry(ns[-1], dtype)[:2] == (chol_lane.REG_THREADS_MAX, max_tpt[dtype])
    sizes = [ns[-1] if m == "max" else m for m in IP_SIZES]
    assert {ip_lane.geometry(m, dtype)[1] for m in sizes} == set(range(1, max_tpt[dtype] + 1))
