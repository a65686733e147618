"""Port parity: batched solve_qp_box (hybdrt_torch/ops/qp.py) against the JAX
reference ``jax.vmap(hybdrt_tpu.ops.qp.solve_qp_box)`` on the same seeded
problems, float64 on the CPU: x and z within rtol=1e-9, atol=1e-12 (both run
the same Mehrotra iteration; only BLAS/LAPACK summation order differs) and
identical per-lane iteration counts."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hybdrt_tpu.ops import qp as jqp
from hybdrt_torch.ops import ip_lane, qp as tqp

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

B = 16


def _problems(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, n, n))
    # spread of column scales exercises the Jacobi equilibration
    scale = 10 ** rng.uniform(-1, 1, size=(B, 1, n))
    g = g * scale
    P = g @ np.swapaxes(g, 1, 2) / n + 1e-3 * np.eye(n)
    q = rng.normal(size=(B, n)) * 3
    lb = np.zeros(n)
    lb[: n // 4] = -1.0
    return P, q, lb, rng


def _jax_solve(P, q, lb, **kw):
    x_init = kw.pop("x_init", None)
    z_init = kw.pop("z_init", None)
    max_iter = kw.pop("max_iter", 60)
    fused = kw.pop("fused_steps", None)
    if x_init is None:
        fn = lambda p, qq, mi: jqp.solve_qp_box(p, qq, jnp.asarray(lb), max_iter=mi,
                                                fused_steps=fused)
        res = jax.vmap(fn)(jnp.asarray(P), jnp.asarray(q), jnp.asarray(max_iter))
    else:
        fn = lambda p, qq, mi, xi, zi: jqp.solve_qp_box(p, qq, jnp.asarray(lb), max_iter=mi,
                                                        x_init=xi, z_init=zi,
                                                        fused_steps=fused)
        res = jax.vmap(fn)(jnp.asarray(P), jnp.asarray(q), jnp.asarray(max_iter),
                           jnp.asarray(x_init), jnp.asarray(z_init))
    return {k: np.asarray(getattr(res, k)) for k in ("x", "z", "iterations")}


def _torch_solve(P, q, lb, **kw):
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float64)
    max_iter = kw.pop("max_iter", 60)
    res = tqp.solve_qp_box(t(P), t(q), t(lb),
                           max_iter=torch.as_tensor(np.broadcast_to(max_iter, (B,)).copy()),
                           x_init=t(kw.get("x_init")), z_init=t(kw.get("z_init")),
                           fused_steps=kw.get("fused_steps"))
    return {k: getattr(res, k).numpy() for k in ("x", "z", "iterations")}


def _assert_match(r_t, r_j):
    np.testing.assert_array_equal(r_t["iterations"], r_j["iterations"])
    np.testing.assert_allclose(r_t["x"], r_j["x"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r_t["z"], r_j["z"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("mode", ["cold", "warm", "per_lane_max_iter"])
@pytest.mark.parametrize("n", [20, 40])
def test_solve_qp_box_matches_jax_vmap(n, mode):
    P, q, lb, rng = _problems(n, seed=n)
    kw = {"max_iter": np.full(B, 60, dtype=np.int32)}
    if mode in ("warm", "per_lane_max_iter"):
        kw["x_init"] = lb + rng.uniform(0.01, 2.0, size=(B, n))
        kw["z_init"] = rng.uniform(0.01, 2.0, size=(B, n))
    if mode == "per_lane_max_iter":
        kw["max_iter"] = rng.integers(1, 8, size=B).astype(np.int32)
    r_j = _jax_solve(P, q, lb, **dict(kw))
    r_t = _torch_solve(P, q, lb, **dict(kw))
    _assert_match(r_t, r_j)
    if mode == "per_lane_max_iter":
        assert np.all(r_t["iterations"] <= kw["max_iter"])
        assert np.any(r_t["iterations"] == kw["max_iter"])


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("n", [20, 40])
def test_fused_steps_match_jax_vmap(n, start):
    """fused_steps=4: four fixed Mehrotra steps in one ip_steps_lane call, then
    the polish, against the JAX solve_qp_box(fused_steps=4) vmapped (its
    custom_vmap runs _ip_steps_single on the CPU). x and z within rtol=1e-8,
    iterations 4 on every lane."""
    P, q, lb, rng = _problems(n, seed=n + 1)
    kw = {"fused_steps": 4, "max_iter": np.full(B, 60, dtype=np.int32)}
    if start == "warm":
        kw["x_init"] = lb + rng.uniform(0.01, 2.0, size=(B, n))
        kw["z_init"] = rng.uniform(0.01, 2.0, size=(B, n))
    r_j = _jax_solve(P, q, lb, **dict(kw))
    r_t = _torch_solve(P, q, lb, **dict(kw))
    assert np.all(r_t["iterations"] == 4) and np.all(r_j["iterations"] == 4)
    np.testing.assert_allclose(r_t["x"], r_j["x"], rtol=1e-8, atol=0)
    np.testing.assert_allclose(r_t["z"], r_j["z"], rtol=1e-8, atol=0)


def test_solution_satisfies_kkt():
    P, q, lb, _ = _problems(20, seed=3)
    res = tqp.solve_qp_box(torch.from_numpy(P), torch.from_numpy(q), torch.from_numpy(lb))
    x, z = res.x.numpy(), res.z.numpy()
    grad = np.einsum("bij,bj->bi", P, x) + q
    assert np.all(x >= lb - 1e-10)
    assert np.all(z >= -1e-9)
    np.testing.assert_allclose(grad, z, atol=1e-8)
    assert np.max(np.abs((x - lb) * z)) < 1e-8


def test_max_step_matches_jax():
    rng = np.random.default_rng(4)
    v = rng.uniform(0.1, 1, size=(B, 12))
    dv = rng.normal(size=(B, 12))
    dv[0] = np.abs(dv[0])  # no blocking component: step 1
    got = ip_lane._max_step(torch.from_numpy(v), torch.from_numpy(dv)).numpy()
    want = np.asarray(jax.vmap(jqp._max_step)(jnp.asarray(v), jnp.asarray(dv)))
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert got[0] == 1.0
