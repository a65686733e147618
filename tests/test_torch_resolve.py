"""Port parity: the group resolve (hybdrt_torch/mapping/{resolve,drtmd}.py)
against hybdrt_tpu/mapping/{resolve,drtmd}.py on the CPU.

float64 unless a test says otherwise. The solvers are held to x within 1e-10
relative to max |x| and the same interior-point iteration count (per window
for the windowed solve). The map end to end (the 14-observation map of
tests/test_resolve_coupled.py, fitted by the JAX DRTMD and by the port's
BatchedEISFitter with the same supergrid) is held to 1e-7 of max |x|: the
two fits themselves differ by ~4e-10 relative. The float32 solver is held
to JAX's float32 solver within 1e-5 of max |x| with the same iteration
count (the spread is ~5e-7); the float32 map resolve to the float64 one as
its test states.
"""
import copy
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter1d

from hybdrt_tpu import preprocessing as jax_pp
from hybdrt_tpu.mapping import resolve as jax_resolve
from hybdrt_tpu.mapping.drtmd import DRTMD
from hybdrt_tpu.ops.qp import spd_factor as jax_spd_factor
from hybdrt_tpu.utils.array import nearest_index as jax_nearest_index
from hybdrt_torch import BatchedEISFitter, resolve_group
from hybdrt_torch import preprocessing as pp
from hybdrt_torch.mapping import drtmd as port_drtmd
from hybdrt_torch.mapping import resolve
from hybdrt_torch.ops import chol_lane
from hybdrt_torch.ops.qp import spd_factor
from hybdrt_torch.utils.probe import resolve_map

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

FREQ = np.logspace(5, -1, 41)
TAU_SUPER = np.logspace(-7, 2, 91)
B = 14
PSIS = np.linspace(0, 1, B)


def _synth_system(nr, nc, seed=0, lam=3.0):
    """As tests/test_resolve_coupled.py::_synth_system."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(nr, nc, nc))
    p = np.einsum("bij,bkj->bik", a, a) + 0.5 * np.eye(nc)
    q = rng.normal(size=(nr, nc)) * 2
    lb = np.zeros(nc)
    ly = gaussian_filter1d(np.eye(nr), sigma=1.0, mode="reflect", order=2)
    my = ly.T @ ly
    cmat = np.diag(rng.uniform(0.5, 2.0, nc)) * lam
    return p, q, lb, my, cmat


def _negative_lb_system():
    p, q, lb, my, cmat = _synth_system(8, 11, seed=3)
    lb = np.full(11, -10.0)
    lb[0] = 0.0
    return p, q, lb, my, cmat


SYSTEMS = {
    "plain": lambda: _synth_system(12, 17),
    "negative_lb": _negative_lb_system,
    "strong_coupling": lambda: _synth_system(16, 9, seed=5, lam=200.0),
}


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# spd_factor and the supergrid snap
# ---------------------------------------------------------------------------
def test_spd_factor_matches_jax_and_keeps_its_input():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(6, 9, 9))
    a = g @ np.swapaxes(g, 1, 2) + 9 * np.eye(9)
    at = torch.from_numpy(a.copy())
    l = spd_factor(at)
    l_j = np.asarray(jax.vmap(jax_spd_factor)(jnp.asarray(a)))
    np.testing.assert_allclose(np.tril(l.numpy()), np.tril(l_j), rtol=1e-12, atol=1e-12)
    assert torch.equal(at, torch.from_numpy(a))
    a[2, 3, 3] = -1.0
    l = spd_factor(torch.from_numpy(a)).numpy()
    assert np.isnan(l[2]).all() and np.isfinite(l[[0, 1, 3, 4, 5]]).all()


def test_supergrid_snap_matches_jax():
    for freq in (FREQ, np.logspace(6, -1, 71), np.logspace(9, -4, 30)):
        np.testing.assert_array_equal(pp.get_basis_tau(freq, tau_grid=TAU_SUPER),
                                      jax_pp.get_basis_tau(freq, None, None, tau_grid=TAU_SUPER))
    x = np.logspace(-3, 3, 13)
    for val in (0.2, 1e-5, 1e5, 10.0):
        for constraint in (None, -1, 1):
            assert pp.nearest_index(x, val, constraint) == jax_nearest_index(x, val, constraint)


# ---------------------------------------------------------------------------
# Host assembly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tau_indices,match", [
    ((3, 10), (2, 12)), ((1, 13), (3, 10)), ((3, 13), (2, 10)), ((1, 9), (3, 12))])
def test_resize_pq_matches_jax(tau_indices, match):
    rng = np.random.default_rng(1)
    n = 2 + tau_indices[1] - tau_indices[0]
    p, q = rng.normal(size=(n, n)), rng.normal(size=n)
    got = resolve.resize_pq(p, q, 2, tau_indices, match)
    want = jax_resolve.resize_pq(p, q, 2, tau_indices, match)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_offset_pq_and_special_dict_match_jax():
    special = {"vz_offset": {"index": 0, "nonneg": False, "size": 1},
               "R_inf": {"index": 1, "nonneg": True, "size": 1},
               "inductance": {"index": 2, "nonneg": True, "size": 1}}
    rng = np.random.default_rng(2)
    p, q = rng.normal(size=(8, 8)), rng.normal(size=8)
    drt = SimpleNamespace(special_qp_params=special,
                          fit_parameters={"p_matrix": p, "q_vector": q, "vz_offset": 0.3})
    got = resolve.get_offset_pq(p, q, special, {"vz_offset": 0.3})
    for g, w in zip(got, jax_resolve.get_offset_pq(drt)):
        np.testing.assert_array_equal(g, w)
    assert resolve.offset_special_dict(special) == jax_resolve.offset_special_dict(special)


def test_prepare_group_blocks_rejects_hybrid_specials():
    """v_baseline / vz_offset need the fitted values the blocks do not take."""
    special = {"vz_offset": {"index": 0, "nonneg": False, "size": 1},
               "R_inf": {"index": 1, "nonneg": True, "size": 1}}
    with pytest.raises(NotImplementedError, match="items 6-7"):
        resolve.prepare_group_blocks([np.eye(4)], [np.ones(4)], [1.0], [0.1], [(0, 2)],
                                     special, True)


@pytest.mark.parametrize("kw", [{}, {"tau_filter_sigma": 1.0, "sigma": 2.0, "lambda_psi": 3.0},
                                {"truncate": True}])
def test_prepare_group_blocks_matches_jax(kw):
    """Arrays in, as the port takes them, against the JAX function on stand-in
    DRT objects carrying the same values (ragged tau windows included)."""
    rng = np.random.default_rng(4)
    special = {"R_inf": {"index": 0, "nonneg": True, "size": 1},
               "inductance": {"index": 1, "nonneg": True, "size": 1}}
    tis = [(3, 20), (2, 20), (3, 21), (4, 19), (3, 20)]
    ps, qs, drts = [], [], []
    for i, ti in enumerate(tis):
        n = 2 + ti[1] - ti[0]
        g = rng.normal(size=(n, n))
        ps.append(g @ g.T + np.eye(n))
        qs.append(rng.normal(size=n))
        scale = 0.5 + 0.1 * i
        drts.append(SimpleNamespace(
            special_qp_params=special, coefficient_scale=scale,
            fit_parameters={"p_matrix": ps[-1], "q_vector": qs[-1], "R_inf": 0.3 * (1 + i)}))
    scales = np.array([d.coefficient_scale for d in drts])
    r_inf = np.array([d.fit_parameters["R_inf"] for d in drts]) / scales
    got = resolve.prepare_group_blocks(ps, qs, scales, r_inf, tis, special, True, **kw)
    want = jax_resolve.prepare_group_blocks(drts, tis, True, **kw)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_allclose(g, w, rtol=1e-13, atol=1e-13)
    assert got[5] == want[5]


# ---------------------------------------------------------------------------
# The solvers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_coupled_group_matches_jax(name):
    p, q, lb, my, cmat = SYSTEMS[name]()
    x_j, n_j, kkt_j = jax_resolve.solve_coupled_group(p, q, lb, my, cmat)
    x, n_iter, kkt = resolve.solve_coupled_group(p, q, lb, my, cmat, device="cpu")
    assert n_iter == n_j
    assert _rel(x, x_j) < 1e-10
    assert kkt < 1e-7 and abs(kkt - kkt_j) < 1e-10


def test_coupled_group_float32_matches_jax():
    p, q, lb, my, cmat = _synth_system(12, 17)
    x_j, n_j, _ = jax_resolve.solve_coupled_group(p, q, lb, my, cmat, dtype=jnp.float32)
    x, n_iter, kkt = resolve.solve_coupled_group(p, q, lb, my, cmat, device="cpu",
                                                 dtype=torch.float32)
    assert x.dtype == np.float32 and n_iter == n_j
    assert _rel(x, x_j) < 1e-5
    assert kkt < 1e-3 * max(1.0, np.abs(q).max())


def _windows():
    """Three windows of 5 observations whose interior points stop at
    different iterations; the last is narrower, so it is padded."""
    return [_synth_system(5, 13, seed=15), _synth_system(5, 13, seed=12, lam=0.1),
            _synth_system(5, 11, seed=12, lam=200.0)]


def test_resolve_batch_matches_jax_per_window():
    blocks = _windows()
    xs_j = jax_resolve.solve_resolve_batch(blocks)
    xs, info = resolve.solve_resolve_batch(blocks, device="cpu", return_info=True)
    # JAX's per-window iteration counts, from its core on the same padded arrays
    *arrays, sizes = resolve.pad_windows(blocks)
    _, n_j, _ = jax_resolve._coupled_batch_core(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(1e-12), jnp.asarray(1e-10),
        jnp.asarray(60, jnp.int32), jnp.asarray(200, jnp.int32))
    np.testing.assert_array_equal(info["n_iter"], np.asarray(n_j))
    assert len(set(info["n_iter"].tolist())) == 3
    assert sizes == [13, 13, 11]
    for x, x_j in zip(xs, xs_j):
        assert x.shape == x_j.shape
        assert _rel(x, x_j) < 1e-10
    # every window's solution is also the coupled solution of that window alone
    for x, blk in zip(xs, blocks):
        assert _rel(x, resolve.solve_coupled_group(*blk, device="cpu")[0]) < 1e-10


def test_solvers_reject_a_mesh_and_count_no_launches_on_the_cpu():
    chol_lane.reset_launch_counts()
    blocks = _windows()[:1]
    resolve.solve_resolve_batch(blocks, device="cpu")
    assert chol_lane.LAUNCHES == {k: 0 for k in chol_lane.LAUNCHES}
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        resolve.solve_resolve_batch(blocks, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        resolve.solve_coupled_group(*blocks[0], mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# The map end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fitted():
    """The 14-observation map of tests/test_resolve_coupled.py, added in a
    shuffled psi order, fitted by the JAX DRTMD and by the port."""
    rng = np.random.default_rng(8)
    zs = []
    for p in PSIS:
        r, tau0 = 1.0 + 0.5 * p, 10 ** (-3 + 2 * p)
        z = 0.4 + r / (1 + (2j * np.pi * FREQ * tau0) ** 0.85)
        zs.append(z + (rng.normal(size=len(FREQ)) + 1j * rng.normal(size=len(FREQ))) * 0.004)
    perm = np.random.default_rng(3).permutation(B)
    zs, psis = np.array(zs)[perm], PSIS[perm]
    md = DRTMD(TAU_SUPER, psi_dim_names=["T"], warn=False, print_progress=False)
    for p, z in zip(psis, zs):
        md.add_observation([p], None, (FREQ, z), group_id="g")
    md.fit_all(batched=True)
    fitter = BatchedEISFitter(FREQ, tau_supergrid=TAU_SUPER, dtype=torch.float64, device="cpu")
    return md, fitter, fitter.fit(zs, collect="lazy"), zs, psis


def test_fitter_window_matches_the_map(fitted):
    md, fitter, res, _, _ = fitted
    left, right = fitter.tau_indices
    assert (left, right) == tuple(md.obs_tau_indices[0])
    np.testing.assert_array_equal(fitter.basis_tau, TAU_SUPER[left:right])
    assert fitter.tau_epsilon == md._batch_fitter.template.tau_epsilon
    np.testing.assert_allclose(res.x, md.obs_x[:, left:right], rtol=1e-6, atol=1e-10)


def test_uniform_pq_matches_jax(fitted):
    """The port's (P, q) rebuild from the JAX fit's own state (lazy-collect
    style: weights and s_vectors as tensors) against DRTMD._uniform_pq."""
    md, fitter, _, zs, _ = fitted
    attrs = [md.obs_fit_attr[i] for i in range(B)]
    p_j, q_j = md._uniform_pq(md._resolve_batch_fitter(0, attrs[0]), attrs)
    state = SimpleNamespace(
        rho=np.stack([a["rho"] for a in attrs]),
        s_vectors=torch.as_tensor(np.stack([a["s_vectors"] for a in attrs])),
        weights=torch.as_tensor(np.stack([a["weights"] for a in attrs])))
    p, q = port_drtmd.uniform_pq(fitter, state, zs)
    np.testing.assert_allclose(p, p_j, rtol=1e-10, atol=1e-10 * np.abs(p_j).max())
    np.testing.assert_allclose(q, q_j, rtol=1e-10, atol=1e-10 * np.abs(q_j).max())


@pytest.mark.parametrize("kw", [{"coupled": True}, {"batched": True},
                                {"batched": True, "batch_size": 4, "overlap": 0}])
def test_group_resolve_matches_jax(fitted, kw):
    md, fitter, res, zs, psis = fitted
    md = copy.deepcopy(md)
    md.resolve_group("g", psi_sort_dims=["T"], **kw)
    out = resolve_group(fitter, res, zs, psi=psis, device="cpu", **kw)
    left, right = out.tau_indices
    x_j = md.obs_x_resolved[:, left:right]
    assert out.x.shape == x_j.shape
    assert np.max(np.abs(out.x - x_j)) < 1e-7 * np.max(np.abs(x_j))
    for key in ("R_inf", "inductance"):
        np.testing.assert_allclose(out.special[key], md.obs_special_resolved[key],
                                   rtol=1e-7, atol=1e-12)
    np.testing.assert_array_equal(psis[out.order], np.sort(psis))
    if kw.get("coupled"):
        assert out.info["n_iter"] == md.resolve_info["n_iter"]
        assert out.info["kkt_residual"] <= out.info["kkt_tol"]
    else:
        n_win = len(port_drtmd.resolve_windows(B, kw.get("batch_size", 7), kw.get("overlap", 2)))
        assert out.info["windows"] == n_win and out.info["n_iter"].shape == (n_win,)
        assert out.info["host_syncs"] > 0 and out.info["cg_iterations"] > 0


def test_group_resolve_float32_tracks_float64(fitted):
    """float32 solves of the same blocks against the float64 ones: within
    3e-3 of max |x|, 3x the largest float32-vs-float64 spread of either
    package on this map (9.3e-4 for the port's coupled solve, 7.4e-4 for the
    JAX windowed one, measured on the CPU: in float32 the polish can keep
    the interior point, a few 1e-4 above a bound), and the coupled KKT
    within its float32 tolerance."""
    _, fitter, res, zs, psis = fitted
    for kw in ({"coupled": True}, {"batched": True}):
        x64 = resolve_group(fitter, res, zs, psi=psis, device="cpu", **kw).x
        out = resolve_group(fitter, res, zs, psi=psis, device="cpu", dtype=torch.float32, **kw)
        assert np.max(np.abs(out.x - x64)) < 3e-3 * np.max(np.abs(x64))
        if kw.get("coupled"):
            assert out.info["kkt_residual"] <= out.info["kkt_tol"]


def test_coupled_objective_is_no_higher_than_windowed(fitted):
    """The coupled resolve minimizes the group objective that the overlapping
    windows only approximate (tests/test_resolve_coupled.py:159-188)."""
    _, fitter, res, zs, psis = fitted
    f = {k: port_drtmd.group_objective(
            fitter, res, zs, psis, resolve_group(fitter, res, zs, psi=psis, device="cpu", **kw))
         for k, kw in (("coupled", {"coupled": True}), ("windowed", {"batched": True}))}
    assert f["coupled"] <= f["windowed"]


def test_group_resolve_rejects_what_is_not_ported(fitted):
    _, fitter, res, zs, _ = fitted
    with pytest.raises(NotImplementedError, match="shared memory"):
        resolve_group(fitter, res, zs, batched=False, device="cpu")
    plain = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="tau_supergrid"):
        resolve_group(plain, res, zs, device="cpu")
    with pytest.raises(NotImplementedError, match="C_inv"):
        resolve.unpack_resolved_x(np.ones((2, 4)), [1.0, 1.0],
                                  {"C_inv": {"index": 0, "nonneg": True, "size": 1}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_group(fitter, res, zs, coupled=True)


def test_group_resolve_warns_on_unconverged(fitted, monkeypatch):
    _, fitter, res, zs, psis = fitted
    orig = resolve.solve_coupled_group

    def stalled(*args, **kwargs):
        x, n_iter, _, info = orig(*args, **kwargs)
        return x, n_iter, 1e3, info

    monkeypatch.setattr(resolve, "solve_coupled_group", stalled)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = resolve_group(fitter, res, zs, psi=psis, coupled=True, device="cpu")
    assert any("did not fully converge" in str(w.message) for w in rec)
    assert out.info["kkt_residual"] == 1e3


def test_windowed_float32_stops_where_jax_does():
    """The map that chip_smoke.py resolves (probe.resolve_map) at 64
    observations, fitted by the port in float32 on the CPU: its 13 windows
    solved in float32 by the port and by the JAX package on the same padded
    blocks stop at the same IP iteration each, and in both some windows stop
    within 6 steps with a KKT
    residual above 100 (a float32 property of the reference's solver,
    ROADMAP Queue 3 item 7), while float64 takes them to KKT < 1e-6."""
    freq, tau_super, p, z = resolve_map(64)
    fitter = BatchedEISFitter(freq, tau_supergrid=tau_super, dtype=torch.float32, device="cpu",
                              qp_max_iter=20, qp_max_iter_warm=4)
    res = fitter.fit(z, adaptive="staged")
    p_all, q_all = port_drtmd.uniform_pq(fitter, res, z)
    blocks = []
    for s, e in port_drtmd.resolve_windows(64, 7, 2):
        idx = np.arange(s, e)
        blk = resolve.prepare_group_blocks(
            p_all[idx], q_all[idx], res.scale[idx], (res.r_inf / res.scale)[idx],
            [fitter.tau_indices] * 7, fitter.special_qp_params, True)
        blocks.append(blk[:5])
    *arrays, _ = resolve.pad_windows(blocks)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        _, info = resolve.solve_resolve_batch(blocks, device="cpu", dtype=dt, return_info=True)
        _, n_j, kkt_j = jax_resolve._coupled_batch_core(
            *(jnp.asarray(a, dtype=jdt) for a in arrays), jnp.asarray(1e-12, jdt),
            jnp.asarray(1e-10, jdt), jnp.asarray(60, jnp.int32), jnp.asarray(200, jnp.int32))
        np.testing.assert_array_equal(info["n_iter"], np.asarray(n_j))
        early = (info["n_iter"] <= 6) & (info["kkt_residual"] > 100)
        if dt == torch.float32:
            assert early.any() and np.array_equal(early, (np.asarray(n_j) <= 6)
                                                  & (np.asarray(kkt_j) > 100))
        else:
            assert np.max(info["kkt_residual"]) < 1e-6 and np.max(np.asarray(kkt_j)) < 1e-6
