"""Port parity: the ragged EIS fitter (hybdrt_torch.BatchedRaggedFitter)
against the JAX BatchedRaggedFitter and the single-spectrum fits, float64 on
the CPU (``device="cpu"``; the fitter's default is the card). The
counterparts of tests/test_ragged.py's EIS tests, at their tolerances:
coefficients within 1e-6 of each observation's max, R_inf within 1e-6, the
same n_iter, padded coefficient tails exactly zero. The JAX fitter runs with
``batch_bucket=False`` where its padding lanes would only cost time. Its
hybrid rows are held in tests/test_torch_ragged_hybrid.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import bench
import hybdrt_tpu
import hybdrt_torch
from hybdrt_tpu.parallel.ragged import BatchedRaggedFitter as JaxRagged
from hybdrt_torch import BatchedEISFitter, BatchedRaggedFitter
from hybdrt_torch.utils.probe import make_het_eis

torch.set_num_threads(1)

TAU_SG = np.logspace(-8, 3, 111)  # 10 ppd supergrid


def _zarc(f, r, tau0, a):
    return r / (1 + (2j * np.pi * f * tau0) ** a)


def _eis_obs(f, rng, tau1=1e-2, tau2=1e-1):
    z = 0.4 + _zarc(f, 1.0, tau1, 0.85) + _zarc(f, 1.5, tau2, 0.9)
    return z + 0.004 * rng.normal(size=len(f)) + 4e-3j * rng.normal(size=len(f))


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(1e-12, np.max(np.abs(b)))


@pytest.fixture(scope="module")
def mixed():
    """tests/test_ragged.py::test_ragged_eis_matches_serial's three
    observations: different grids and basis-window widths."""
    rng = np.random.default_rng(0)
    grids = [np.logspace(5, -1, 57), np.logspace(3, 0, 31), np.logspace(6, -2, 81)]
    obs = [(None, (f, _eis_obs(f, rng))) for f in grids]
    jr = JaxRagged(TAU_SG, batch_bucket=False)
    return obs, jr, jr.fit(obs), BatchedRaggedFitter(TAU_SG, device="cpu").fit(obs)


def test_ragged_eis_matches_serial(mixed):
    obs, _, r_jax, res = mixed
    widths = [r - l for l, r in res.tau_indices]
    assert len(set(widths)) > 1
    assert res.tau_indices == r_jax.tau_indices
    for k, (_, (f, z)) in enumerate(obs):
        for drt in (hybdrt_torch.DRT(tau_supergrid=TAU_SG, warn=False, device="cpu"),
                    hybdrt_tpu.DRT(tau_supergrid=TAU_SG, warn=False)):
            drt.fit_eis(f, z)
            li, ri = res.tau_indices[k]
            assert ri - li == len(drt.fit_parameters["x"])
            assert _rel(res.x[k][:ri - li], drt.fit_parameters["x"]) < 1e-6
            assert abs(res.r_inf[k] - drt.fit_parameters["R_inf"]) < 1e-6
            assert res.n_iter[k] == drt.qphb_params["n_iter"]
        assert np.all(res.x[k][ri - li:] == 0.0)
        assert np.all(res.x_raw[k][2 + ri - li:] == 0.0)


def test_ragged_matches_jax_ragged(mixed):
    _, _, r_jax, res = mixed
    np.testing.assert_array_equal(res.n_iter, r_jax.n_iter)
    np.testing.assert_array_equal(res.converged, r_jax.converged)
    for k in range(len(res.n_iter)):
        assert _rel(res.x[k], r_jax.x[k]) < 1e-6
    for key in ("r_inf", "inductance", "scale"):
        np.testing.assert_allclose(getattr(res, key), getattr(r_jax, key), rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    np.testing.assert_allclose(res.weights, np.asarray(r_jax.weights), rtol=1e-6, atol=1e-10)


def test_pred_stop_rms_ignores_padded_rows():
    """pred_stop averages over real rows only: a short observation padded
    beside a long one stops at the iteration, and the iterate, it stops at
    alone, and at the JAX fitter's."""
    rng = np.random.default_rng(5)
    f_short = np.logspace(4, 0, 17)
    f_long = np.logspace(6, -2, 81)
    obs_short = ((None, None, None), (f_short, _eis_obs(f_short, rng)))
    obs_long = ((None, None, None), (f_long, _eis_obs(f_long, rng)))
    kw = dict(max_iter=30, pred_stop=True, pred_rtol=5e-2)
    solo = BatchedRaggedFitter(TAU_SG, device="cpu", **kw).fit([obs_short])
    both = BatchedRaggedFitter(TAU_SG, device="cpu", **kw).fit([obs_short, obs_long])
    both_jax = JaxRagged(TAU_SG, dtype=jnp.float64, batch_bucket=False, **kw).fit(
        [obs_short, obs_long])
    assert int(both.n_iter[0]) == int(solo.n_iter[0])
    np.testing.assert_array_equal(both.n_iter, both_jax.n_iter)
    li, ri = solo.tau_indices[0]
    n = ri - li
    assert np.allclose(both.x[0][:n], solo.x[0][:n], rtol=1e-8, atol=1e-10)
    assert np.allclose(both.x, both_jax.x, rtol=1e-6, atol=1e-10)


def _shared_grid_obs():
    rng = np.random.default_rng(11)
    freq, freq2 = np.logspace(5, -1, 31), np.logspace(4, 0, 25)
    return [(None, ((freq, freq2)[k % 2], _eis_obs((freq, freq2)[k % 2], rng)))
            for k in range(6)]


def test_batched_prep_matches_per_obs():
    """prepare() rescales the observations of a cached grid in one
    vectorized pass; the batch equals the per-observation build row for row,
    and the JAX fitter's (its EIS keys)."""
    obs = _shared_grid_obs()
    fast = BatchedRaggedFitter(TAU_SG, device="cpu")
    batch_fast = fast.prepare(obs)
    assert len(fast._first_of_proto) == 2
    slow = BatchedRaggedFitter(TAU_SG, device="cpu")
    slow._prep_systems = lambda observations: [slow._prep_obs(c, e) for c, e in observations]
    batch_slow = slow.prepare(obs)
    for key in batch_fast:
        assert np.array_equal(batch_fast[key], batch_slow[key]), key
    assert np.array_equal(fast._scales, slow._scales)
    assert fast._tau_indices == slow._tau_indices
    assert np.array_equal(fast._proto_index, slow._proto_index)
    for key in fast._uniq:
        assert np.array_equal(fast._uniq[key], slow._uniq[key]), key

    jf = JaxRagged(TAU_SG, batch_bucket=False)
    batch_jax = jf.prepare(obs)
    for key in ("rzv", "var_floor"):
        np.testing.assert_allclose(batch_fast[key], batch_jax[key], rtol=1e-12, atol=0)
    np.testing.assert_allclose(fast._scales, jf._scales, rtol=1e-12)
    assert fast._tau_indices == jf._tau_indices
    np.testing.assert_array_equal(fast._proto_index, jf._proto_index)
    for key in fast._uniq:
        want = jf._uniq[key]
        assert fast._uniq[key].shape == want.shape, key
        assert np.max(np.abs(fast._uniq[key] - want)) <= 1e-12 * np.max(np.abs(want)), key


def test_sys_cache_fast_path_matches_serial_prep():
    """The second observation of a grid takes the cached system and redoes
    only its scaling: equal to a fresh fitter's full prep of it, and sharing
    the first observation's matrices."""
    obs = _shared_grid_obs()
    fitter = BatchedRaggedFitter(TAU_SG, device="cpu")
    systems = [fitter._prep_obs(c, e) for c, e in obs[:4]]
    for k in (2, 3):
        slow = BatchedRaggedFitter(TAU_SG, device="cpu")._prep_obs(*obs[k])
        fast = systems[k]
        assert fast["rzm"] is systems[k - 2]["rzm"]
        for key in ("coefficient_scale", "impedance_scale"):
            assert fast[key] == pytest.approx(slow[key], rel=1e-12)
        np.testing.assert_allclose(fast["rzv"], slow["rzv"], rtol=0, atol=1e-14)
        for key in ("rzm", "vmm", "m_stack", "lb", "l1_lambda_vector", "basis_tau"):
            np.testing.assert_array_equal(fast[key], slow[key])
    # data-dependent fit kwargs turn the fast path off
    off = BatchedRaggedFitter(TAU_SG, device="cpu", fit_kw={"solve_rp": True})
    a, b = (off._prep_obs(c, e) for c, e in obs[:3:2])
    assert a["rzm"] is not b["rzm"]


def test_from_systems_matches_jax_loop(mixed):
    """The port's loop on the JAX package's own prep-only systems: the JAX
    ragged fit's x within 1e-8, independent of the port's assembly."""
    _, jr, r_jax, _ = mixed
    res = BatchedRaggedFitter.from_systems(jr._systems, TAU_SG, device="cpu").fit()
    np.testing.assert_array_equal(res.n_iter, r_jax.n_iter)
    np.testing.assert_allclose(res.x, r_jax.x, rtol=0, atol=1e-8)
    assert res.tau_indices == r_jax.tau_indices


def test_uniform_grid_matches_batched_eis_fitter():
    """A batch on one grid through the ragged fitter (no padding) matches
    BatchedEISFitter on the same spectra within rtol 1e-6."""
    freq = np.logspace(5, -1, 31)
    rng = np.random.default_rng(2)
    z = np.stack([_eis_obs(freq, rng, tau1=10 ** rng.uniform(-3, -2)) for _ in range(5)])
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)
    r_b = BatchedEISFitter(freq, tau_supergrid=TAU_SG, device="cpu", **kw).fit(z)
    r_r = BatchedRaggedFitter(TAU_SG, device="cpu", **kw).fit([(None, (freq, zz)) for zz in z])
    np.testing.assert_array_equal(r_r.n_iter, r_b.n_iter)
    np.testing.assert_allclose(r_r.x, r_b.x, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(r_r.r_inf, r_b.r_inf, rtol=1e-6, atol=1e-10)


def test_adaptive_modes_are_one_loop(mixed):
    """adaptive=True and "staged" run the live-lane loop: bitwise False's."""
    obs, _, _, res = mixed
    fitter = BatchedRaggedFitter(TAU_SG, device="cpu")
    for mode in (True, "staged"):
        r = fitter.fit(obs, adaptive=mode)
        np.testing.assert_array_equal(r.x_raw, res.x_raw)
        np.testing.assert_array_equal(r.n_iter, res.n_iter)


def test_final_predictions(mixed):
    """final_predictions: each observation's model on its own grid, zero on
    the padded rows."""
    obs, _, _, _ = mixed
    fitter = BatchedRaggedFitter(TAU_SG, device="cpu")
    res = fitter.fit(obs)
    y = fitter.final_predictions(res)
    for k, (_, (f, z)) in enumerate(obs):
        nf = len(f)
        z_hat = (y[k, :nf] + 1j * y[k, nf:2 * nf]) * res.scale[k]
        assert np.median(np.abs(z_hat - z) / np.abs(z)) < 0.02
        assert np.all(y[k, 2 * nf:] == 0.0)


@pytest.mark.parametrize("make,err", [
    (lambda o: BatchedRaggedFitter(TAU_SG, device="cpu").fit(o, phase_budgets=(8, 16)),
     ValueError),
    (lambda o: BatchedRaggedFitter(TAU_SG, device="cpu").fit(o, staged_capacities=(2, 1)),
     ValueError),
    (lambda o: BatchedRaggedFitter(TAU_SG, device="cpu").fit(o, staged_buckets=2), ValueError),
    (lambda o: BatchedRaggedFitter(TAU_SG, device="cpu").fit(o, adaptive="fast"), ValueError),
    (lambda o: BatchedRaggedFitter(TAU_SG, device="cpu", mesh=object()), NotImplementedError),
    (lambda o: BatchedRaggedFitter(TAU_SG, device="cpu", batch_bucket=True), TypeError),
    (lambda o: BatchedRaggedFitter(TAU_SG, device="cpu", l2_lambda=1.0), ValueError),
], ids=["phase_budgets", "capacities", "buckets", "adaptive", "mesh", "batch_bucket",
        "hyper_typo"])
def test_rejects(make, err):
    obs = _shared_grid_obs()[:2]
    with pytest.raises(err):
        make(obs)


def test_make_het_eis_is_the_bench_map():
    """utils/probe.py::make_het_eis gives the EIS observations of
    bench.make_het_map, in its order, value for value (a small map)."""
    md = bench.make_het_map(24, 8)
    want = [md.get_obs_data(i)[1] for i in range(md.num_obs)
            if md.get_obs_data(i)[0][0] is None]
    obs, tau = make_het_eis(24, 8)
    assert len(obs) == len(want) == 24
    for (_, (f, z)), (fw, zw) in zip(obs, want):
        np.testing.assert_array_equal(f, fw)
        np.testing.assert_array_equal(z, zw)
    np.testing.assert_array_equal(tau, np.logspace(-8, 3, 111))

