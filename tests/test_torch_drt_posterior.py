"""Port parity: the single fit's posterior, likelihoods, diagnostics and
peaks (hybdrt_torch.DRT, models/drt.py) against the JAX DRT on the same
spectra, float64 on the CPU; and the QP's library factor route
(ops/qp.py), which takes matrices above the lane kernels' tile rule.

Spectra: the quick start's (examples/quickstart.py:34-40), the golden one
(tests/test_drt_fit_golden.py, its hyperparameters) and
tests/test_multi_misc.py::test_drt_parity_methods' without DOP, fitted
nonneg and signed (``nonneg=False``). Held:

- peak indices and masks equal (scipy's ``find_peaks`` on the same host
  arrays), peak readouts (quantify_peaks, peak distributions, split_r_p,
  integrate_drt) within the fit tolerance of tests/test_torch_drt.py;
- rss, llh and bic on the same fit state within 1e-10 relative. The
  log-marginal likelihood takes log det P and log det Omega by LU
  (``slogdet``) of a P it assembles, and at these posteriors' cond(P)
  (1e14-1e17) the rounding of P and of the LU moves log det P by 1e-4-1e-2
  between the packages: lml is held within the first-order bound
  1/2 sum |M^-1| |dM| over both matrices (dM the assembly's and the LU's
  rounding, componentwise), plus 1e-10 relative;
- the parameter covariance within max(1e-6, cond(P) max(eps, dP)) of its
  max |cov| (tests/test_torch_cov.py's bound, ``probe.cov_bound``), the port's inverse a
  backward-stable inverse of its P; each distribution variance (orders 0-3)
  within its first-order readout bound (``probe.variance_errors``), the
  whole distribution covariance within the parameter bound carried through
  |E| |C| |E|^T; the CI band within sigma's bound (half the variance's) and
  the fit tolerance; each probability within what the two fits' means and
  variances allow through the normal CDF (``probe.prob_bounds``: its slope
  is at most 1/sqrt(2 pi) per unit of the standardized value), a bound at
  most ``probe.PROB_HOLD`` (0.05) at every point;
- the Fisher matrix within 1e-12 of its max and positive semidefinite
  relative to its largest eigenvalue (n eps lambda_max);
- the library route: SPD solves against ``torch.linalg.solve``, NaN for a
  negative pivot, ``solve_qp_box`` at B = 1, n = 300 against the JAX
  unbatched solve (x within 1e-10, the same iterations), and a DRT whose
  basis exceeds the float64 tile rule fitted against the JAX DRT.
"""
import copy

import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_tpu.ops.qp import solve_qp_box as jax_solve_qp_box
from hybdrt_torch.ops import basis as basis_mod
from hybdrt_torch.ops import chol_lane, mat1d, qp
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

EPS = np.finfo(float).eps
FIT_RTOL, FIT_ATOL = 1e-6, 1e-10


def _parity_spectrum():
    """tests/test_multi_misc.py:91-95."""
    rng = np.random.default_rng(0)
    f = np.logspace(5, -1, 41)
    w = 2j * np.pi * f
    z = 0.4 + 1.0 / (1 + (w * 1e-3) ** 0.9) + 0.8 / (1 + (w * 1e-1) ** 0.85)
    return f, z + rng.normal(0, 1e-3, 41) + 1j * rng.normal(0, 1e-3, 41)


SPECTRA = {
    "quickstart": (probe.quickstart_eis, {}),
    "golden": (lambda: probe.golden_fit()[:2], dict(probe.GOLDEN_HYPERS)),
    "parity": (_parity_spectrum, {}),
    "signed": (_parity_spectrum, {"nonneg": False}),
}


@pytest.fixture(scope="module")
def fits():
    out = {}
    for name, (data, kw) in SPECTRA.items():
        freq, z = data()
        dj = hybdrt_tpu.DRT(warn=False)
        dj.fit_eis(freq, z, **kw)
        dt = hybdrt_torch.DRT(warn=False, device="cpu").fit_eis(freq, z, **kw)
        out[name] = (dj, dt)
    return out


def _close(a, b, rtol=FIT_RTOL, atol=FIT_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(SPECTRA))
def test_fits_agree(fits, name):
    dj, dt = fits[name]
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    _close(dt.fit_parameters["x"], dj.fit_parameters["x"])
    assert dt.fit_kwargs["nonneg"] == dj.fit_kwargs["nonneg"]
    assert set(dt.fit_kwargs) <= set(dj.fit_kwargs)


# ---------------------------------------------------------------------------
# The posterior
# ---------------------------------------------------------------------------
def _p(d):
    return np.asarray(d.qphb_params["p_matrix"])


@pytest.mark.parametrize("name", list(SPECTRA))
def test_param_cov_within_conditioning_bound(fits, name):
    dj, dt = fits[name]
    cov_j, cov_t = np.asarray(dj.estimate_param_cov()), dt.estimate_param_cov()
    bound = probe.cov_bound(_p(dt), _p(dj))
    assert np.max(np.abs(cov_t - cov_j)) <= bound * np.max(np.abs(cov_j))
    # the port's inverse (solver units) is a backward-stable inverse of its P
    inv = mat1d.invert_psd(torch.as_tensor(_p(dt))).numpy()
    assert probe.inverse_residual(_p(dt)[None], inv[None])[0] <= _p(dt).shape[0] * EPS
    # physical units: the DRT block by coefficient_scale^2
    ns = dt.get_qp_mat_offset()
    np.testing.assert_allclose(cov_t[ns:, ns:], inv[ns:, ns:] * dt.coefficient_scale ** 2,
                               rtol=1e-12)


def _em(d, tau, order):
    return basis_mod.func_eval_matrix_host(np.log(d.basis_tau), np.log(tau), "gaussian",
                                           d.tau_epsilon, order)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("name", list(SPECTRA))
def test_distribution_cov_orders(fits, name, order):
    """estimate_distribution_cov at orders 0-3 on a grid one decade beyond
    the basis (``extend_var`` extrapolates there)."""
    dj, dt = fits[name]
    tau = dt.get_tau_eval(10, extend_decades=1)
    cj = np.asarray(dj.estimate_distribution_cov(tau=tau, order=order))
    ct = dt.estimate_distribution_cov(tau=tau, order=order)
    err, bound = probe.variance_errors(np.diag(ct), np.diag(cj), _p(dt), _p(dj),
                                       _em(dt, tau, order), dt.get_qp_mat_offset(), tau,
                                       dt.basis_tau)
    assert np.all(err <= bound + 1e-12), (err.max(), bound[np.argmax(err - bound)])
    # the whole matrix: the parameter bound through |E| |C| |E|^T
    ns = dt.get_qp_mat_offset()
    c_drt = np.abs(np.asarray(dj.estimate_param_cov())[ns:, ns:])
    e_abs = np.abs(_em(dt, tau, order))
    inside = (tau >= dt.basis_tau[0]) & (tau <= dt.basis_tau[-1])
    whole = probe.cov_bound(_p(dt), _p(dj)) * (e_abs @ c_drt @ e_abs.T)
    assert np.all(np.abs(ct - cj)[np.ix_(inside, inside)] <= whole[np.ix_(inside, inside)]
                  + 1e-12 * np.max(np.abs(cj)))


@pytest.mark.parametrize("name", ["quickstart", "parity"])
def test_distribution_cov_options(fits, name):
    """``normalize`` and ``var_floor`` and the default grid, against JAX's."""
    dj, dt = fits[name]
    for kw in ({"normalize": True}, {"var_floor": 1e3}, {"extend_var": False, "ppd": 7}):
        cj = np.asarray(dj.estimate_distribution_cov(**kw))
        ct = dt.estimate_distribution_cov(**kw)
        assert ct.shape == cj.shape
        tau = dt.get_tau_eval(kw.get("ppd", 20))
        err, bound = probe.variance_errors(np.diag(ct), np.diag(cj), _p(dt), _p(dj),
                                           _em(dt, tau, 0), dt.get_qp_mat_offset())
        floored = np.diag(cj) == kw.get("var_floor")
        assert np.all((err <= bound + 1e-6)[~floored])
        assert np.array_equal(np.diag(ct) == kw.get("var_floor"), floored)


@pytest.mark.parametrize("name", list(SPECTRA))
def test_ci_band(fits, name):
    """predict_drt_ci and its alias: each point within the fit tolerance of
    the mean plus z_q times sigma's bound (half the variance's)."""
    dj, dt = fits[name]
    tau = dt.get_tau_eval(20)
    lo_j, hi_j = (np.asarray(a) for a in dj.predict_drt_ci(tau=tau))
    lo_t, hi_t = dt.predict_distribution_ci(tau=tau)
    var_j = np.diag(np.asarray(dj.estimate_distribution_cov(tau=tau)))
    var_t = np.diag(dt.estimate_distribution_cov(tau=tau))
    _, bound = probe.variance_errors(var_t, var_j, _p(dt), _p(dj), _em(dt, tau, 0),
                                     dt.get_qp_mat_offset())
    mu = np.abs(dj.predict_distribution(tau))
    tol = FIT_RTOL * mu + FIT_ATOL + 1.96 * np.sqrt(var_j) * (0.5 * bound + 1e-12)
    assert np.all(np.abs(lo_t - lo_j) <= tol) and np.all(np.abs(hi_t - hi_j) <= tol)
    assert np.all(hi_t >= lo_t)


# ---------------------------------------------------------------------------
# Likelihoods and diagnostics
# ---------------------------------------------------------------------------
def _on_jax_state(dj, dt):
    """The port's DRT carrying the JAX fit's state."""
    d = copy.copy(dt)
    d.qphb_params, d.fit_parameters = dj.qphb_params, dj.fit_parameters
    d.coefficient_scale = dj.coefficient_scale
    return d


@pytest.mark.parametrize("name", list(SPECTRA))
def test_likelihoods_on_the_same_state(fits, name):
    dj, dt = fits[name]
    d = _on_jax_state(dj, dt)
    for fn in ("evaluate_rss", "evaluate_llh", "evaluate_bic"):
        assert getattr(d, fn)() == pytest.approx(getattr(dj, fn)(), rel=1e-10), fn
    assert d.evaluate_llh(marginalize_weights=False) == pytest.approx(
        dj.evaluate_llh(marginalize_weights=False), rel=1e-10)
    np.testing.assert_allclose(d._raw_x(), dj._raw_x(), rtol=1e-14, atol=0)
    # lml: first order in the rounding of P = Omega + A^T A and of each LU
    qpp = dj.qphb_params
    bound = probe.lml_bound(_p(dj), qpp["rm"] * qpp["weights"][:, None])
    lml_j = dj.evaluate_lml()
    assert abs(d.evaluate_lml() - lml_j) <= bound + 1e-10 * abs(lml_j)


@pytest.mark.parametrize("name", list(SPECTRA))
def test_likelihoods_of_the_port_fit(fits, name):
    """On the port's own fit: within the fit tolerance of the JAX fit's."""
    dj, dt = fits[name]
    for fn in ("evaluate_rss", "evaluate_llh", "evaluate_bic"):
        assert getattr(dt, fn)() == pytest.approx(getattr(dj, fn)(), rel=FIT_RTOL), fn
    assert dt.num_data == dj.num_data


@pytest.mark.parametrize("name", list(SPECTRA))
def test_diagnostics(fits, name):
    dj, dt = fits[name]
    d = _on_jax_state(dj, dt)
    for weighted in (True, False):
        fim_j = np.asarray(dj.fisher_matrix(weighted=weighted))
        assert np.max(np.abs(d.fisher_matrix(weighted=weighted) - fim_j)) \
            <= 1e-12 * np.max(np.abs(fim_j))
        # the port's own fit: within the fit tolerance
        assert np.max(np.abs(dt.fisher_matrix(weighted=weighted) - fim_j)) \
            <= FIT_RTOL * np.max(np.abs(fim_j))
    fim_t = dt.fisher_matrix()
    lam = np.linalg.eigvalsh(fim_t)
    assert lam.min() >= -fim_t.shape[0] * EPS * lam.max()
    _close(dt.predict_sigma("eis"), dj.predict_sigma("eis"))
    assert dt.predict_sigma("chrono") is None
    with pytest.raises(ValueError):
        dt.predict_sigma("bogus")
    for kw in ({}, {"weights": "modulus"}):
        assert dt.evaluate_chi_sq(**kw) == pytest.approx(dj.evaluate_chi_sq(**kw), rel=FIT_RTOL)
    with pytest.raises(ValueError):
        dt.evaluate_chi_sq(weights=np.ones(3))
    assert dt.get_drt_norm(False) == 1.0 and dt.get_drt_norm(True, normalize_by=2.0) == 2.0
    assert dt.get_drt_norm(True) == pytest.approx(dj.get_drt_norm(True), rel=FIT_RTOL)
    assert dt.default_dist_sign() == dj.default_dist_sign() == 1
    np.testing.assert_allclose(dt.get_data_tau_limits(), dj.get_data_tau_limits(), rtol=1e-14)
    assert np.allclose(dt.predict_v_baseline(np.linspace(0, 1, 5)), 0)


def test_parity_methods_without_dop(fits):
    """tests/test_multi_misc.py::test_drt_parity_methods' assertions on its
    spectrum, fitted without DOP (tests/test_torch_dop_drt.py holds them on
    the DOP fit), and the JAX package's values on the same fit."""
    dj, drt = fits["parity"]
    f, _ = _parity_spectrum()
    tau = np.logspace(-6, 2, 80)
    lo, hi = drt.predict_distribution_ci(tau=tau)
    assert np.all(hi >= lo)
    areas = drt.split_r_p([1e-2])
    assert areas.shape == (2,)
    assert abs(np.sum(areas) - drt.predict_r_p()) < 0.05
    assert abs(areas[0] - 1.0) < 0.15 and abs(areas[1] - 0.8) < 0.15
    assert drt.evaluate_chi_sq() < 1e-4
    assert drt.evaluate_chi_sq(weights="modulus") < 1e-4
    fim = drt.fisher_matrix()
    assert fim.shape[0] == fim.shape[1]
    assert drt.predict_sigma("eis").shape == f.shape
    tmin, tmax = drt.get_data_tau_limits()
    assert tmin < 1e-5 and tmax > 1e-1
    tau_f = np.logspace(-5, 1, 600)
    prob = drt.predict_peak_prob(tau_f)
    assert prob.max() > 0.9
    pk = drt.find_peaks_byprob(tau_f, height=0.3)
    assert len(pk) >= 1
    assert np.any(np.abs(np.log10(pk) - (-1)) < 0.3)
    np.testing.assert_array_equal(pk, dj.find_peaks_byprob(tau_f, height=0.3))
    assert drt.integrate_distribution(1e-4, 1e0) == pytest.approx(drt.integrate_drt(1e-4, 1e0))
    _close(drt.integrate_drt(1e-4, 1e0), dj.integrate_drt(1e-4, 1e0))
    _close(areas, dj.split_r_p([1e-2]))


# ---------------------------------------------------------------------------
# Peaks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["thresh", "prob"])
@pytest.mark.parametrize("name", list(SPECTRA))
def test_find_peaks_equal(fits, name, method):
    dj, dt = fits[name]
    tj, tau_j, idx_j, info_j = dj.find_peaks(method=method, return_info=True)
    tt, tau_t, idx_t, info_t = dt.find_peaks(method=method, return_info=True)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(tt, tj)
    assert set(info_t) == set(info_j)
    for k in info_j:
        if k in ("probs",):
            continue
        _close(info_t[k], info_j[k], rtol=1e-6, atol=1e-8)
    for kw in ({"normalize": False}, {"num_peaks": 1, "method": "prob"}, {"ppd": 20}):
        np.testing.assert_array_equal(dt.find_peaks(**kw), dj.find_peaks(**kw))
    with pytest.raises(ValueError):
        dt.find_peaks(method="bogus")


@pytest.mark.parametrize("name", list(SPECTRA))
def test_peak_readouts(fits, name):
    dj, dt = fits[name]
    _close(dt.quantify_peaks(), dj.quantify_peaks())
    _close(dt.estimate_peak_distributions(), dj.estimate_peak_distributions())
    _close(dt.estimate_peak_drts(ppd=5), dj.estimate_peak_drts(ppd=5))
    _close(dt.estimate_peak_coef(), dj.estimate_peak_coef())
    for kw in ({}, {"resolve_peaks": True}, {"ppd": 10}):
        _close(dt.split_r_p([1e-2], **kw), dj.split_r_p([1e-2], **kw))
    _close(dt.integrate_drt(1e-5, 1e0), dj.integrate_drt(1e-5, 1e0))
    with pytest.raises(ValueError):
        dt.estimate_peak_coef(peak_indices=[3])


@pytest.mark.parametrize("name", list(SPECTRA))
def test_peak_probabilities(fits, name):
    """predict_peak_trough_probs and predict_peak_prob point by point
    (``probe.prob_bounds``): the variances of orders 0-2 within their
    readout bounds, and each probability within what the two fits' means
    and variances allow through the normal CDF, a bound at most
    ``probe.PROB_HOLD`` at every point. find_peaks_byprob gives the same
    indices."""
    dj, dt = fits[name]
    tau = dt.get_tau_eval(10)
    inputs = probe.drt_prob_inputs(dt, dj, tau)
    assert inputs["var_excess"] <= 1e-12
    pj, tj = (np.asarray(a) for a in dj.predict_peak_trough_probs(tau))
    pt, tt = dt.predict_peak_trough_probs(tau)
    maps = {"peak": (pt, pj), "trough": (tt, tj),
            "peak_prob": (dt.predict_peak_prob(tau), np.asarray(dj.predict_peak_prob(tau)))}
    for kind, (a, b) in maps.items():
        bound = probe.prob_bounds(kind, inputs["mus"], inputs["mus_ref"], inputs["var"],
                                  inputs["var_ref"], floor=True)
        held, excess, _ = probe.held_probabilities(a, b, bound)
        assert held.all() and excess <= 0, (kind, held.mean(), excess)
        assert np.all((a >= 0) & (a <= 1))
    np.testing.assert_array_equal(dt.find_peaks_byprob(), dj.find_peaks_byprob())
    # without the posterior both read the same local std filter
    _close(dt.predict_peak_prob(bayes_cov=False), dj.predict_peak_prob(bayes_cov=False),
           rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# The library factor route
# ---------------------------------------------------------------------------
def _spd(n, seed, dtype=torch.float64, b=2):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n))
    return (torch.as_tensor(a @ a.transpose(0, 2, 1) / n + np.eye(n), dtype=dtype),
            torch.as_tensor(rng.normal(size=(b, n)), dtype=dtype))


@pytest.mark.parametrize("dtype,n", [(torch.float64, 189), (torch.float64, 300),
                                     (torch.float32, 269)])
def test_library_route_solves(dtype, n, monkeypatch):
    """Above the tile rule every SPD routine takes the library route, never
    the lane wrappers, and solves as ``torch.linalg.solve`` does."""
    assert qp.library_route(n, dtype)
    assert not qp.library_route({torch.float64: 188, torch.float32: 268}[dtype], dtype)
    a, b = _spd(n, 1, dtype)

    def lane(*args):
        raise AssertionError("a lane wrapper was called above the tile rule")

    for name in chol_lane.LAUNCHES:
        monkeypatch.setattr(chol_lane, name, lane)
    chol_lane.reset_launch_counts()
    ref = torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    tol = 200 * torch.finfo(dtype).eps * float(ref.abs().max())
    x, l = qp.spd_factor_solve(a, b)
    assert float((x - ref).abs().max()) <= tol
    assert float((qp.spd_solve_factored(l, b) - ref).abs().max()) <= tol
    assert float((qp.spd_solve(a, b) - ref).abs().max()) <= tol
    assert torch.equal(torch.tril(qp.spd_factor(a)), torch.tril(l))
    assert all(v == 0 for v in chol_lane.LAUNCHES.values())


def test_library_route_nan_contract():
    """A lane whose pivot is not positive gets NaN in its factor and x; its
    neighbour solves as usual."""
    a, b = _spd(200, 2)
    a[1, 50, 50] = -1.0
    x, l = qp.spd_factor_solve(a, b)
    assert torch.isnan(x[1]).all() and torch.isnan(l[1]).all()
    assert torch.isfinite(x[0]).all() and torch.isfinite(l[0]).all()
    assert torch.isnan(qp.spd_solve(a, b)[1]).all()
    assert torch.isnan(qp.spd_factor(a)[1]).all()


def test_routes_by_size():
    """The route is chosen by size alone: QPs at and below the tile rule go
    through the lane wrappers, larger ones through the library."""
    chol_lane.reset_launch_counts()
    for n in (50, 188, 189):
        a, b = _spd(n, 3, b=1)
        qp.solve_qp_box(a, b, torch.zeros(1, n, dtype=torch.float64))
    assert chol_lane.QP_ROUTES == {"lane": 2, "library": 1, "fused_plain": 0}


def test_solve_qp_box_at_one_lane_matches_jax():
    """A B = 1 QP of n = 300 (the library route) against the JAX package's
    unbatched solve_qp_box: x within 1e-10 of max |x|, the same iterations."""
    n = 300
    rng = np.random.default_rng(5)
    a = rng.normal(size=(n, n))
    p = a @ a.T / n + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    lb = np.zeros(n)
    ref = jax_solve_qp_box(p, q, lb)
    chol_lane.reset_launch_counts()
    out = qp.solve_qp_box(*(torch.as_tensor(v)[None] for v in (p, q, lb)))
    x_j = np.asarray(ref.x)
    assert np.max(np.abs(out.x[0].numpy() - x_j)) <= 1e-10 * np.max(np.abs(x_j))
    assert int(out.iterations[0]) == int(ref.iterations)
    assert 0 < np.sum(x_j == 0) < n
    assert chol_lane.QP_ROUTES == {"lane": 0, "library": 1, "fused_plain": 0}


def test_wide_basis_fits_through_the_library_route():
    """A basis of 200 functions (n = 202 > 188, the float64 tile rule): the
    DRT fits through the library route and matches the JAX DRT, which
    factors any n with LAPACK."""
    freq, z = probe.quickstart_eis()
    basis = np.logspace(-7, 2, 200)
    dj = hybdrt_tpu.DRT(fixed_basis_tau=basis, warn=False)
    dj.fit_eis(freq, z, max_iter=10)
    chol_lane.reset_launch_counts()
    dt = hybdrt_torch.DRT(fixed_basis_tau=basis, warn=False, device="cpu").fit_eis(
        freq, z, max_iter=10)
    assert chol_lane.QP_ROUTES["library"] > 0 and chol_lane.QP_ROUTES["lane"] == 0
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    _close(dt.fit_parameters["x"], dj.fit_parameters["x"])
    assert dt.fit_parameters["R_inf"] == pytest.approx(dj.fit_parameters["R_inf"], rel=FIT_RTOL)


# ---------------------------------------------------------------------------
# The functions under the methods
# ---------------------------------------------------------------------------
def test_qphb_likelihood_functions():
    """solver/qphb.py's evaluate_rss and evaluate_llh (row_mask,
    include_constants, both forms of the weights' prior) against the JAX
    functions on the same lanes, within 1e-12 relative."""
    import jax.numpy as jnp
    from hybdrt_tpu.solver import qphb as jax_qphb
    from hybdrt_torch.solver import qphb as port_qphb

    rng = np.random.default_rng(11)
    m, n = 30, 12
    rm = rng.normal(size=(m, n))
    x, rv = rng.normal(size=n), rng.normal(size=m)
    w = rng.uniform(0.5, 2.0, m)
    mask = (np.arange(m) < 24).astype(float)
    t = lambda a: torch.as_tensor(a)[None]
    assert port_qphb.evaluate_rss(t(x), torch.as_tensor(rm), t(rv), t(w))[0].item() \
        == pytest.approx(float(jax_qphb.evaluate_rss(x, rm, rv, w)), rel=1e-12)
    for kw in ({}, {"marginalize_weights": False}, {"include_constants": True},
               {"row_mask": mask}, {"row_mask": mask, "include_constants": True,
                                    "alpha_0": 3.0, "beta_0": 0.5}):
        ref = float(jax_qphb.evaluate_llh(x, rm, rv, w, **{
            k: jnp.asarray(v) if k == "row_mask" else v for k, v in kw.items()}))
        got = port_qphb.evaluate_llh(t(x), torch.as_tensor(rm), t(rv), t(w), **{
            k: t(v) if k == "row_mask" else v for k, v in kw.items()})[0].item()
        assert got == pytest.approx(ref, rel=1e-12), kw


def test_invert_psd_matches_jax():
    """mat1d.invert_psd: the Cholesky inverse of an SPD matrix, the general
    inverse of one without a factor (the JAX function's NaN fallback), and
    a batch of both, matrix by matrix."""
    from hybdrt_tpu.ops import mat1d as jax_mat1d

    rng = np.random.default_rng(12)
    a = rng.normal(size=(20, 20))
    spd = a @ a.T + np.eye(20)
    indefinite = spd - 40 * np.eye(20)
    for m in (spd, indefinite):
        ref = np.asarray(jax_mat1d.invert_psd(m))
        got = mat1d.invert_psd(torch.as_tensor(m)).numpy()
        assert np.max(np.abs(got - ref)) <= 1e-10 * np.max(np.abs(ref))
        assert np.max(np.abs(mat1d.invert_psd(torch.as_tensor(m), use_cholesky=False).numpy()
                             - np.linalg.inv(m))) <= 1e-10 * np.max(np.abs(ref))
    both = mat1d.invert_psd(torch.as_tensor(np.stack([spd, indefinite]))).numpy()
    np.testing.assert_allclose(both[0], mat1d.invert_psd(torch.as_tensor(spd)).numpy(),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(both[1], np.linalg.inv(indefinite), rtol=1e-9, atol=1e-12)


def test_chi_sq_matches_jax():
    from hybdrt_tpu import evaluation as jax_evaluation
    from hybdrt_torch import evaluation

    rng = np.random.default_rng(13)
    y = rng.normal(size=9) + 1j * rng.normal(size=9)
    y_hat = y + 0.01 * (rng.normal(size=9) + 1j * rng.normal(size=9))
    for weights in (None, rng.uniform(size=9), rng.uniform(size=9) + 1j * rng.uniform(size=9)):
        assert evaluation.chi_sq(y, y_hat, weights) == pytest.approx(
            jax_evaluation.chi_sq(y, y_hat, weights), rel=1e-14)
    assert evaluation.chi_sq(y.real, y_hat.real) == pytest.approx(
        jax_evaluation.chi_sq(y.real, y_hat.real), rel=1e-14)
