"""Port parity: the single fit with the distribution of phasances
(hybdrt_torch.DRT(fit_dop=True), models/drt.py) against the JAX DRT on the
same spectra, float64 on the CPU.

Spectra: tests/test_parallel.py:292's (a ZARC and a constant-phase term)
and tests/test_multi_misc.py::test_drt_parity_methods' (two ZARCs), each
fitted once per module by both packages (``chip_smoke.py`` phase 18c holds
tests/test_edge_cases.py:118's inductive spectrum, card against CPU); the
first also with ``solve_rp`` (the DOP
columns' in-place rescale, ``hybdrt_tpu/models/drt.py:1222-1231``) and with
``normalize_dop=False``. Held: the same iteration count, x and x_dop within
1e-6 of max |x| (``FIT_TOL``); the predictions and the DOP's readouts
(``predict_dop`` at orders 0-1, normalized or not, ``get_dop_norm``,
``get_dop_params``, the DOP columns' scale) within the same; the DOP's
posterior covariance and credible band within their first-order readout
bounds (``probe.readout_errors``: the posteriors reach cond(P) 1e16-1e17);
and the assertions of tests/test_multi_misc.py::test_drt_parity_methods on
the DOP fit (ROADMAP Queue 3 item 1), the Fisher matrix positive
semidefinite relative to its largest eigenvalue.

The capacitance column and the DOP's other forms: the delta nu basis on
``fixed_basis_nu`` (nu = 0 among its points, which ``predict_r_inf`` adds to
R_inf), and chrono and hybrid fits with the DOP and the capacitance
(galvanostatic data, ideal steps: ``ops/phasance.py::construct_phasor_v_matrix``,
``mat1d.construct_capacitance_response_vector``; the hybrid fit's EIS rows
carry ``construct_phasor_z_matrix`` and the capacitance's impedance), each
fitted once per module by both packages. Held: the same iteration count,
x, x_dop, C_inv and the other special parameters within ``FIT_TOL`` of max
|x|, the predictions within the same; the capacitance's column scale in the
physical covariance. The EIS-only capacitance fit is held against the
port's serial fit by tests/test_torch_dop_batch.py, and on the card by
``chip_smoke.py`` 18c. One module holds them all, so that the JAX package
compiles its DOP fit once.
"""
import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_torch.ops import basis as basis_mod, mat1d, phasance
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

EPS = np.finfo(float).eps
FIT_TOL = 1e-6


def _parallel_spectrum():
    """tests/test_parallel.py:296-300."""
    rng = np.random.default_rng(0)
    f = np.logspace(5, -2, 51)
    w = 2j * np.pi * f
    z = 0.4 + 1.0 / (1 + (w * 1e-2) ** 0.9) + 0.05 * (w ** -0.5)
    return f, z + rng.normal(0, 1e-3, 51) + 1j * rng.normal(0, 1e-3, 51)


def _parity_spectrum():
    """tests/test_multi_misc.py:91-95."""
    rng = np.random.default_rng(0)
    f = np.logspace(5, -1, 41)
    w = 2j * np.pi * f
    z = 0.4 + 1.0 / (1 + (w * 1e-3) ** 0.9) + 0.8 / (1 + (w * 1e-1) ** 0.85)
    return f, z + rng.normal(0, 1e-3, 41) + 1j * rng.normal(0, 1e-3, 41)


# name: (spectrum, constructor keywords, fit keywords)
FITS = {
    "parallel": (_parallel_spectrum, {}, {}),
    "solve_rp": (_parallel_spectrum, {}, {"solve_rp": True}),
    "unnormalized": (_parallel_spectrum, {"normalize_dop": False}, {}),
    "parity": (_parity_spectrum, {}, {}),
}


@pytest.fixture(scope="module")
def fits():
    out = {}
    for name, (data, ctor, kw) in FITS.items():
        f, z = data()
        dj = hybdrt_tpu.DRT(warn=False, fit_dop=True, **ctor)
        dj.fit_eis(f, z, **kw)
        dt = hybdrt_torch.DRT(warn=False, fit_dop=True, device="cpu", **ctor).fit_eis(f, z, **kw)
        out[name] = (dj, dt, f)
    return out


NU_DELTA = np.linspace(-1, 1, 21)


def _fit_option(drt, kind):
    if kind == "delta":
        return drt.fit_eis(*_parallel_spectrum())
    times, i_sig, v, f, z = probe.hybrid_data()
    if kind == "chrono":
        return drt.fit_chrono(times, i_sig, v)
    return drt.fit_hybrid(times, i_sig, v, f, z)


# name: constructor keywords
CONFIGS = {
    "delta": {"fit_dop": True, "nu_basis_type": "delta", "fixed_basis_nu": NU_DELTA},
    "chrono": {"fit_dop": True, "fit_capacitance": True},
    "hybrid": {"fit_dop": True, "fit_capacitance": True},
}


@pytest.fixture(scope="module")
def option_fits():
    out = {}
    for name, kw in CONFIGS.items():
        dj = hybdrt_tpu.DRT(warn=False, **kw)
        _fit_option(dj, name)
        dt = hybdrt_torch.DRT(warn=False, device="cpu", **kw)
        _fit_option(dt, name)
        out[name] = (dj, dt)
    return out


def _held(got, want, xmax, tol=FIT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * xmax, np.max(np.abs(got - want)) / xmax


def _xmax(dj):
    return np.max(np.abs(dj.fit_parameters["x"]))


@pytest.mark.parametrize("name", list(FITS))
def test_dop_fit_matches_jax(fits, name):
    dj, dt, f = fits[name]
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    assert dt.qphb_params["converged"] == dj.qphb_params["converged"]
    xm = _xmax(dj)
    for key in ("x", "x_dop", "R_inf", "inductance"):
        _held(dt.fit_parameters[key], dj.fit_parameters[key], xm)
    assert dt.fit_parameters["C_inv"] == dj.fit_parameters["C_inv"] == 0
    np.testing.assert_allclose(dt.dop_scale_vector, dj.dop_scale_vector, rtol=1e-9)
    np.testing.assert_array_equal(dt.basis_nu, dj.basis_nu)
    assert dt.nu_epsilon == pytest.approx(dj.nu_epsilon, rel=1e-14)
    np.testing.assert_allclose(dt.qphb_params["dop_rho_vector"],
                               dj.qphb_params["dop_rho_vector"], rtol=1e-6)
    np.testing.assert_allclose(dt.qphb_params["dop_xmx_norms"], dj.qphb_params["dop_xmx_norms"],
                               rtol=1e-6)
    _held(dt.predict_z(f), dj.predict_z(f), xm)
    _held(dt.predict_z(f, include_dop=False), dj.predict_z(f, include_dop=False), xm)


def test_solve_rp_rescales_the_dop_columns(fits):
    """With solve_rp the DOP columns are rescaled to the DRT block's size in
    place (:1222-1231): the scale vector, the design's DOP columns and the
    penalty block all move by one factor, in the JAX order."""
    (dj, dt, _), (_, plain, _) = fits["solve_rp"], fits["parallel"]
    ratio = dt.dop_scale_vector / plain.dop_scale_vector
    assert np.ptp(ratio) <= 1e-12 * abs(ratio[0]) and abs(ratio[0] - 1) > 1e-3
    ds, de = dt.dop_indices
    np.testing.assert_allclose(dt.qphb_params["rm"][:, ds:de], dj.qphb_params["rm"][:, ds:de],
                               rtol=1e-9, atol=1e-14)
    for k in range(3):
        np.testing.assert_allclose(dt.qphb_params["penalty_matrices"][f"m{k}"][ds:de, ds:de],
                                   dj.qphb_params["penalty_matrices"][f"m{k}"][ds:de, ds:de],
                                   rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("name", ["parallel", "unnormalized", "parity"])
def test_dop_readouts_match_jax(fits, name):
    dj, dt, f = fits[name]
    xm = _xmax(dj)
    nu = np.linspace(-1, 1, 41)
    for kw in ({}, {"nu": nu}, {"nu": nu, "order": 1}, {"nu": nu, "normalize": True},
               {"nu": nu, "normalize": True, "normalize_tau": np.logspace(-6, 1, 8)}):
        # a linear map of x_dop: its rows' |entries| summed, over the
        # normalization, carry x_dop's tolerance
        at = kw.get("nu", np.linspace(-1, 1, 201))
        em = basis_mod.func_eval_matrix_host(dt.basis_nu, at, dt.nu_basis_type, dt.nu_epsilon,
                                             kw.get("order", 0))
        sv = phasance.phasor_scale_vector(at, kw.get("normalize_tau", dt.basis_tau)) \
            if kw.get("normalize") else 1.0
        gain = np.max(np.sum(np.abs(em), axis=1) / sv)
        _held(dt.predict_dop(**kw), dj.predict_dop(**kw), xm * gain)
    _held(dt.get_dop_params(), dj.get_dop_params(), xm)
    np.testing.assert_allclose(dt.get_dop_norm(nu, normalize=True),
                               dj.get_dop_norm(nu, normalize=True), rtol=1e-12)
    assert dt.get_dop_norm(nu) == dj.get_dop_norm(nu) == 1.0
    np.testing.assert_allclose(dt.get_nu_basis_spacing(), dj.get_nu_basis_spacing(),
                               rtol=1e-14)
    assert dt.nu_basis_area == pytest.approx(dj.nu_basis_area, rel=1e-14)
    assert dt.predict_r_inf() == pytest.approx(dj.predict_r_inf(), abs=FIT_TOL * xm)
    # _raw_x rebuilds the solver vector from fit_parameters, DOP block included
    np.testing.assert_allclose(dt._raw_x(), dt.qphb_params["x_raw"], rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="DOP was not fitted"):
        hybdrt_torch.DRT(device="cpu").predict_dop()


def _dop_readout_bound(dt, dj, nu):
    """(relative error, bound) of the DOP variances at ``nu``:
    ``probe.readout_errors`` with the rows u = em * (coefficient scale x the
    DOP scale vector) on the DOP block."""
    ds, de = dt.dop_indices
    em = basis_mod.func_eval_matrix_host(dt.basis_nu, nu, dt.nu_basis_type, dt.nu_epsilon, 0)
    p_t, p_j = (np.asarray(d.qphb_params["p_matrix"]) for d in (dt, dj))
    u = np.zeros((len(nu), p_t.shape[0]))
    u[:, ds:de] = em * (dt.coefficient_scale * dt.dop_scale_vector)
    c_ref = np.linalg.inv(p_j)[None]
    _, bound = probe.readout_errors(c_ref, p_t[None], c_ref, p_j[None], u)
    var_t = np.diag(dt.estimate_dop_cov(nu=nu))
    var_j = np.diag(np.asarray(dj.estimate_dop_cov(nu=nu)))
    return np.abs(var_t - var_j) / np.abs(var_j), bound[0], var_t, var_j


@pytest.mark.parametrize("name", ["parallel", "unnormalized", "parity"])
def test_dop_covariance_and_band_within_their_bounds(fits, name):
    dj, dt, _ = fits[name]
    nu = np.linspace(-1, 1, 31)
    err, bound, var_t, var_j = _dop_readout_bound(dt, dj, nu)
    assert np.all(err <= bound + 1e-12), (err.max(), bound[np.argmax(err - bound)])
    lo_t, hi_t = dt.predict_dop_ci(nu=nu)
    lo_j, hi_j = dj.predict_dop_ci(nu=nu)
    mu_j = dj.predict_dop(nu=nu)
    sig_j = np.sqrt(np.maximum(var_j, 0))
    # the band's half-width moves by sigma's relative bound (half the
    # variance's) times sigma, the centre by the fit tolerance
    slack = 1.96 * 0.5 * bound * sig_j + FIT_TOL * _xmax(dj) * 10 + 1e-12
    assert np.all(np.abs(hi_t - hi_j) <= slack) and np.all(np.abs(lo_t - lo_j) <= slack)
    assert np.all(hi_t >= lo_t) and np.all((lo_t <= mu_j + slack) & (mu_j - slack <= hi_t))
    # the DOP block of the physical covariance is the solver inverse scaled
    ds, de = dt.dop_indices
    p_inv = mat1d.invert_psd(torch.as_tensor(dt.qphb_params["p_matrix"])).numpy()
    sv = dt.coefficient_scale * dt.dop_scale_vector
    np.testing.assert_allclose(dt.estimate_param_cov()[ds:de, ds:de],
                               p_inv[ds:de, ds:de] * sv[:, None] * sv[None, :], rtol=1e-12)


def test_dop_likelihoods_match_jax(fits):
    dj, dt, _ = fits["parallel"]
    assert dt.evaluate_rss() == pytest.approx(dj.evaluate_rss(), rel=1e-8)
    assert dt.evaluate_llh() == pytest.approx(dj.evaluate_llh(), rel=1e-8)
    p_t, p_j = (np.asarray(d.qphb_params["p_matrix"]) for d in (dt, dj))
    assert abs(dt.evaluate_lml() - dj.evaluate_lml()) <= probe.lml_bound(p_t, p_j) \
        + 1e-10 * abs(dj.evaluate_lml())


def test_parity_methods_with_dop(fits):
    """tests/test_multi_misc.py::test_drt_parity_methods' assertions on its
    own DOP fit (ROADMAP Queue 3 item 1): every one of them but the Fisher
    matrix's absolute eigenvalue bound, which is held relative to the
    largest eigenvalue (n eps lambda_max); the JAX package's values on the
    same fit beside them."""
    dj, drt, f = fits["parity"]
    tau = np.logspace(-6, 2, 80)
    lo, hi = drt.predict_distribution_ci(tau=tau)
    assert np.all(hi >= lo)
    areas = drt.split_r_p([1e-2])
    assert areas.shape == (2,)
    assert abs(np.sum(areas) - drt.predict_r_p()) < 0.05
    assert abs(areas[0] - 1.0) < 0.15 and abs(areas[1] - 0.8) < 0.15
    assert drt.evaluate_chi_sq() < 1e-4
    assert drt.evaluate_chi_sq(weights="modulus") < 1e-4
    with pytest.raises(ValueError):
        drt.evaluate_chi_sq(weights=np.ones(3))
    fim = drt.fisher_matrix()
    assert fim.shape[0] == fim.shape[1] == drt.qphb_params["rm"].shape[1]
    eig = np.linalg.eigvalsh(fim)
    assert eig.min() > -fim.shape[0] * EPS * eig.max()
    # the two fits' weights part at the fit tolerance, and the matrix with them
    fim_j = np.asarray(dj.fisher_matrix())
    assert np.max(np.abs(fim - fim_j)) <= FIT_TOL * np.max(np.abs(fim_j))
    assert drt.predict_sigma("eis").shape == f.shape
    with pytest.raises(ValueError):
        drt.predict_sigma("bogus")
    tmin, tmax = drt.get_data_tau_limits()
    assert tmin < 1e-5 and tmax > 1e-1
    np.testing.assert_allclose(areas, dj.split_r_p([1e-2]), rtol=FIT_TOL, atol=1e-10)
    assert drt.evaluate_chi_sq() == pytest.approx(dj.evaluate_chi_sq(), rel=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_matches_jax(option_fits, name):
    dj, dt = option_fits[name]
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    assert dt.special_qp_params == dj.special_qp_params
    xm = np.max(np.abs(dj.fit_parameters["x"]))
    keys = [k for k in ("x", "x_dop", "C_inv", "R_inf", "inductance", "vz_offset")
            if k in dj.fit_parameters]
    assert set(keys) <= set(dt.fit_parameters)
    for key in keys:
        _held(dt.fit_parameters[key], dj.fit_parameters[key], xm)
    np.testing.assert_allclose(dt.qphb_params["x_raw"], dj.qphb_params["x_raw"], rtol=0,
                               atol=FIT_TOL * np.max(np.abs(dj.qphb_params["x_raw"])))
    np.testing.assert_allclose(dt._raw_x(), dt.qphb_params["x_raw"], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_predictions_match_jax(option_fits, name):
    dj, dt = option_fits[name]
    xm = np.max(np.abs(dj.fit_parameters["x"]))
    if dt.get_fit_frequencies().size:
        f = dt.get_fit_frequencies()
        _held(dt.predict_z(f), dj.predict_z(f), xm)
        _held(dt.predict_z(f, include_cap=False), dj.predict_z(f, include_cap=False), xm)
    if dt.get_fit_times().size:
        t = dt.get_fit_times()
        # the response reads the coefficients through the step response
        # (the capacitance's grows as t): scale by the response's size
        rm = np.max(np.abs(dj.predict_response(t)))
        _held(dt.predict_response(t), dj.predict_response(t), rm)
    assert dt.predict_r_inf() == pytest.approx(dj.predict_r_inf(), abs=FIT_TOL * xm)


def test_delta_dop_adds_its_zero_phase_to_r_inf(option_fits):
    """With the delta nu basis the nu = 0 coefficient is an ohmic term:
    predict_r_inf adds it to R_inf (:2117-2120), as in the JAX package. The
    JAX DRT cannot read a delta-basis DOP (its cached eval matrix takes
    float(nu_epsilon), None for that basis: ROADMAP Queue 3 item 21); the
    port reads it as the basis defines it, x_dop at the basis points and 0
    between them."""
    dj, dt = option_fits["delta"]
    zero = np.flatnonzero(NU_DELTA == 0)
    assert len(zero) == 1
    assert dt.predict_r_inf() == pytest.approx(
        dt.fit_parameters["R_inf"] + dt.fit_parameters["x_dop"][zero[0]], rel=1e-14)
    assert dt.nu_epsilon is None and dj.nu_epsilon is None
    # the delta basis's columns are scaled by the phasor scale alone
    np.testing.assert_allclose(dt.dop_scale_vector, dj.dop_scale_vector, rtol=1e-12)
    nu = np.linspace(-1, 1, 41)
    want = np.zeros(len(nu))
    on = np.isin(nu, NU_DELTA)
    want[on] = dt.fit_parameters["x_dop"][np.searchsorted(NU_DELTA, nu[on])]
    assert on.sum() == 21
    np.testing.assert_array_equal(dt.predict_dop(nu=nu), want)
    with pytest.raises(TypeError, match="NoneType"):
        dj.predict_dop(nu=nu)


def test_capacitance_scales_the_physical_covariance(option_fits):
    _, dt = option_fits["hybrid"]
    i = dt.special_qp_params["C_inv"]["index"]
    p_inv = mat1d.invert_psd(torch.as_tensor(dt.qphb_params["p_matrix"])).numpy()
    s = dt.coefficient_scale * dt.capacitance_scale
    assert dt.estimate_param_cov()[i, i] == pytest.approx(p_inv[i, i] * s * s, rel=1e-12)
    # the capacitance's share of the impedance is the fitted C_inv / (j w)
    f = dt.get_fit_frequencies()
    kw = dict(include_vz_offset=False)
    np.testing.assert_allclose(dt.predict_z(f, **kw) - dt.predict_z(f, include_cap=False, **kw),
                               dt.fit_parameters["C_inv"] / (2j * np.pi * f), rtol=1e-12)


def test_capacitance_of_non_ideal_steps_raises_as_in_jax():
    """fit_capacitance with expdecay steps raises the JAX package's
    ValueError (its response vector takes ideal steps only); without it an
    expdecay fit runs (ROADMAP Queue 3 item 18)."""
    times, i_sig, v, _, _ = probe.hybrid_data()
    drt = hybdrt_torch.DRT(warn=False, device="cpu", fit_capacitance=True,
                           step_model="expdecay")
    with pytest.raises(ValueError, match="non-ideal"):
        drt.fit_chrono(times, i_sig, v, max_iter=2)
    with pytest.raises(ValueError, match="Invalid basis_type"):
        hybdrt_torch.DRT(device="cpu", fit_dop=True, nu_basis_type="bogus")
    # another nu basis: its penalties are the JAX package's generic form
    # (hybdrt_tpu/models/drt.py:680-683)
    from hybdrt_tpu.ops import mat1d as jax_mat1d
    from hybdrt_torch.models.drt import dop_penalty_matrices
    hybdrt_torch.DRT(device="cpu", fit_dop=True, nu_basis_type="pwl")
    nu = np.linspace(-1, 1, 21)
    m_dop, _ = dop_penalty_matrices(nu, "pwl", 10.0)
    for k in range(3):
        want = np.asarray(jax_mat1d.construct_integrated_derivative_matrix(
            nu, basis_type="pwl", order=k, epsilon=10.0))
        assert np.max(np.abs(m_dop[k] - want)) <= 1e-12 * np.max(np.abs(want))
