"""Port parity: the rest of the single fit's options (``hybdrt_torch.DRT``,
models/drt.py) against the JAX ``DRT``, float64 on the CPU: ``series_neg``
(tests/test_multi_misc.py::test_series_neg_fit's spectrum), ``weight_factor``,
the MAP samples with their quantiles and posterior mean
(tests/test_multi_misc.py::test_map_samples_and_posterior_mean's spectrum) and
the "detail" attribute category carried both ways through pickles.

The fits are held at the parity contract's tolerances (rtol=1e-6,
atol=1e-10, the same n_iter; coefficients within 1e-6 of their max).

The MAP samples pin each coefficient at x_hat_i + delta sigma_i 1.5, sigma
from the Laplace covariance P^-1; at these posteriors cond(P) is 3e15, so
the two packages' inverses, one LAPACK and one torch, give sigma 0.4 % apart
and every pinned QP (ill-conditioned too) moves with it, and so do two fits'
P 1e-11 apart. The samples are therefore held on one fit state, the JAX
fit's attributes carried into the port by ``load_attributes``, with the JAX
inverse in place of the port's (``monkeypatch``): x within 1e-6 of max |x|,
lp within 1e-8 relative, the quantiles and the posterior mean within 1e-6 of
their max. The port's own sigma is held to the JAX one within the
conditioning bound tests/test_torch_cov.py holds covariances to
(``probe.cov_bound``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import hybdrt_tpu
import hybdrt_torch
import hybdrt_torch.models.drt as port_drt
from hybdrt_tpu.ops import mat1d as jax_mat1d
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

TAU = np.logspace(-6, 2, 100)


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _series_neg_spectrum():
    """tests/test_multi_misc.py:58-63."""
    rng = np.random.default_rng(1)
    f = np.logspace(5, -1, 41)
    w = 2j * np.pi * f
    z = 0.3 + 1.5 / (1 + (w * 1e-3) ** 0.9) - 0.5 / (1 + (w * 1e0) ** 0.9)
    return f, z + rng.normal(0, 5e-4, 41) + 1j * rng.normal(0, 5e-4, 41)


def _samples_spectrum():
    """tests/test_multi_misc.py:201-206."""
    rng = np.random.default_rng(0)
    f = np.logspace(5, -1, 41)
    w = 2j * np.pi * f
    z = 0.4 + 1.0 / (1 + (w * 1e-3) ** 0.9) + 0.8 / (1 + (w * 1e-1) ** 0.85)
    return f, z + rng.normal(0, 1e-3, 41) + 1j * rng.normal(0, 1e-3, 41)


def _pair(spectrum, **fit_kw):
    f, z = spectrum
    dj = hybdrt_tpu.DRT(warn=False)
    dj.fit_eis(f, z, **fit_kw)
    dt = hybdrt_torch.DRT(warn=False, device="cpu")
    dt.fit_eis(f, z, **fit_kw)
    return dj, dt


@pytest.fixture(scope="module")
def fits():
    return {"series_neg": _pair(_series_neg_spectrum(), nonneg=True, series_neg=True),
            "weight_factor": _pair(_series_neg_spectrum(), weight_factor=2),
            "samples": _pair(_samples_spectrum())}


@pytest.mark.parametrize("case", ["series_neg", "weight_factor"])
def test_fit_matches_jax(fits, case):
    dj, dt = fits[case]
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    assert dt.qphb_params["converged"] == dj.qphb_params["converged"]
    assert _rel(dt.fit_parameters["x"], dj.fit_parameters["x"]) < 1e-6
    for key in ("R_inf", "inductance"):
        np.testing.assert_allclose(dt.fit_parameters[key], dj.fit_parameters[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    for key in ("weights", "true_weights", "rho_vector"):
        np.testing.assert_allclose(dt.qphb_params[key], dj.qphb_params[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    assert _rel(dt.qphb_params["p_matrix"], dj.qphb_params["p_matrix"]) < 1e-6
    np.testing.assert_allclose(dt.fit_parameters["z_sigma_tot"], dj.fit_parameters["z_sigma_tot"],
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["series_neg", "weight_factor"])
def test_predictions_match_jax(fits, case):
    dj, dt = fits[case]
    f, _ = _series_neg_spectrum()
    assert dt.num_drt_params == dj.num_drt_params
    for sign in (1, -1, 0, None):
        assert _rel(dt.predict_distribution(TAU, sign=sign),
                    dj.predict_distribution(TAU, sign=sign)) < 1e-6
    assert _rel(dt.predict_z(f), dj.predict_z(f)) < 1e-6
    for sign in (1, -1, 0):
        assert _rel(dt.get_drt_params(sign=sign), dj.get_drt_params(sign=sign)) < 1e-6
    np.testing.assert_allclose(dt.predict_r_p(), dj.predict_r_p(), rtol=1e-6)
    np.testing.assert_allclose(dt.predict_r_p(absolute=True), dj.predict_r_p(absolute=True),
                               rtol=1e-6)


def test_series_neg_recovers_the_negative_feature(fits):
    """tests/test_multi_misc.py::test_series_neg_fit's checks on the port."""
    _, dt = fits["series_neg"]
    g_pos = dt.predict_distribution(TAU, sign=1)
    g_neg = dt.predict_distribution(TAU, sign=-1)
    g_tot = dt.predict_distribution(TAU, sign=0)
    assert abs(np.log10(TAU[np.argmax(g_pos)]) + 3) < 0.5
    assert abs(np.log10(TAU[np.argmin(g_neg)])) < 0.5
    assert np.all(g_pos >= -1e-10) and np.all(g_neg <= 1e-10)
    np.testing.assert_allclose(g_tot, g_pos + g_neg, atol=1e-10)
    assert abs(dt.predict_r_p() - 1.0) < 0.1
    f, z = _series_neg_spectrum()
    assert np.linalg.norm(dt.predict_z(f) - z) / np.linalg.norm(z) < 0.01
    # the doubled basis: every coefficient nonnegative, both sets penalized
    assert len(dt.fit_parameters["x"]) == 2 * len(dt.basis_tau)
    assert np.all(dt.qphb_params["lb"][dt.get_qp_mat_offset():] == 0)


def test_series_neg_covariance_matches_jax(fits):
    """The distribution covariance of each set, read through the doubled
    basis (:2333-2341), within the conditioning bound of the parameter
    covariance carried through |E| |C| |E|^T."""
    dj, dt = fits["series_neg"]
    bound = probe.cov_bound(dt.qphb_params["p_matrix"], dj.qphb_params["p_matrix"])
    for sign in (None, 1, -1):
        ct = dt.estimate_distribution_cov(TAU, sign=sign, extend_var=False)
        cj = dj.estimate_distribution_cov(TAU, sign=sign, extend_var=False)
        cov = dj.estimate_param_cov()
        ns = dj.get_qp_mat_offset()
        em = np.abs(np.asarray(hybdrt_torch.ops.basis.func_eval_matrix_host(
            np.log(dj.basis_tau), np.log(TAU), "gaussian", dj.tau_epsilon, 0)))
        em = np.hstack([em, em])
        scale = np.max(em @ np.abs(cov[ns:, ns:]) @ em.T)
        assert np.max(np.abs(ct - cj)) <= bound * scale


def test_series_neg_requires_nonneg():
    f, z = _series_neg_spectrum()
    for drt in (hybdrt_tpu.DRT(warn=False), hybdrt_torch.DRT(warn=False, device="cpu")):
        with pytest.raises(ValueError, match="Only one"):
            drt.fit_eis(f, z, nonneg=False, series_neg=True)


def test_weight_factor_scales_the_weights(fits):
    """The factor multiplies the QP's weights from iteration 1 and the
    stored weights, and the noise estimate follows them."""
    dj, dt = fits["weight_factor"]
    plain = hybdrt_torch.DRT(warn=False, device="cpu").fit_eis(*_series_neg_spectrum())
    assert not np.allclose(dt.fit_parameters["x"], plain.fit_parameters["x"])
    np.testing.assert_allclose(dt.qphb_params["true_weights"] ** -1
                               * dt.impedance_scale,
                               np.concatenate([dt.fit_parameters["z_sigma_tot"].real,
                                               dt.fit_parameters["z_sigma_tot"].imag]),
                               rtol=1e-12)


@pytest.fixture(scope="module")
def samples(fits, tmp_path_factory):
    """The JAX fit's samples, and the port's on the JAX fit's state (its
    attributes loaded from a JAX pickle) with the JAX inverse."""
    dj, _ = fits["samples"]
    path = tmp_path_factory.mktemp("att") / "jax.pkl"
    dj.save_attributes(["config", "fit_core"], str(path))
    carried = hybdrt_torch.DRT(warn=False, device="cpu")
    carried.load_attributes(str(path))
    orig = port_drt.mat1d.invert_psd

    def jax_inverse(a, use_cholesky=True):
        return torch.as_tensor(np.asarray(jax_mat1d.invert_psd(jnp.asarray(a.cpu().numpy()))),
                               dtype=a.dtype, device=a.device)

    port_drt.mat1d.invert_psd = jax_inverse
    try:
        s_t = carried.generate_map_samples()
    finally:
        port_drt.mat1d.invert_psd = orig
    return dj, dj.generate_map_samples(), carried, s_t


def test_map_samples_match_jax(samples):
    dj, s_j, _, s_t = samples
    n_drt = len(dj.basis_tau)
    assert s_t["x"].shape == s_j["x"].shape == (6 * n_drt, dj.get_qp_mat_offset() + n_drt)
    np.testing.assert_array_equal(s_t["index"], s_j["index"])
    np.testing.assert_array_equal(s_t["delta"], s_j["delta"])
    assert _rel(s_t["x_hat"], s_j["x_hat"]) < 1e-6
    assert _rel(s_t["x"], s_j["x"]) < 1e-6
    np.testing.assert_allclose(s_t["lp"], s_j["lp"], rtol=1e-8)
    np.testing.assert_allclose(s_t["lp_hat"], s_j["lp_hat"], rtol=1e-8)
    # tests/test_multi_misc.py's checks: the refined MAP dominates
    assert np.all(s_t["lp"] <= s_t["lp_hat"] + 1e-7)


def test_quantiles_and_posterior_mean_match_jax(samples):
    dj, _, dt, _ = samples
    q = [0.025, 0.5, 0.975]
    assert _rel(dt.get_parameter_quantile(q), dj.get_parameter_quantile(q)) < 1e-6
    assert _rel(dt.estimate_posterior_mean(), dj.estimate_posterior_mean()) < 1e-6
    qs = dt.get_parameter_quantile(q)
    assert np.all(qs[0] <= qs[1] + 1e-12) and np.all(qs[1] <= qs[2] + 1e-12)


def test_sigma_within_the_conditioning_bound(fits):
    """The port's own Laplace sigma against the JAX one on one P."""
    dj, _ = fits["samples"]
    p = dj.qphb_params["p_matrix"]
    s_j = np.sqrt(np.maximum(np.diag(np.asarray(jax_mat1d.invert_psd(jnp.asarray(p)))), 0))
    s_t = np.sqrt(np.maximum(np.diag(port_drt.mat1d.invert_psd(torch.as_tensor(p)).numpy()), 0))
    assert np.max(np.abs(s_t ** 2 - s_j ** 2)) <= probe.cov_bound(p, p) * np.max(s_j ** 2)


def test_samples_are_cached_by_keyword(fits):
    _, dt = fits["samples"]
    s = dt.generate_map_samples()
    assert dt.generate_map_samples() is s
    assert dt.generate_map_samples(refresh=True) is not s
    s2 = dt.generate_map_samples(shift_scale=2.0, deltas=(-1, 1))
    assert s2["x"].shape[0] == 2 * len(dt.basis_tau)
    assert np.all(np.isfinite(s2["lp"]))
    with pytest.raises(ValueError, match="before sampling"):
        hybdrt_torch.DRT(device="cpu").generate_map_samples()


def test_detail_attributes_both_ways(tmp_path):
    """A fit with its history: the JAX fit's "detail" attributes (its
    history of JAX arrays, pfrt_result None, its fit matrices) load into the
    port as numpy arrays, and the port's into the JAX DRT, each equal to
    the other package's own within the fit tolerance; each package's
    predictions from the other's state within 1e-12 of its own (the same
    arrays, summed in another order)."""
    f, z = _samples_spectrum()
    kw = dict(store_history=True, max_iter=8)  # the JAX history loop is eager
    dj = hybdrt_tpu.DRT(warn=False)
    dj.fit_eis(f, z, **kw)
    dt = hybdrt_torch.DRT(warn=False, device="cpu").fit_eis(f, z, **kw)
    cats = ["config", "fit_core", "detail"]
    assert set(dt.get_attributes(cats)) == set(dj.get_attributes(cats))

    dj.save_attributes(cats, str(tmp_path / "jax.pkl"))
    into_port = hybdrt_torch.DRT(warn=False, device="cpu")
    into_port.load_attributes(str(tmp_path / "jax.pkl"))
    assert into_port.pfrt_result is None
    assert len(into_port.qphb_history) == len(dt.qphb_history) == dj.qphb_params["n_iter"]
    for a, b in zip(into_port.qphb_history, dt.qphb_history):
        assert isinstance(a["x"], np.ndarray) and a["converged"] == b["converged"]
        for key in ("x", "weights", "rho_vector", "s_vectors"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-6, atol=1e-10, err_msg=key)
    for key in ("impedance", "m0", "m1", "m2"):
        np.testing.assert_allclose(dt.fit_matrices[key], into_port.fit_matrices[key],
                                   rtol=1e-12, atol=1e-14, err_msg=key)
    np.testing.assert_allclose(into_port.predict_z(f), dj.predict_z(f), rtol=1e-12)

    dt.save_attributes(cats, str(tmp_path / "port.pkl"))
    into_jax = hybdrt_tpu.DRT(warn=False)
    into_jax.load_attributes(str(tmp_path / "port.pkl"))
    assert into_jax.pfrt_result is None and len(into_jax.qphb_history) == len(dj.qphb_history)
    np.testing.assert_allclose(into_jax.predict_z(f), dt.predict_z(f), rtol=1e-12)
    np.testing.assert_allclose(into_jax.predict_distribution(TAU),
                               dj.predict_distribution(TAU), rtol=1e-6, atol=1e-10)
