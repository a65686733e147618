"""Port parity: the GP background (``hybdrt_torch/models/background.py``)
and the background modes of the chrono fit against the JAX package, float64
on the CPU.

``GPBackground``: the grid-searched hyperparameters equal (the same grids,
each log marginal likelihood within 1e-12 of JAX's, so the same argmax),
predictions and the smoothing operator K* K^-1 within 1e-8 of their max
(scipy's Cholesky in the port, ``jnp.linalg`` in the reference), for the
RBF, periodic and locally periodic kernels. ``fit_chrono`` with
``subtract_background`` in its static, dynamic and scaled modes
(tests/test_chrono_hybrid.py::test_fit_chrono_background_* data), and a
hybrid fit with the dynamic background (whose vz-offset design is the
unprojected one, drt.py:1137-1141): the same n_iter, x within 1e-6 of max
|x|, the specials within 1e-6, the fitted background within 1e-6 of its max.
"""
import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_tpu.models import background as jbg
from hybdrt_torch.models import background as tbg

torch.set_num_threads(1)

GP_KW = {"gp_kw": {"n_grid": 4}}


def _drift_record():
    """tests/test_chrono_hybrid.py:135-147."""
    rng = np.random.default_rng(0)
    t_pre = np.linspace(-0.01, -0.0005, 15)
    t_post = np.logspace(-5, 0.5, 120)
    times = np.concatenate([t_pre, t_post])
    i_sig = np.where(times >= 0, 0.1, 0.0)
    v = 0.05 + 0.1 * np.where(times >= 0,
                              0.3 + 1.5 * (1 - np.exp(-np.maximum(times, 0) / 1e-2)), 0.0)
    drift = 0.01 * np.sin(2 * np.pi * times / 1.5) + 0.008 * times
    return times, i_sig, v + drift + rng.normal(size=len(times)) * 2e-4


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("kernel", ["gaussian", "periodic", "locper"])
def test_gp_matches_jax(kernel):
    times, _, v = _drift_record()
    resid = v - np.median(v)
    kw = dict(kernel_type=kernel, n_grid=4 if kernel == "gaussian" else 3)
    gt = tbg.GPBackground(**kw).fit(times, resid)
    gj = jbg.GPBackground(**kw).fit(times, resid)
    assert gt.params_ == gj.params_
    assert gt.y_mean_ == gj.y_mean_ and gt.y_std_ == gj.y_std_
    x_new = np.linspace(times[0], times[-1], 57)
    assert _rel(gt.predict(x_new), gj.predict(x_new)) < 1e-8
    assert _rel(gt.predict_matrix(times), gj.predict_matrix(times)) < 1e-8
    for params in ({"length_scale": 0.1, "noise": 0.5, "periodicity": 2.0},
                   {"length_scale": 1.0, "noise": 0.1, "periodicity": 0.3}):
        yn = (resid - gt.y_mean_) / gt.y_std_
        np.testing.assert_allclose(gt._lml(times, yn, params),
                                   float(gj._lml(np.asarray(times), yn, params)), rtol=1e-12)


def test_background_matrix_and_estimate_match_jax():
    times, _, v = _drift_record()
    y_pred = np.median(v) + 0.0 * v
    gt, bt = tbg.estimate_background(times, v, y_pred, n_grid=4)
    gj, bj = jbg.estimate_background(times, v, y_pred, n_grid=4)
    assert _rel(bt, bj) < 1e-8
    for corr in (None, 0.5, 2.0):
        assert _rel(tbg.get_background_matrix([gt], times[:, None], y_drt=v, corr_power=corr),
                    jbg.get_background_matrix([gj], times[:, None], y_drt=v,
                                              corr_power=corr)) < 1e-8


@pytest.fixture(scope="module")
def fits():
    times, i_sig, v = _drift_record()
    out = {}
    for btype in ("static", "dynamic", "scaled"):
        kw = dict(subtract_background=True, background_type=btype, estimate_background_kw=GP_KW)
        dj = hybdrt_tpu.DRT(warn=False)
        dj.fit_chrono(times, i_sig, v, **kw)
        dt = hybdrt_torch.DRT(warn=False, device="cpu")
        dt.fit_chrono(times, i_sig, v, **kw)
        out[btype] = (times, dj, dt)
    return out


@pytest.mark.parametrize("btype", ["static", "dynamic", "scaled"])
def test_background_fit_matches_jax(fits, btype):
    times, dj, dt = fits[btype]
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    assert dt.qphb_params["converged"] == dj.qphb_params["converged"]
    assert dt.background_gp.params_ == dj.background_gp.params_
    assert _rel(dt.fit_parameters["x"], dj.fit_parameters["x"]) < 1e-6
    keys = ("R_inf", "v_baseline") + (("background_scale",) if btype == "scaled" else ())
    for key in keys:
        np.testing.assert_allclose(dt.fit_parameters[key], dj.fit_parameters[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    assert dt.raw_response_background.shape == times.shape
    assert _rel(dt.raw_response_background, dj.raw_response_background) < 1e-6
    assert _rel(dt.predict_response(times), dj.predict_response(times)) < 1e-6
    assert _rel(dt.predict_chrono_background(times[:10]),
                dj.predict_chrono_background(times[:10])) < 1e-8
    assert list(dt.special_qp_params) == list(dj.special_qp_params)


def test_background_recovers_the_drift(fits):
    """tests/test_chrono_hybrid.py's recovery checks on the port's fits."""
    rp = {}
    for btype, (_, _, dt) in fits.items():
        assert np.all(np.isfinite(dt.raw_response_background))
        assert np.std(dt.raw_response_background) > 0
        rp[btype] = dt.predict_r_p()
        assert abs(rp[btype] - 1.5) < 0.3
    assert abs(rp["dynamic"] - rp["scaled"]) < 0.05
    with pytest.raises(ValueError, match="Invalid background_type"):
        times, i_sig, v = _drift_record()
        hybdrt_torch.DRT(warn=False, device="cpu").fit_chrono(
            times, i_sig, v, subtract_background=True, background_type="bogus")


def test_hybrid_dynamic_background_matches_jax():
    times, i_sig, v = _drift_record()
    freq = np.logspace(5, -1, 31)
    rng = np.random.default_rng(2)
    z = 0.35 + 1.5 / (1 + 2j * np.pi * freq * 1e-2)
    z = z + 2e-3 * (rng.normal(size=31) + 1j * rng.normal(size=31))
    kw = dict(subtract_background=True, background_type="dynamic", estimate_background_kw=GP_KW)
    dj = hybdrt_tpu.DRT(warn=False)
    dj.fit_hybrid(times, i_sig, v, freq, z, **kw)
    dt = hybdrt_torch.DRT(warn=False, device="cpu")
    dt.fit_hybrid(times, i_sig, v, freq, z, **kw)
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    assert _rel(dt.fit_parameters["x"], dj.fit_parameters["x"]) < 1e-6
    for key in ("R_inf", "vz_offset", "inductance"):
        np.testing.assert_allclose(dt.fit_parameters[key], dj.fit_parameters[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    assert _rel(dt.raw_response_background, dj.raw_response_background) < 1e-6
    assert _rel(dt.predict_z(freq), dj.predict_z(freq)) < 1e-6
