"""Port parity: the single hybrid (chrono + EIS) fit, hybdrt_torch.DRT.
fit_hybrid, against the JAX DRT on the same seeded data
(tests/test_chrono_hybrid.py's), float64 on the CPU (``device="cpu"``; the
default is the card). The batched hybrid fitter's parity is in
tests/test_torch_hybrid_batch.py.

Held: the fits with each weight-factor method, explicit factors and
separately initialized weights at the same n_iter and converged flag, x
within 1e-6 of max |x|, and vz_offset, v_baseline, R_inf and inductance
within rtol 1e-6 (atol 1e-10); the weights, design and P matrix at rel
1e-6; the test's recovery bounds; predictions within 1e-6; the prep-only
system, every array to 1e-12 of its max."""
import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_torch.utils.probe import hybrid_data

torch.set_num_threads(1)

METHODS = {"none": {}, "weight": {"hybrid_weight_factor_method": "weight"},
           "rp": {"hybrid_weight_factor_method": "rp"},
           "explicit": {"eis_weight_factor": 2.0, "chrono_weight_factor": 0.5},
           "separately": {"init_weights_separately": True}}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(1e-12, np.max(np.abs(b)))


@pytest.fixture(scope="module", params=list(METHODS))
def fits(request):
    data = hybrid_data(seed=0)
    kw = METHODS[request.param]
    dt = hybdrt_torch.DRT(warn=False, device="cpu").fit_hybrid(*data, **kw)
    dj = hybdrt_tpu.DRT(warn=False).fit_hybrid(*data, **kw)
    return request.param, data, dt, dj


def test_fit_hybrid_matches_jax(fits):
    method, _, dt, dj = fits
    qt, qj = dt.qphb_params, dj.qphb_params
    assert qt["n_iter"] == qj["n_iter"] and qt["converged"] == qj["converged"]
    assert _rel(qt["x_raw"], qj["x_raw"]) < 1e-6
    for key in ("vz_offset", "v_baseline", "R_inf", "inductance"):
        np.testing.assert_allclose(dt.fit_parameters[key], dj.fit_parameters[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    for key in ("chrono_weight_factor", "eis_weight_factor"):
        np.testing.assert_allclose(qt[key], qj[key], rtol=1e-10, err_msg=key)
    for key in ("weights", "true_weights", "est_weights", "init_weights", "rm", "p_matrix"):
        assert _rel(qt[key], qj[key]) < 1e-6, key
    for key in ("v_sigma_tot", "z_sigma_tot"):
        assert _rel(dt.fit_parameters[key], dj.fit_parameters[key]) < 1e-6, key
    assert dt.fit_type == dj.fit_type == "qphb_hybrid"
    # tests/test_chrono_hybrid.py:55-78
    assert abs(dt.predict_r_p() - 1.8) < (0.05 if method == "none" else 0.1)
    if method == "none":
        assert abs(dt.fit_parameters["R_inf"] - 0.3) < 0.02
        assert abs(dt.fit_parameters["inductance"] - 1e-7) < 2e-8
        assert abs(dt.fit_parameters["vz_offset"]) < 0.05


def test_predictions_match_jax(fits):
    """predict_z and predict_response carry the vz offset's factor; the
    distribution and Rp follow x."""
    _, (t, i, v, f, z), dt, dj = fits
    f_new = np.logspace(4, -1, 17)
    for freq in (f, f_new):
        assert _rel(dt.predict_z(freq), np.asarray(dj.predict_z(freq))) < 1e-6
        assert _rel(dt.predict_z(freq, include_vz_offset=False),
                    np.asarray(dj.predict_z(freq, include_vz_offset=False))) < 1e-6
    for times in (t, t[5:40]):
        assert _rel(dt.predict_response(times), np.asarray(dj.predict_response(times))) < 1e-6
    assert abs(dt.predict_r_p() - dj.predict_r_p()) < 1e-6 * abs(dj.predict_r_p())


@pytest.mark.parametrize("kw", [{}, {"vz_offset": False}, {"solve_rp": True},
                                {"v_baseline_deg": 1, "chrono_error_structure": None}],
                         ids=["default", "no_vz", "solve_rp", "baseline_1"])
def test_prep_only_matches_jax(kw):
    """Every array of the prep-only dict to 1e-12 of its max, and every
    scalar and layout key equal."""
    data = hybrid_data(seed=0)
    st = hybdrt_torch.DRT(warn=False, device="cpu")._qphb_fit_core(*data, prep_only=True, **kw)
    sj = hybdrt_tpu.DRT(warn=False)._qphb_fit_core(*data, prep_only=True, **kw)
    assert set(st) <= set(sj)
    for key, val in st.items():
        if isinstance(val, np.ndarray):
            want = np.asarray(sj[key])
            assert val.shape == want.shape, key
            assert np.max(np.abs(val - want), initial=0) <= 1e-12 * max(
                1, np.max(np.abs(want), initial=0)), key
        elif key == "cfg":
            assert val.num_special == sj[key].num_special and val.k_range == sj[key].k_range
        elif key != "hypers" and val is not None and not isinstance(val, (dict, str)):
            assert np.isclose(val, sj[key], rtol=1e-12, atol=0), key
        elif key != "hypers":
            assert val == sj[key], key
