"""Port parity: the single-spectrum DRT (hybdrt_torch.DRT.fit_eis) against
the JAX DRT on the same spectra, float64 on the CPU (``device="cpu"``; the
DRT's default is the card).

Held, per case: the same n_iter and converged flag; fit_parameters' x, R_inf
and inductance within rtol=1e-6, atol=1e-10 (the batched vs single-fit
tolerance of tests/test_parallel.py); the prep-only system's arrays within
1e-12 of each array's max (the same closed forms and tables, numpy in the
port and jnp in the reference); and predict_z, predict_r_p and
predict_distribution within the same tolerance as x. The golden spectrum is
held to tests/test_drt_fit_golden.py's own tolerances too."""
import warnings

import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_torch.utils import probe
from hybdrt_torch.utils.device import resolve_device
from hybdrt_torch.utils.probe import hybrid_data

torch.set_num_threads(1)

TAU_SG = np.logspace(-8, 3, 111)


def _spectrum(seed, n_freq=41, outlier=False):
    rng = np.random.default_rng(seed)
    freq = np.logspace(5, -1, n_freq)
    z = 0.4 + 1.0 / (1 + (2j * np.pi * freq * 1e-2) ** 0.85) \
        + 1.5 / (1 + (2j * np.pi * freq * 1e-1) ** 0.9) + 2j * np.pi * freq * 2e-7
    z = z + 0.004 * (rng.normal(size=n_freq) + 1j * rng.normal(size=n_freq))
    if outlier:
        z[7] += 0.8
    return freq, z


# (DRT constructor kwargs, fit_eis kwargs, spectrum)
CASES = {
    "golden": ({}, dict(probe.GOLDEN_HYPERS), "golden"),
    "supergrid": ({"tau_supergrid": TAU_SG}, {}, 0),
    "signed": ({}, {"nonneg": False}, 1),
    "solve_rp": ({}, {"solve_rp": True}, "golden"),
    "neg_range_uniform": ({}, {"nonneg": False, "neg_allowed_tau_range": (1e-3, 1e-1),
                              "error_structure": "uniform"}, 2),
    "extremes": ({"fit_inductance": False}, {"remove_extremes": True}, "outlier"),
}


def _data(which):
    if which == "golden":
        return probe.golden_fit()[:2]
    if which == "outlier":
        return _spectrum(3, outlier=True)
    return _spectrum(which)


@pytest.fixture(scope="module", params=list(CASES))
def fits(request):
    init_kw, fit_kw, which = CASES[request.param]
    freq, z = _data(which)
    dj = hybdrt_tpu.DRT(warn=False, **init_kw)
    dt = hybdrt_torch.DRT(warn=False, device="cpu", **init_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dj.fit_eis(freq, z, **fit_kw)
        dt.fit_eis(freq, z, **fit_kw)
    return request.param, freq, z, fit_kw, dj, dt


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **dict(dict(rtol=1e-6,
                                                                          atol=1e-10), **kw))


def test_fit_matches_jax(fits):
    _, _, _, _, dj, dt = fits
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    assert dt.qphb_params["converged"] == dj.qphb_params["converged"]
    for key in ("x", "R_inf", "inductance"):
        _close(dt.fit_parameters[key], dj.fit_parameters[key])
    assert dt.fit_parameters["C_inv"] == 0
    np.testing.assert_allclose(dt.coefficient_scale, dj.coefficient_scale, rtol=1e-12)
    np.testing.assert_array_equal(dt.basis_tau, dj.basis_tau)
    _close(dt.fit_parameters["z_sigma_tot"], dj.fit_parameters["z_sigma_tot"])


def test_prep_only_matches_jax(fits):
    _, freq, z, fit_kw, dj, dt = fits
    kw = {k: v for k, v in fit_kw.items() if k not in ("error_structure",)}
    if "error_structure" in fit_kw:
        kw["eis_error_structure"] = fit_kw["error_structure"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sj = dj._qphb_fit_core(None, None, None, freq, z, prep_only=True, **kw)
        st = dt._qphb_fit_core(None, None, None, freq, z, prep_only=True, **kw)
    assert set(st) == set(sj)
    for key, want in sj.items():
        got = st[key]
        if isinstance(want, np.ndarray):
            assert got.shape == want.shape, key
            scale = max(float(np.max(np.abs(want))), 1e-300)
            assert np.max(np.abs(got - want)) <= 1e-12 * scale, key
        elif key == "cfg":
            jcfg = want._asdict()
            assert not jcfg.pop("nonlin") and jcfg.pop("half_size") == 0
            assert {k: getattr(got, k) for k in jcfg} == jcfg
        elif key == "hypers":
            assert set(got) == set(want)
            for k, v in want.items():
                if v is None:
                    assert got[k] is None, k
                else:
                    np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
        elif isinstance(want, float):
            assert got == pytest.approx(want, rel=1e-12), key
        else:
            assert got == want, key


def test_predictions_match_jax(fits):
    _, freq, _, _, dj, dt = fits
    f_other = np.logspace(4.5, -0.5, 23)
    for f in (freq, f_other):
        _close(dt.predict_z(f), dj.predict_z(f))
    _close(dt.predict_z(freq, x=dj.qphb_params["x_raw"]),
           dj.predict_z(freq, x=dj.qphb_params["x_raw"]))
    _close(dt.predict_r_p(), dj.predict_r_p())
    _close(dt.predict_r_p(absolute=True), dj.predict_r_p(absolute=True))
    _close(dt.predict_r_tot(), dj.predict_r_tot())
    for kw in ({}, {"tau": np.logspace(-6, 1, 57)}, {"ppd": 7, "normalize": True}):
        _close(dt.predict_distribution(**kw), dj.predict_distribution(**kw))


def test_golden_values():
    """tests/test_drt_fit_golden.py's tolerances, on the port's fit."""
    freq, z, want = probe.golden_fit()
    drt = hybdrt_torch.DRT(device="cpu").fit_eis(freq, z, **probe.GOLDEN_HYPERS)
    fp = drt.fit_parameters
    assert np.allclose(want["x"], fp["x"], rtol=0, atol=5e-4)
    assert np.allclose(want["R_inf"], fp["R_inf"], rtol=5e-3)
    assert np.allclose(want["inductance"], fp["inductance"], rtol=5e-3)
    assert fp["C_inv"] == 0 and fp["v_sigma_tot"] is None and fp["v_sigma_res"] is None
    assert np.allclose(want["z_sigma_tot"], fp["z_sigma_tot"], rtol=2e-2)
    assert np.allclose(want["q_vector"], fp["q_vector"], rtol=3e-2)
    golden = {"x": want["x"], "R_inf": want["R_inf"], "inductance": want["inductance"],
              "C_inv": 0}
    z_gold = drt.predict_z(freq, x=golden)
    assert np.max(np.abs(drt.predict_z(freq) - z_gold)) < 1e-3 * np.max(np.abs(z_gold))


def test_history_matches_jax():
    """store_history: one entry per iteration, as the JAX DRT's qphb_history."""
    freq, z = _spectrum(4)
    dj = hybdrt_tpu.DRT(warn=False).fit_eis(freq, z, store_history=True)
    dt = hybdrt_torch.DRT(warn=False, device="cpu").fit_eis(freq, z, store_history=True)
    hj, ht = dj.qphb_history, dt.qphb_history
    assert len(ht) == len(hj) == dj.qphb_params["n_iter"]
    for a, b in zip(ht, hj):
        assert set(a) == set(b) and a["converged"] == b["converged"]
        for key in ("x", "weights", "rho_vector", "s_vectors"):
            _close(a[key], np.asarray(b[key]), err_msg=key)
    np.testing.assert_array_equal(dt.fit_parameters["x"],
                                  hybdrt_torch.DRT(warn=False, device="cpu").fit_eis(
                                      freq, z).fit_parameters["x"])


def _refits(**fit_kw):
    freq, z = _spectrum(0)
    return lambda: hybdrt_torch.DRT(device="cpu").fit_eis(freq, z, **fit_kw)


@pytest.mark.parametrize("make,item", [
    (lambda: hybdrt_torch.DRT(fit_dop=True, device="cpu"), "item 4"),
    (lambda: hybdrt_torch.DRT(fit_capacitance=True, device="cpu"), "item 4"),
    (lambda: hybdrt_torch.DRT(tau_basis_type="Cole-Cole", device="cpu"), "item 4"),
    (lambda: hybdrt_torch.DRT(interpolate_integrals=False, device="cpu"), "item 4"),
    (_refits(remove_outliers=True, outlier_p=0.05), "item 9"),
    (_refits(outlier_p=0.05), "item 9"),
    (_refits(return_outlier_index=True), "item 9"),
    (lambda: hybdrt_torch.DRT(step_model="expdecay", device="cpu"), "item 11"),
    (_refits(subtract_background=True), "item 11"),
    (lambda: hybdrt_torch.DRT(device="cpu")._qphb_fit_core(
        *hybrid_data()[:3], None, None, downsample=True), "item 11"),
    (lambda: hybdrt_torch.DRT(chrono_mode="pot", device="cpu"), "item 11"),
    (lambda: hybdrt_torch.DRT(device="cpu").fit_chrono(*hybrid_data()[:3], outlier_p=0.05),
     "item 9"),
    (_refits(series_neg=True), "series_neg"),
    (_refits(weight_factor=2.0), "weight_factor"),
], ids=["dop", "capacitance", "cole_cole", "trapz", "remove_outliers", "outlier_p",
        "outlier_index", "vz_offset", "background", "chrono_data", "hybrid", "chrono",
        "series_neg", "weight_factor"])
def test_unported_options_raise(make, item):
    with pytest.raises(NotImplementedError, match=item):
        make()


def test_bad_inputs():
    freq, z = _spectrum(0)
    drt = hybdrt_torch.DRT(device="cpu")
    with pytest.raises(ValueError, match="Invalid keyword argument"):
        drt.fit_eis(freq, z, l2_lambda=1.0)
    with pytest.raises(ValueError, match="same length"):
        drt.fit_eis(freq, z[:-1])
    with pytest.raises(ValueError, match="Only one"):
        drt.fit_eis(freq, z, nonneg=False, series_neg=True)
    with pytest.raises(ValueError, match="neg_allowed_tau_range"):
        drt.fit_eis(freq, z, neg_allowed_tau_range=(1e-3, 1e-1))


def test_default_device_is_the_card(monkeypatch):
    """DRT() and BatchedRaggedFitter() take the card: with no CUDA device
    they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (hybdrt_torch.DRT, lambda: hybdrt_torch.BatchedRaggedFitter(TAU_SG)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert hybdrt_torch.DRT(device="cpu").device == resolve_device("cpu")
