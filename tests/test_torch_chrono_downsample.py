"""Port parity: chrono downsampling (``hybdrt_torch.preprocessing``'s
``generate_log_times``, ``filter_chrono_signal(_batch)``, ``downsample_data``
and the decimation family), ``fit_chrono``/``fit_hybrid`` with
``downsample=True`` and the ragged fitter's downsampling fast path, against
the JAX package, float64 on the CPU.

The host functions are the same numpy and scipy calls on the same arrays:
held within 1e-12 of each array's max, sample indices equal. The fits at the
parity contract's tolerances: the same n_iter, x within 1e-6 of max |x|, the
specials within 1e-6. The fast path (an observation whose protocol is cached
is filtered, decimated and rescaled in one vectorized pass) is held to a
fresh fitter's full prep of the same observation and to the JAX fitter's
(tests/test_ragged.py:301-383's cases): scales within 1e-12, rzv within
1e-13.
"""
import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_tpu import preprocessing as jpp
from hybdrt_tpu.parallel.ragged import BatchedRaggedFitter as JaxRagged
from hybdrt_torch import BatchedRaggedFitter
from hybdrt_torch import preprocessing as tpp
from hybdrt_torch.utils import probe

from test_torch_chrono import _record
from test_torch_ragged_hybrid import _shared_protocol_obs

torch.set_num_threads(1)

TAU_SG = np.logspace(-8, 3, 111)
DS_KW = {"downsample": True, "downsample_kw": {"prestep_samples": 5},
         "hybrid_weight_factor_method": "rp"}


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(1.0, np.max(np.abs(b), initial=0.0))


def _dense():
    """tests/test_chrono_hybrid.py::test_filter_chrono_signal_ramped_sigma's
    record: 1e-4 s sampling, one step, noise."""
    t_sample = 1e-4
    times = np.arange(-0.01, 1.0, t_sample)
    rng = np.random.default_rng(0)
    clean = np.where(times >= 0, 1 - np.exp(-np.maximum(times, 0) / 1e-3), 0.0)
    noisy = clean + rng.normal(0, 0.01, len(times))
    noisy[5000] += 5.0
    return times, noisy


def test_decimation_family():
    """tests/test_chrono_hybrid.py::test_decimation_family's calls."""
    t_sample = 1e-4
    times = np.arange(-0.01, 1.0, t_sample)
    steps = np.array([0.0, 0.5])
    for iv, fac, cap in ((10, 2, 0.05), (4, 3, None), (30, 2, 0.01)):
        got = tpp.get_decimation_index(times, steps, t_sample, 5, iv, fac, cap)
        np.testing.assert_array_equal(got, jpp.get_decimation_index(times, steps, t_sample, 5,
                                                                    iv, fac, cap))
        np.testing.assert_array_equal(tpp.sigma_from_decimate_index(np.zeros(len(times)), got),
                                      jpp.sigma_from_decimate_index(np.zeros(len(times)), got))
    for target in (300, 1000):
        assert tpp.select_decimation_interval(times, steps, t_sample, 5, 2, 0.05, target) == \
            jpp.select_decimation_interval(times, steps, t_sample, 5, 2, 0.05, target)


@pytest.mark.parametrize("prestep", [None, 5, 0])
@pytest.mark.parametrize("which", [0, 1, "test"])
def test_generate_log_times(which, prestep):
    times, i_sig = _record(which)[:2]
    steps = times[tpp.identify_steps(i_sig)]
    for ppd in (10, 20):
        np.testing.assert_array_equal(tpp.generate_log_times(times, steps, ppd, prestep),
                                      jpp.generate_log_times(times, steps, ppd, prestep))


@pytest.mark.parametrize("kw", [
    {}, {"sigma_factor": 0.05, "max_sigma": 3.0}, {"remove_outliers": True},
    {"median_prefilter": True}, {"decimate": True}], ids=["plain", "sigma", "outliers",
                                                            "median", "decimate"])
def test_filter_chrono_signal(kw):
    times, y = _dense()
    kw = dict(kw)
    if kw.pop("decimate", False):
        kw["decimate_index"] = jpp.get_decimation_index(times, [0.0], 1e-4, 5, 10, 2, 0.05)
    _close(tpp.filter_chrono_signal(times, y, step_index=[100], **kw),
           jpp.filter_chrono_signal(times, y, step_index=[100], **kw))
    i_sig = np.where(times >= 0, 0.1, 0.0)
    _close(tpp.filter_chrono_signal(times, y, input_signal=i_sig, **kw),
           jpp.filter_chrono_signal(times, y, input_signal=i_sig, **kw))


def test_filter_chrono_signal_batch():
    times, y = _dense()
    batch = np.stack([y, 0.5 * y[::-1], y + 1.0])
    got = tpp.filter_chrono_signal_batch(times, batch, [100])
    _close(got, jpp.filter_chrono_signal_batch(times, batch, [100]))
    for row, y_k in zip(got, batch):
        np.testing.assert_array_equal(row, tpp.filter_chrono_signal(times, y_k, step_index=[100]))


@pytest.mark.parametrize("kw", [{}, {"antialiased": False}, {"ppd": 10, "prestep_samples": 3},
                                {"prestep_samples": None}], ids=["default", "plain", "ppd",
                                                                 "all_prestep"])
@pytest.mark.parametrize("which", [0, 1, "test"])
def test_downsample_data(which, kw):
    times, i_sig, v = _record(which)[:3]
    idx_t, data_t = tpp.downsample_data(times, i_sig, v, **kw)
    idx_j, data_j = jpp.downsample_data(times, i_sig, v, **kw)
    np.testing.assert_array_equal(idx_t, idx_j)
    for a, b in zip(data_t, data_j):
        _close(a, b)
    target = times[::7]
    idx_t, _ = tpp.downsample_data(times, i_sig, v, target_times=target, **kw)
    np.testing.assert_array_equal(idx_t, jpp.downsample_data(times, i_sig, v,
                                                             target_times=target, **kw)[0])


def _fit_pair(method, data, **kw):
    dj = hybdrt_tpu.DRT(warn=False)
    getattr(dj, method)(*data, **kw)
    dt = hybdrt_torch.DRT(warn=False, device="cpu")
    getattr(dt, method)(*data, **kw)
    return dj, dt


@pytest.mark.parametrize("case", ["chrono_test", "chrono_het", "hybrid_het"])
def test_downsampled_fit_matches_jax(case):
    if case == "chrono_test":
        data, kw = _record("test")[:3], {"downsample_kw": {"prestep_samples": 5, "ppd": 10}}
        method = "fit_chrono"
    elif case == "chrono_het":
        data, kw, method = _record(0)[:3], {}, "fit_chrono"
    else:
        data, kw, method = _record(1), {"downsample_kw": {"prestep_samples": 3}}, "fit_hybrid"
    dj, dt = _fit_pair(method, data, downsample=True, **kw)
    assert len(dt.get_fit_times()) < len(data[0])
    np.testing.assert_array_equal(dt.sample_index, dj.sample_index)
    _close(dt.get_fit_times(), dj.get_fit_times())
    _close(dt.raw_response_signal, dj.raw_response_signal)
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    x_t, x_j = dt.fit_parameters["x"], dj.fit_parameters["x"]
    assert np.max(np.abs(x_t - x_j)) <= 1e-6 * np.max(np.abs(x_j))
    for key in ("R_inf", "v_baseline"):
        np.testing.assert_allclose(dt.fit_parameters[key], dj.fit_parameters[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    t = data[0]
    r_t, r_j = dt.predict_response(t), dj.predict_response(t)
    assert np.max(np.abs(r_t - r_j)) <= 1e-6 * np.max(np.abs(r_j))


def test_downsample_fast_path_matches_serial_prep():
    """tests/test_ragged.py::test_hybrid_fast_path_matches_serial_prep's
    downsampled case on the port: the cached protocol's observations are
    filtered, decimated and rescaled as a full prep does them, and as the
    JAX fitter's fast path does."""
    obs = _shared_protocol_obs(np.random.default_rng(7), (0.8, 1.3, 0.5))
    fitter = BatchedRaggedFitter(TAU_SG, fit_kw=DS_KW, device="cpu")
    systems = [fitter._prep_obs(c, e) for c, e in obs]
    assert systems[0]["fp_filter"] and len(systems[0]["fp_sample_index"]) < len(obs[0][0][0])
    jf = JaxRagged(TAU_SG, fit_kw=DS_KW, batch_bucket=False)
    jsys = [jf._prep_obs(c, e) for c, e in obs]
    for k in (1, 2):
        slow = BatchedRaggedFitter(TAU_SG, fit_kw=DS_KW, device="cpu")._prep_obs(*obs[k])
        fast = systems[k]
        assert fast["rzm"] is systems[0]["rzm"]
        for key in ("coefficient_scale", "impedance_scale", "response_signal_scale",
                    "scaled_response_offset", "host_eis_wf", "host_chrono_wf"):
            assert fast[key] == pytest.approx(slow[key], rel=1e-12, abs=1e-15), key
            assert fast[key] == pytest.approx(jsys[k][key], rel=1e-12, abs=1e-15), key
        np.testing.assert_allclose(fast["rzv"], slow["rzv"], rtol=0, atol=1e-13)
        np.testing.assert_allclose(fast["rzv"], jsys[k]["rzv"], rtol=0, atol=1e-13)
    fast = BatchedRaggedFitter(TAU_SG, fit_kw=DS_KW, device="cpu")
    batch_fast = fast.prepare(obs)
    slow = BatchedRaggedFitter(TAU_SG, fit_kw=DS_KW, device="cpu")
    slow._prep_systems = lambda observations: [slow._prep_obs(c, e) for c, e in observations]
    batch_slow = slow.prepare(obs)
    for key in ("rzv", "var_floor"):
        np.testing.assert_allclose(batch_fast[key], batch_slow[key], rtol=1e-12, atol=1e-14)


def test_downsampled_ragged_fit_matches_jax():
    """The het leg's hybrid observations (small count) fitted with
    ``fit_kw={"downsample": True}``: both protocols' cached systems
    decimated, the later observations through the fast path."""
    obs, tau = probe.make_het_hybrid(12, 4)
    kw = {"downsample": True}
    res = BatchedRaggedFitter(tau, fit_kw=kw, device="cpu").fit(obs)
    ref = JaxRagged(tau, fit_kw=kw, batch_bucket=False).fit(obs)
    np.testing.assert_array_equal(res.n_iter, ref.n_iter)
    np.testing.assert_array_equal(res.num_chrono, ref.num_chrono)
    assert np.all(res.num_chrono < np.array([len(c[0]) for c, _ in obs]))
    for k in range(len(obs)):
        assert np.max(np.abs(res.x[k] - ref.x[k])) <= 1e-6 * np.max(np.abs(ref.x[k]))
    np.testing.assert_allclose(res.r_inf, ref.r_inf, rtol=1e-6, atol=1e-10)
