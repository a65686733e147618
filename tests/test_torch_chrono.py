"""Port parity: chrono preprocessing, the chrono matrices and the chrono fit
(hybdrt_torch.DRT.fit_chrono) against the JAX package on the same seeded
data, float64 on the CPU (``device="cpu"``; the DRT's default is the card).

Held: step detection, step sizes, the Rp estimates, the time transforms, the
response lookup, the response matrix and vectors, the chrono variance
matrix and the baseline matrix to 1e-12 of each array's max (the same
closed forms and tables, numpy in the port and jnp in the reference), on
both protocols of the benchmark's het map and on
tests/test_chrono_hybrid.py's record; ``fit_chrono``: the same n_iter and
converged flag, x within 1e-6 of max |x|, R_inf and v_baseline within
1e-6, the test's recovery bounds, and ``predict_response`` within 1e-6 of
the response's max."""
import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_tpu import preprocessing as jpp
from hybdrt_tpu.models import background as jbg
from hybdrt_tpu.ops import lookup as jlookup, mat1d as jmat
from hybdrt_tpu.utils import chrono as jchrono
from hybdrt_torch import preprocessing as tpp
from hybdrt_torch.models import background as tbg
from hybdrt_torch.ops import lookup as tlookup, mat1d as tmat
from hybdrt_torch.utils import chrono as tchrono
from hybdrt_torch.utils.probe import HET_PROTOCOLS, TAU_SUPER, hybrid_data, make_het_hybrid

torch.set_num_threads(1)

TOL = 1e-12


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(1.0, np.max(np.abs(b), initial=0.0))


def _record(which):
    """(times, i_signal, v_signal, freq, z) of het protocol 0 or 1 (the
    map's first observation on it) or of tests/test_chrono_hybrid.py."""
    if which == "test":
        return hybrid_data(seed=0)
    obs, _ = make_het_hybrid(6, 4)
    (t, i, v), (f, z) = next(o for k, o in enumerate(obs) if len(o[0][0]) ==
                             len(HET_PROTOCOLS[which][0]))
    return t, i, v, f, z


RECORDS = [0, 1, "test"]


@pytest.mark.parametrize("which", RECORDS)
def test_steps_and_time_grids(which):
    t, i, v, f, _ = _record(which)
    np.testing.assert_array_equal(tpp.identify_steps(i), jpp.identify_steps(i))
    for offset in (False, True):
        (st, ss), (sj, sjs) = tpp.get_step_info(t, i, True, offset), \
            jpp.get_step_info(t, i, True, offset)
        _close(st, sj)
        _close(ss, sjs)
    np.testing.assert_array_equal(tpp.get_step_indices_from_step_times(t, st),
                                  jpp.get_step_indices_from_step_times(t, sj))
    _close(tpp.get_step_sizes(t, i, st), jpp.get_step_sizes(t, i, sj))
    got, want = tpp.process_input_signal(t, i, "ideal", True), \
        jpp.process_input_signal(t, i, "ideal", True)
    for a, b in zip(got[:2], want[:2]):
        _close(a, b)
    assert got[2] is None and want[2] is None
    _close(tpp.generate_model_signal(t, st, ss, None, "ideal"),
           jpp.generate_model_signal(t, sj, sjs, None, "ideal"))
    _close(tpp.get_time_since_step(t, st), jpp.get_time_since_step(t, sj))
    _close(tpp.get_time_since_step(t, st, prestep_value=-1),
           jpp.get_time_since_step(t, sj, prestep_value=-1))
    for fr in (f, None):
        _close(tpp.get_tau_lim(fr, t, st), jpp.get_tau_lim(fr, t, sj))
        _close(tpp.get_num_decades(fr, t, st), jpp.get_num_decades(fr, t, sj))
        for grid in (None, TAU_SUPER):
            _close(tpp.get_basis_tau(fr, t, st, tau_grid=grid),
                   jpp.get_basis_tau(fr, t, sj, tau_grid=grid))
    rev, fwd = tchrono.get_time_transforms(t, st)
    jrev, jfwd = jchrono.get_time_transforms(t, sj)
    _close(fwd(t), jfwd(t))
    _close(rev(fwd(t)), jrev(jfwd(t)))
    assert tchrono.get_input_and_response(i, v, "galv") == (i, v)


@pytest.mark.parametrize("which", RECORDS)
def test_estimate_rp(which):
    """estimate_rp from chrono data, EIS data and both, and the batched form
    row for row, against the JAX package's."""
    t, i, v, f, z = _record(which)
    st, ss = tpp.get_step_info(t, i, True, True)
    for args in ((t, st, ss, v, "ideal", None), (t, st, ss, v, "ideal", z),
                 (None, None, None, None, None, z)):
        assert abs(tpp.estimate_rp(*args) - jpp.estimate_rp(*args)) <= TOL * abs(
            jpp.estimate_rp(*args))
    rng = np.random.default_rng(5)
    vb = v[None] * (1 + 0.1 * rng.normal(size=(3, 1)))
    zb = z[None] * (1 + 0.1 * rng.normal(size=(3, 1)))
    for vv, zz in ((vb, None), (vb, zb), (None, zb)):
        got = tpp.estimate_rp_batch(t, st, ss, vv, "ideal", zz)
        _close(got, jpp.estimate_rp_batch(t, st, ss, vv, "ideal", zz))
        _close(got, [tpp.estimate_rp(t if vv is not None else None, st, ss,
                                     None if vv is None else vv[k], "ideal",
                                     None if zz is None else zz[k]) for k in range(3)])


@pytest.mark.parametrize("which", RECORDS)
def test_chrono_matrices(which):
    """The response lookup and matrix (layered too), the inductance and
    ohmic response vectors, the chrono variance matrix (both error
    structures) and the baseline matrix."""
    t, i, _, f, _ = _record(which)
    st, ss = tpp.get_step_info(t, i, True, True)
    basis_tau = tpp.get_basis_tau(f, t, st, tau_grid=TAU_SUPER)
    eps = 1 / np.mean(np.diff(np.log(TAU_SUPER)))
    lu, jlu = tlookup.generate_response_lookup("gaussian", "galv", "ideal", eps), \
        jlookup.generate_response_lookup("gaussian", "galv", "ideal", eps)
    _close(lu[0], jlu[0])
    _close(lu[1], jlu[1])
    (a, a_l), (ja, ja_l) = (tmat.construct_response_matrix(basis_tau, t, "ideal", st, ss,
                                                            epsilon=eps),
                            jmat.construct_response_matrix(basis_tau, t, "ideal", st, ss,
                                                           epsilon=eps))
    _close(a, ja)
    _close(a_l, ja_l)
    _close(tmat.construct_inductance_response_vector(t, "ideal", st, ss, None),
           jmat.construct_inductance_response_vector(t, "ideal", st, ss, None))
    for smooth in (True, False):
        _close(tmat.construct_ohmic_response_vector(t, "ideal", st, ss, None, i, smooth),
               jmat.construct_ohmic_response_vector(t, "ideal", st, ss, None, i, smooth))
    for err in (None, "uniform"):
        _close(tmat.construct_chrono_var_matrix(t, st, 4, err),
               jmat.construct_chrono_var_matrix(t, st, 4, err))
    for deg, sqrt in ((0, False), (2, True)):
        _close(tbg.get_baseline_matrix(t, deg, sqrt=sqrt), jbg.get_baseline_matrix(t, deg,
                                                                                  sqrt=sqrt))
        (m, sc), (jm, jsc) = tbg.get_baseline_matrix(t, deg, True, sqrt), \
            jbg.get_baseline_matrix(t, deg, True, sqrt)
        _close(m, jm)
        _close(sc, jsc)


def test_multi_step_matrices():
    """Two steps of opposite sign (tests/test_chrono_hybrid.py's multi-step
    record): the nonconsecutive steps, the segment mask of the variance
    matrix and the layered response."""
    t = np.concatenate([np.linspace(-0.01, -0.0005, 10), np.logspace(-5, -0.31, 60),
                        0.5 + np.logspace(-5, -0.31, 60)])
    i = np.where(t >= 0.5, -0.05, np.where(t >= 0, 0.1, 0.0))
    st, ss = tpp.get_step_info(t, i, True, True)
    assert len(st) == 2
    basis_tau = tpp.get_basis_tau(None, t, st)
    (a, a_l), (ja, ja_l) = (tmat.construct_response_matrix(basis_tau, t, "ideal", st, ss),
                            jmat.construct_response_matrix(basis_tau, t, "ideal", st, ss))
    _close(a, ja)
    _close(a_l, ja_l)
    vmm = tmat.construct_chrono_var_matrix(t, st, 4)
    _close(vmm, jmat.construct_chrono_var_matrix(t, st, 4))
    seg = np.searchsorted(st, t, side="right")
    assert np.all(vmm[seg[:, None] != seg[None, :]] == 0.0)


@pytest.fixture(scope="module")
def chrono_fits():
    t, i, v, _, _ = hybrid_data(seed=0)
    dt = hybdrt_torch.DRT(warn=False, device="cpu").fit_chrono(t, i, v)
    dj = hybdrt_tpu.DRT(warn=False).fit_chrono(t, i, v)
    return (t, i, v), dt, dj


def test_fit_chrono_matches_jax(chrono_fits):
    (t, _, v), dt, dj = chrono_fits
    qt, qj = dt.qphb_params, dj.qphb_params
    assert qt["n_iter"] == qj["n_iter"] and qt["converged"] == qj["converged"]
    assert np.max(np.abs(qt["x_raw"] - qj["x_raw"])) < 1e-6 * np.max(np.abs(qj["x_raw"]))
    for key in ("R_inf", "v_baseline", "inductance"):
        np.testing.assert_allclose(dt.fit_parameters[key], dj.fit_parameters[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    np.testing.assert_allclose(dt.fit_parameters["v_sigma_tot"],
                               dj.fit_parameters["v_sigma_tot"], rtol=1e-6)
    assert dt.fit_type == dj.fit_type == "qphb_chrono"
    np.testing.assert_allclose(dt.step_times, dj.step_times, rtol=TOL)
    np.testing.assert_allclose(dt.nonconsec_step_times, dj.nonconsec_step_times, rtol=TOL)
    # tests/test_chrono_hybrid.py:34-41
    assert abs(dt.fit_parameters["R_inf"] - 0.3) < 0.02
    assert abs(dt.predict_r_p() - 1.8) < 0.05
    assert abs(dt.fit_parameters["v_baseline"][0] - 0.05) < 1e-3
    assert np.median(np.abs(dt.predict_response(t) - v)) < 1e-3


def test_predict_response_matches_jax(chrono_fits):
    """At the fit times (rows of the fit matrix), at new times (a fresh
    matrix), and the baseline alone."""
    (t, _, v), dt, dj = chrono_fits
    t_new = np.concatenate([np.linspace(-0.01, 0, 7), np.logspace(-4, 0.3, 23)])
    for times in (t, t_new, t[20:]):
        got, want = dt.predict_response(times), np.asarray(dj.predict_response(times))
        assert np.max(np.abs(got - want)) < 1e-6 * np.max(np.abs(want))
        _close(dt.predict_v_baseline(times), dj.predict_v_baseline(times), 1e-6)
    got = dt.predict_response(t, x=dj.qphb_params["x_raw"])
    assert np.max(np.abs(got - np.asarray(dj.predict_response(t, x=dj.qphb_params["x_raw"])))) \
        < 1e-10 * np.max(np.abs(v))


def test_chrono_prep_only_matches_jax():
    """The chrono prep-only system (multi-step, v_baseline of degree 1 with
    sqrt), every array to 1e-12."""
    t = np.concatenate([np.linspace(-0.01, -0.0005, 10), np.logspace(-5, -0.31, 60),
                        0.5 + np.logspace(-5, -0.31, 60)])
    i = np.where(t >= 0.5, -0.05, np.where(t >= 0, 0.1, 0.0))
    v = 0.02 + 0.3 * i + np.random.default_rng(2).normal(size=len(t)) * 1e-4
    kw = dict(v_baseline_deg=1, v_baseline_sqrt=True, prep_only=True,
              chrono_error_structure=None)
    st = hybdrt_torch.DRT(warn=False, device="cpu")._qphb_fit_core(t, i, v, None, None, **kw)
    sj = hybdrt_tpu.DRT(warn=False)._qphb_fit_core(t, i, v, None, None, **kw)
    assert set(st) <= set(sj)
    for key, val in st.items():
        if isinstance(val, np.ndarray):
            _close(val, sj[key])
        elif key not in ("cfg", "hypers"):
            assert (val == sj[key]) or np.isclose(val, sj[key], rtol=TOL), key
    assert st["special_qp_params"] == sj["special_qp_params"]
