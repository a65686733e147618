"""Port parity: non-ideal (``expdecay``) steps and the potentiostatic
closed form against the JAX package, float64 on the CPU.

Held within 1e-10 of each array's max (the same numpy or jnp expressions
and scipy's ``least_squares`` on the same host arrays): ``fit_signal_steps``
(free and fixed rise times), ``evaluate_step_fit``, ``process_input_signal``,
``generate_model_signal``, the ``expdecay`` response integrand and its
``tau_rise`` lookup, the response matrix, the inductance and ohmic response
vectors, and the potentiostatic delta-basis closed form; the JAX package's
own ``ValueError``s for potentiostatic data (``basis.py:373-375``,
``mat1d.py:243-244``) are the port's.

The JAX ``DRT`` cannot fit ``expdecay`` steps: its ``_prep_chrono_fit_matrix``
builds the capacitance response vector whether or not the capacitance is
fitted, and that vector raises for non-ideal steps (ROADMAP Queue 3 item
18; ``test_jax_expdecay_fit_raises`` pins it). The port builds no
capacitance vector (fitting it is Queue 1 item 4), so its ``expdecay`` fit
runs; it is held to the JAX fit with that vector returned as zeros
(``monkeypatch``; the fit reads it only with ``fit_capacitance``) at the
parity contract's tolerances: the same n_iter, x within 1e-6 of max |x|,
R_inf, inductance and v_baseline within 1e-6, ``predict_response`` within
1e-6 of the response's max.
"""
import numpy as np
import pytest
import torch

import hybdrt_tpu
import hybdrt_torch
from hybdrt_tpu import preprocessing as jpp
from hybdrt_tpu.ops import basis as jbasis, lookup as jlookup, mat1d as jmat
from hybdrt_torch import preprocessing as tpp
from hybdrt_torch.ops import basis as tbasis, lookup as tlookup, mat1d as tmat
from hybdrt_torch.utils.probe import HET_PROTOCOLS, TAU_SUPER

from test_torch_chrono import _record

torch.set_num_threads(1)


def _close(a, b, tol=1e-10):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(1.0, np.max(np.abs(b), initial=0.0))


def _rising(which, tau_rise=2e-4):
    """Het protocol ``which``'s times with an input step that rises with
    time constant ``tau_rise``, and its record's response."""
    times, st, amp, _ = HET_PROTOCOLS[which]
    t, _, v, _, _ = _record(which)
    i_sig = np.where(times >= st, amp * (1 - np.exp(-np.maximum(times - st, 0) / tau_rise)), 0.0)
    return t, i_sig, v


SIGNALS = {"ideal": lambda: _record(0)[:3], "rising0": lambda: _rising(0),
           "rising1": lambda: _rising(1, 5e-4)}


@pytest.mark.parametrize("which", list(SIGNALS))
@pytest.mark.parametrize("fixed", [None, 1e-4])
def test_fit_signal_steps(which, fixed):
    times, i_sig, _ = SIGNALS[which]()
    want = jpp.fit_signal_steps(times, i_sig, fixed_tau_rise=fixed)
    got = tpp.fit_signal_steps(times, i_sig, fixed_tau_rise=fixed)
    for key in ("x", "step_times", "step_sizes"):
        _close(got[key], want[key])
    _close(tpp.evaluate_step_fit(times, got["step_times"], got["step_sizes"], got["x"]),
           jpp.evaluate_step_fit(times, want["step_times"], want["step_sizes"], want["x"]))
    if fixed is not None:
        n = len(got["step_times"])
        np.testing.assert_allclose(np.exp(got["x"][n + 1:]), fixed)


@pytest.mark.parametrize("which", list(SIGNALS))
def test_process_input_signal_expdecay(which):
    times, i_sig, _ = SIGNALS[which]()
    got = tpp.process_input_signal(times, i_sig, "expdecay", True)
    want = jpp.process_input_signal(times, i_sig, "expdecay", True)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tpp.generate_model_signal(times, got[0], got[1], got[2], "expdecay"),
           jpp.generate_model_signal(times, want[0], want[1], want[2], "expdecay"))


@pytest.mark.parametrize("tau_rise", [None, 3e-3, 0.2])
def test_expdecay_integrand_and_lookup(tau_rise):
    eps = 1 / np.mean(np.diff(np.log(TAU_SUPER)))
    y = np.linspace(-20, 20, 101)[None, :]
    t_n = np.logspace(-6, 2, 50)[:, None]
    tr = 0.0 if tau_rise is None else tau_rise
    _close(tbasis.get_response_func("gaussian", "galv", "expdecay")(y, 1.0, t_n, eps, tr),
           np.asarray(jbasis.get_response_func("gaussian", "galv", "expdecay")(
               y, 1.0, t_n, eps, tr)))
    got = tlookup.generate_response_lookup("gaussian", "galv", "expdecay", eps, tau_rise=tau_rise)
    want = jlookup.generate_response_lookup("gaussian", "galv", "expdecay", eps,
                                            tau_rise=tau_rise)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("which", [0, 1])
def test_expdecay_response_matrix_and_vectors(which):
    times, i_sig, _ = _rising(which)
    st, ss, tr = jpp.process_input_signal(times, i_sig, "expdecay", True)
    basis_tau = TAU_SUPER[20:90]
    eps = 1 / np.mean(np.diff(np.log(TAU_SUPER)))
    kw = dict(basis_type="gaussian", epsilon=eps, tau_rise=tr)
    for grids in (None, "lookup"):
        lk = {} if grids is None else dict(interpolate_grids=jlookup.generate_response_lookup(
            "gaussian", "galv", "expdecay", eps, tau_rise=float(tr[0])))
        got = tmat.construct_response_matrix(basis_tau, times, "expdecay", st, ss, **kw, **lk)
        want = jmat.construct_response_matrix(basis_tau, times, "expdecay", st, ss, **kw, **lk)
        _close(got[0], want[0])
        _close(got[1], want[1])
    _close(tmat.construct_inductance_response_vector(times, "expdecay", st, ss, tr),
           jmat.construct_inductance_response_vector(times, "expdecay", st, ss, tr))
    _close(tmat.construct_ohmic_response_vector(times, "expdecay", st, ss, tr, i_sig, True),
           jmat.construct_ohmic_response_vector(times, "expdecay", st, ss, tr, i_sig, True))
    assert np.all(tmat.construct_inductance_response_vector(times, "ideal", st, ss, None) == 0)


@pytest.mark.parametrize("which", [0, 1])
def test_pot_closed_form(which):
    """The potentiostatic response of the delta basis (mat1d.py:88-93):
    exp(-(t - t_step) / tau) after each step, 0 before it."""
    times, st, amp, _ = HET_PROTOCOLS[which]
    steps, sizes = np.array([st, times[-20]]), np.array([amp, -amp / 2])
    basis_tau = TAU_SUPER[::3]
    for basis_type in ("gaussian", "delta"):
        got = tmat.construct_response_matrix(basis_tau, times, "ideal", steps, sizes,
                                             basis_type=basis_type, op_mode="pot")
        want = jmat.construct_response_matrix(basis_tau, times, "ideal", steps, sizes,
                                              basis_type=basis_type, op_mode="pot")
        _close(got[0], want[0])
        _close(got[1], want[1])
    assert np.all(np.isfinite(got[0]))


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_pot_mode_raises_as_in_jax():
    """Potentiostatic data: the gaussian response integrand and the ohmic
    response vector raise the JAX package's ValueErrors, so a DRT in
    ``chrono_mode="pot"`` is refused at construction in both packages."""
    assert _message(lambda: tbasis.get_response_func("gaussian", "pot")) == \
        _message(lambda: jbasis.get_response_func("gaussian", "pot"))
    times, i_sig, _ = _record(0)[:3]
    args = (times, "ideal", [0.0], [0.1], None, i_sig, False, "pot")
    assert _message(lambda: tmat.construct_ohmic_response_vector(*args)) == \
        _message(lambda: jmat.construct_ohmic_response_vector(*args))
    assert _message(lambda: hybdrt_torch.DRT(chrono_mode="pot", device="cpu")) == \
        _message(lambda: hybdrt_tpu.DRT(chrono_mode="pot"))


def test_jax_expdecay_fit_raises():
    """ROADMAP Queue 3 item 18: the JAX DRT refuses every expdecay fit
    through its unconditional capacitance vector."""
    times, i_sig, v = _rising(0)
    with pytest.raises(ValueError, match="Capacitance response not implemented"):
        hybdrt_tpu.DRT(step_model="expdecay", warn=False).fit_chrono(times, i_sig, v)


@pytest.fixture(scope="module")
def expdecay_fits():
    mp = pytest.MonkeyPatch()
    cap = jmat.construct_capacitance_response_vector

    def capacitance(times, step_model, *args, **kw):
        if step_model != "ideal":
            return np.zeros(len(times))
        return cap(times, step_model, *args, **kw)

    mp.setattr(jmat, "construct_capacitance_response_vector", capacitance)
    out = {}
    try:
        for name in ("ideal", "rising0", "rising1"):
            times, i_sig, v = SIGNALS[name]()
            dj = hybdrt_tpu.DRT(step_model="expdecay", warn=False)
            dj.fit_chrono(times, i_sig, v)
            dt = hybdrt_torch.DRT(step_model="expdecay", warn=False, device="cpu")
            dt.fit_chrono(times, i_sig, v)
            out[name] = (times, dj, dt)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", ["ideal", "rising0", "rising1"])
def test_expdecay_fit_matches_jax(expdecay_fits, name):
    times, dj, dt = expdecay_fits[name]
    assert dt.qphb_params["n_iter"] == dj.qphb_params["n_iter"]
    assert dt.qphb_params["converged"] == dj.qphb_params["converged"]
    _close(dt.tau_rise, dj.tau_rise)
    _close(dt.step_times, dj.step_times)
    x_t, x_j = dt.fit_parameters["x"], dj.fit_parameters["x"]
    assert np.max(np.abs(x_t - x_j)) <= 1e-6 * np.max(np.abs(x_j))
    for key in ("R_inf", "inductance", "v_baseline"):
        np.testing.assert_allclose(dt.fit_parameters[key], dj.fit_parameters[key], rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    r_t, r_j = dt.predict_response(times), dj.predict_response(times)
    assert np.max(np.abs(r_t - r_j)) <= 1e-6 * np.max(np.abs(r_j))
    _close(dt.fit_matrices["inductance_response"], dj.fit_matrices["inductance_response"])
    if name != "ideal":  # an ideal input's fitted rise is far below the sampling
        assert np.any(dt.fit_matrices["inductance_response"] != 0)
