"""Port parity: the distribution-of-phasances matrices (hybdrt_torch/ops/
phasance.py), the capacitance vectors and the penalty branches of
ops/mat1d.py the DOP reaches, and the DOP's assembly in ``build_eis_problem``,
against the JAX package's functions, float64 on the CPU.

Held: the phasor matrices within 1e-12 of their max |entry| (the complex erf
of the gaussian integral is the same 32-term series in numpy and jnp); the
complex erf against the JAX series and against ``scipy.special.erf`` on
complex input; the capacitance vectors, the delta basis's difference
penalties, the weighted-order and truncated gaussian penalties within 1e-12
relative; the JAX package's ``ValueError``s where it refuses.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import scipy.special

from hybdrt_tpu.ops import mat1d as jmat1d, phasance as jph
from hybdrt_torch.models.drt import build_eis_problem
from hybdrt_torch.ops import basis as tbasis, mat1d as tmat1d, phasance as tph

REL = 1e-12
FREQ = np.logspace(5, -2, 51)
NU = np.concatenate([np.linspace(-1, -0.4, 25), np.linspace(0.4, 1, 25)])
EPS_NU = 1 / np.median(np.diff(np.sort(NU)))
# the het protocol's kind of chrono data: pre-step samples, then log-spaced
TIMES = np.concatenate([np.linspace(-0.01, -1e-3, 6), np.geomspace(1e-5, 1.0, 40)])
STEP_TIMES, STEP_SIZES = np.array([0.0, 0.4]), np.array([0.1, -0.05])


def _close(got, want, rel=REL):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rel * np.max(np.abs(want)), \
        np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_complex_erf_matches_the_series_and_scipy():
    rng = np.random.default_rng(0)
    z = rng.uniform(-3, 3, 400) + 1j * rng.uniform(-2, 2, 400)
    z[:3] = [0.0, 1.5j, -0.7j]   # the x = 0 branch
    got = tph._complex_erf(z)
    _close(got, jph._complex_erf(jnp.asarray(z)), rel=1e-14)
    np.testing.assert_allclose(got, scipy.special.erf(z), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("nu_basis_type", ["gaussian", "delta"])
def test_phasor_z_matrix_matches(nu_basis_type):
    eps = None if nu_basis_type == "delta" else EPS_NU
    got = tph.construct_phasor_z_matrix(FREQ, NU, nu_basis_type, eps)
    _close(got, jph.construct_phasor_z_matrix(FREQ, NU, nu_basis_type, eps))


@pytest.mark.parametrize("nu_basis_type", ["gaussian", "delta"])
def test_phasor_v_matrix_matches(nu_basis_type):
    eps = None if nu_basis_type == "delta" else EPS_NU
    got, layered = tph.construct_phasor_v_matrix(TIMES, NU, nu_basis_type, eps, "ideal",
                                                 STEP_TIMES, STEP_SIZES)
    want, want_layered = jph.construct_phasor_v_matrix(TIMES, NU, nu_basis_type, eps, "ideal",
                                                       STEP_TIMES, STEP_SIZES)
    _close(got, want)
    _close(layered, want_layered)
    # nothing before the first step
    assert np.all(got[TIMES <= 0] == 0)


def test_phasor_v_matrix_refuses_what_jax_refuses():
    for kw, msg in (({"op_mode": "pot"}, "galvanostatic"), ({"step_model": "expdecay"},
                                                            "ideal steps")):
        args = dict(step_model="ideal", op_mode="galv") | kw
        for mod in (tph, jph):
            with pytest.raises(ValueError, match=msg):
                mod.construct_phasor_v_matrix(TIMES, NU, "gaussian", EPS_NU, args["step_model"],
                                              STEP_TIMES, STEP_SIZES, args["op_mode"])


def test_unit_phasors_and_scale_vector_match():
    t = np.geomspace(1e-5, 10, 30)[:, None]
    nu = np.linspace(-1, 1, 21)[None, :]
    got = tph.unit_phasor_voltage(t, nu)
    _close(got, jph.unit_phasor_voltage(jnp.asarray(t), jnp.asarray(nu)))
    # at nu = 1, gammaln(0) is inf and the phasor voltage is 0, as in JAX
    assert np.all(got[:, -1] == 0)
    w = 2 * np.pi * FREQ[:, None]
    _close(tph.unit_phasor_impedance(w, nu), jph.unit_phasor_impedance(w, nu))
    tau = np.logspace(-8, 3, 111)
    _close(tph.phasor_scale_vector(NU, tau), jph.phasor_scale_vector(NU, tau))
    _close(tph.phasor_scale_vector(NU, tau, (0.1, 0.9)),
           jph.phasor_scale_vector(NU, tau, (0.1, 0.9)))


def test_capacitance_vectors_match():
    _close(tmat1d.construct_capacitance_impedance_vector(FREQ),
           jmat1d.construct_capacitance_impedance_vector(FREQ))
    _close(tmat1d.construct_capacitance_response_vector(TIMES, "ideal", STEP_TIMES, STEP_SIZES,
                                                        None),
           jmat1d.construct_capacitance_response_vector(TIMES, "ideal", STEP_TIMES, STEP_SIZES,
                                                        None))
    for mod in (tmat1d, jmat1d):
        with pytest.raises(ValueError, match="non-ideal"):
            mod.construct_capacitance_response_vector(TIMES, "expdecay", STEP_TIMES, STEP_SIZES,
                                                      np.array([1e-4, 1e-4]))


@pytest.mark.parametrize("order", [0, 1, 2])
def test_delta_and_truncated_penalties_match(order):
    grid = np.sort(np.random.default_rng(order).uniform(-3, 3, 17))
    _close(tmat1d.construct_integrated_derivative_matrix(grid, "delta", order),
           jmat1d.construct_integrated_derivative_matrix(grid, "delta", order))
    lim = (-1.5, 2.0)
    _close(tmat1d.construct_integrated_derivative_matrix(grid, order=order, epsilon=1.7,
                                                         integration_limits=lim),
           jmat1d.construct_integrated_derivative_matrix(grid, order=order, epsilon=1.7,
                                                         integration_limits=lim))


def test_weighted_orders_and_order_three_match():
    grid = np.linspace(-2, 2, 15)
    _close(tmat1d.construct_integrated_derivative_matrix(grid, order=[0.5, 1.0, 0.25],
                                                         epsilon=2.3),
           jmat1d.construct_integrated_derivative_matrix(grid, order=[0.5, 1.0, 0.25],
                                                         epsilon=2.3))
    _close(tmat1d.construct_integrated_derivative_matrix(grid, order=3, epsilon=2.3),
           jmat1d.construct_integrated_derivative_matrix(grid, order=3, epsilon=2.3))
    with pytest.raises(ValueError, match="delta"):
        tmat1d.construct_integrated_derivative_matrix(grid, "delta", 3)


def test_delta_nu_basis_functions():
    """The delta basis of the DOP: its function, area and order-0 eval
    matrix, as the JAX package has them."""
    grid = np.linspace(-1, 1, 5)
    np.testing.assert_array_equal(tbasis.construct_func_eval_matrix(grid, grid, "delta"),
                                  np.eye(5))
    assert tbasis.get_basis_func_area("delta", None) == 1.0
    with pytest.raises(ValueError, match="order 1"):
        tbasis.construct_func_eval_matrix(grid, grid, "delta", order=1)


@pytest.mark.parametrize("kw", [{"fit_dop": True}, {"fit_capacitance": True},
                                {"fit_dop": True, "fit_capacitance": True}],
                         ids=["dop", "capacitance", "both"])
def test_dop_problem_matches_the_jax_system(kw):
    """build_eis_problem with the DOP block and the C_inv column, and the
    port DRT's prep-only system, against the JAX DRT's prep-only system
    (the arrays the JAX BatchedEISFitter reads off its template): design,
    penalty stack with the DOP block, l1, bounds, the DOP's smoothing
    matrices and column scale, within 1e-12 relative (1e-300 absolute: XLA
    flushes subnormal penalty entries to zero)."""
    import hybdrt_tpu
    import hybdrt_torch
    z = 0.4 + 1.0 / (1 + (2j * np.pi * FREQ * 1e-2) ** 0.9)
    sj = hybdrt_tpu.DRT(warn=False, **kw)._qphb_fit_core(None, None, None, FREQ, z,
                                                       prep_only=True)
    st = hybdrt_torch.DRT(warn=False, device="cpu", **kw)._qphb_fit_core(
        None, None, None, FREQ, z, prep_only=True)
    prob = build_eis_problem(FREQ, **kw)
    for key_t, key_p in (("rzm", "rzm"), ("m_stack", "m_stack"),
                         ("l1_lambda_vector", "l1v"), ("lb", "lb"), ("vmm", "vmm")):
        want = np.asarray(sj[key_t])
        for got in (st[key_t], prob[key_p]):
            np.testing.assert_allclose(got, want, rtol=REL, atol=1e-300, err_msg=key_t)
    for s in (st, prob):
        assert s["cfg"] == type(s["cfg"])(**sj["cfg"]._asdict())
        assert s["special_qp_params"] == sj["special_qp_params"]
    np.testing.assert_array_equal(st["dop_rho_vector"], sj["dop_rho_vector"])
    if kw.get("fit_dop"):
        for got in (np.stack(st["dop_gmat"]), prob["dop_gmat"]):
            np.testing.assert_allclose(got, np.stack(sj["dop_gmat"]), rtol=REL, atol=1e-300)
        for got in (st["dop_scale_vector"], prob["dop_scale_vector"]):
            np.testing.assert_allclose(got, sj["dop_scale_vector"], rtol=REL)
    else:
        assert st["dop_gmat"] is None and sj["dop_gmat"] is None
    assert st["capacitance_scale"] == sj["capacitance_scale"] == prob["capacitance_scale"]
