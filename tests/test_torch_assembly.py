"""Port parity: EIS problem assembly (hybdrt_torch/models/drt.py and the ops it
uses) against the matrices the JAX BatchedEISFitter takes from its template
DRT fit, float64 on the CPU, rtol=1e-12 (the same closed forms and tables,
numpy in the port and jnp in the reference)."""
import numpy as np
import pytest
import jax.numpy as jnp

import bench
from hybdrt_tpu import preprocessing as jpp
from hybdrt_tpu.ops import basis as jbasis, lookup as jlookup, mat1d as jmat1d
from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter
from hybdrt_torch import preprocessing as tpp
from hybdrt_torch.models.drt import build_eis_problem
from hybdrt_torch.ops import basis as tbasis, lookup as tlookup, mat1d as tmat1d

RTOL = 1e-12
# XLA flushes subnormal results to zero where numpy keeps them (penalty
# entries of far-apart basis functions, exp(-a^2/2) < 2.2e-308)
ATOL = 1e-300
GRIDS = {"bench71": bench.make_batch(1, 71)[0], "grid31": np.logspace(5, -1, 31)}


@pytest.fixture(scope="module", params=list(GRIDS))
def pair(request):
    freq = GRIDS[request.param]
    return JaxFitter(freq, dtype=jnp.float64), build_eis_problem(freq)


def _hyp_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            np.testing.assert_allclose(np.asarray(a[k], dtype=float),
                                       np.asarray(b[k], dtype=float), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("key", ["rzm", "vmm", "m_stack", "l1v", "lb"])
def test_problem_arrays_match(pair, key):
    jf, prob = pair
    want = np.asarray(getattr(jf, key))
    assert prob[key].shape == want.shape
    np.testing.assert_allclose(prob[key], want, rtol=RTOL, atol=ATOL)


def test_problem_metadata_matches(pair):
    jf, prob = pair
    t = jf.template
    np.testing.assert_allclose(prob["basis_tau"], jf.basis_tau, rtol=RTOL)
    assert prob["tau_epsilon"] == pytest.approx(t.tau_epsilon, rel=RTOL)
    assert prob["inductance_scale"] == t.inductance_scale
    assert prob["special_qp_params"] == t.special_qp_params
    jcfg = jf.cfg._asdict()
    assert not jcfg.pop("nonlin") and jcfg.pop("half_size") == 0
    assert {k: getattr(prob["cfg"], k) for k in jcfg} == jcfg
    _hyp_equal(prob["hypers"], jf.hypers)
    _hyp_equal(prob["iw_hypers"], {k: None if v is None else np.asarray(v)
                                   for k, v in jf.iw_hyp.items()})


def test_impedance_lookup_matches():
    eps = float(jpp.get_epsilon_from_ppd(10))
    for (xt, yt), (xj, yj) in zip(tlookup.generate_impedance_lookup("gaussian", eps),
                                  jlookup.generate_impedance_lookup("gaussian", eps)):
        np.testing.assert_allclose(xt, xj, rtol=RTOL)
        np.testing.assert_allclose(yt, np.asarray(yj), rtol=1e-11, atol=ATOL)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_integrated_derivative_matrix_matches(order):
    grid = np.log(np.logspace(-7, 2, 37))
    got = tmat1d.construct_integrated_derivative_matrix(grid, order=order, epsilon=3.1)
    want = np.asarray(jmat1d.construct_integrated_derivative_matrix(grid, order=order,
                                                                    epsilon=3.1))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("part", ["real", "imag"])
def test_impedance_matrix_and_integrand_match(part):
    freq = np.logspace(6, -1, 29)
    tau = np.logspace(-7, 2, 41)
    got = tmat1d.construct_impedance_matrix(freq, part, tau, epsilon=4.0)
    want = np.asarray(jmat1d.construct_impedance_matrix(freq, part, tau, epsilon=4.0))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=ATOL)
    y = np.linspace(-5, 5, 11)
    np.testing.assert_allclose(
        tbasis.get_impedance_func(part)(y, 2.0, 0.3, 4.0),
        np.asarray(jbasis.get_impedance_func(part)(y, 2.0, 0.3, 4.0)), rtol=RTOL)


def test_var_matrix_and_grid_helpers_match():
    freq = np.logspace(5, -1, 31)
    np.testing.assert_allclose(tmat1d.construct_eis_var_matrix(freq, 0.25, 0.25),
                               np.asarray(jmat1d.construct_eis_var_matrix(freq, 0.25, 0.25)),
                               rtol=RTOL)
    np.testing.assert_allclose(tpp.get_basis_tau(freq), jpp.get_basis_tau(freq, None, None),
                               rtol=RTOL)
    assert tpp.get_epsilon_from_ppd(10) == jpp.get_epsilon_from_ppd(10)
    assert tbasis.get_basis_func_area("gaussian", 4.3) == jbasis.get_basis_func_area(
        "gaussian", 4.3)
    np.testing.assert_allclose(tmat1d.construct_inductance_impedance_vector(freq),
                               np.asarray(jmat1d.construct_inductance_impedance_vector(freq)),
                               rtol=RTOL)


def test_fixed_basis_and_hyper_overrides_match():
    freq = np.logspace(5, -1, 31)
    tau = np.logspace(-7, 1, 60)
    jf = JaxFitter(freq, basis_tau=tau, dtype=jnp.float64, l2_lambda_0=100.0, rp_scale=10.0)
    prob = build_eis_problem(freq, basis_tau=tau, l2_lambda_0=100.0, rp_scale=10.0)
    assert prob["tau_epsilon"] == pytest.approx(jf.template.tau_epsilon, rel=RTOL)
    for key in ("rzm", "m_stack", "lb"):
        np.testing.assert_allclose(prob[key], np.asarray(getattr(jf, key)), rtol=RTOL,
                                   atol=ATOL)
    _hyp_equal(prob["hypers"], jf.hypers)


@pytest.mark.parametrize("kw,item", [({"tau_basis_type": "Cole-Cole"}, "Queue 3 item 27"),
                                     ({"integrate_method": "trapz"}, "Queue 3 item 27"),
                                     ({"outlier_p": 0.05}, "item 9")],
                         ids=["kw0", "kw1", "kw2"])
def test_options_outside_the_slice_raise(kw, item):
    """The batched EIS problem takes the JAX fitter's template options only:
    the gaussian basis with 'interp' (ROADMAP Queue 3 item 27); the outlier
    model is unported (Queue 1 item 9)."""
    with pytest.raises(NotImplementedError, match=rf"{item}(?!\d)"):
        build_eis_problem(np.logspace(5, -1, 31), **kw)


def test_unknown_hyper_raises():
    with pytest.raises(ValueError, match="Invalid keyword"):
        build_eis_problem(np.logspace(5, -1, 31), l2_lamda_0=1.0)
