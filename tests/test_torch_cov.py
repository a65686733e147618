"""Port parity: ``BatchedEISFitter.param_cov`` against the JAX package's on the
CPU in float64 (``device="cpu"``), on the 12 spectra and 31 frequencies of
tests/test_torch_batch.py, and on 8 bench-kind spectra at 71 frequencies
(``make_batch``, the chip benchmark's knobs).

One JAX ``BatchFitResult`` is fed to both packages' ``param_cov``. The
posterior precision P that each package inverts is held within rtol=1e-6 of
each lane's max |P| (the parity tolerance of tests/test_torch_batch.py; it
reads 6e-16 from one result and 7e-11 from the two packages' own fits).
These posteriors reach cond(P) near 1e17, where the inverse is fixed to
hardly a digit: numpy's and torch's inverses of one and the same float64 P
differ there by several percent of max |cov|
(``test_inverse_of_the_worst_lane``). So the covariance is held three ways:

- as a whole, to the first-order bound of an inverse: within
  ``max(1e-6, cond(P) max(eps, dP))`` of each lane's max |cov|, where cond(P)
  is the 2-norm condition number of the JAX package's P and dP the lanes'
  relative difference between the two packages' P; lanes of small cond(P)
  are held to 1e-6;
- by the readouts users take from it, the CI band and sigma(R_inf)
  (``probe.cov_readouts``), each within its own first-order bound
  (``probe.readout_errors``), which follows that readout's sensitivity: near
  eps on a well-conditioned lane, and above 1e-6 only along P's near-null
  directions;
- as an inverse of the port's own P: backward error below N eps
  (``probe.inverse_residual``), however ill-conditioned P is.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hybdrt_tpu.models.drt import _hypers_to_pytree
from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter
from hybdrt_tpu.solver import qphb as jax_qphb
from hybdrt_torch import BatchedEISFitter
from hybdrt_torch.utils.probe import (cov_readouts, inverse_residual, make_batch,
                                      readout_errors)

from test_torch_batch import FREQ, KW, _batch

EPS = np.finfo(float).eps


@pytest.fixture(scope="module")
def z():
    return _batch()


@pytest.fixture(scope="module")
def fitters():
    """{qp_fused: (JAX fitter, port fitter)} with pred_stop."""
    return {fused: (JaxFitter(FREQ, dtype=jnp.float64, pred_stop=True, qp_fused=fused, **KW),
                    BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", pred_stop=True,
                                     qp_fused=fused, **KW))
            for fused in (False, True)}


@pytest.fixture(scope="module")
def results(fitters, z):
    """{qp_fused: (JAX result, port result)} of the two packages' own fits."""
    return {fused: (jf.fit(z), tf.fit(z)) for fused, (jf, tf) in fitters.items()}


def jax_precision(jf, result, z_batch, refine_iters):
    """The P that the JAX package's param_cov inverts: calculate_pq on the
    result's state, or on its refinement's (the refinement program that
    ``jf.param_cov(..., refine_iters)`` compiled, run on the same inputs)."""
    qp = jf.template.qphb_params
    m_stack = jnp.asarray(np.stack([np.asarray(qp["penalty_matrices"][f"m{k}"], dtype=float)
                                    for k in range(3)]))
    rzm = jnp.asarray(np.asarray(qp["rm"], dtype=float))
    l1v = jnp.asarray(np.asarray(qp["l1_lambda_vector"], dtype=float))
    hyp = _hypers_to_pytree(jf.hypers)
    rzv, _ = jf.scale_batch(z_batch)
    f = lambda a: jnp.asarray(np.asarray(a, dtype=float))
    rho, dop_rho, s, w = result.rho, result.dop_rho, result.s_vectors, result.weights
    if refine_iters:
        rho, dop_rho, s, w = jf._cov_jits[("cov_refine", refine_iters)](
            f(result.x_raw), f(s), f(rho), f(dop_rho), f(w), f(rzv), f(result.xmx_norms),
            f(result.dop_xmx_norms))
    p = jax.vmap(lambda rv, r, dr, sv, wv: jax_qphb.calculate_pq(
        rzm, rv, m_stack, hyp, l1v, r, dr, sv, wv, jf.cfg)[0])(f(rzv), f(rho), f(dop_rho),
                                                              f(s), f(w))
    return np.asarray(p)


def _lane_max(a):
    return np.max(np.abs(a), axis=(1, 2))


def assert_cov_match(cov_t, cov_j, p_t, p_j, u=None):
    """P within 1e-6 of each lane's max |P|, the covariance within the
    perturbation bound of the module docstring; for scaled covariances, also
    the readouts ``u`` within their bounds and the port's inverse within its
    backward error."""
    if u is not None:
        err, bound = readout_errors(cov_t, p_t, cov_j, p_j, u)
        assert np.all(err <= bound), (err / bound).max()
        assert np.all(inverse_residual(p_t, cov_t) <= p_t.shape[-1] * EPS)
    d_p = _lane_max(p_t - p_j) / _lane_max(p_j)
    assert np.all(d_p <= 1e-6), d_p
    cond = np.linalg.cond(p_j)
    bound = np.maximum(1e-6, cond * np.maximum(EPS, d_p))
    err = _lane_max(cov_t - cov_j) / _lane_max(cov_j)
    assert np.all(np.isfinite(cov_t)) and cov_t.shape == cov_j.shape
    assert np.all(err <= bound), (err, bound, cond)
    # the bound is the one a lane needs: the well-conditioned lanes hold 1e-6
    assert np.all(err[cond * np.maximum(EPS, d_p) < 1e-6] <= 1e-6)


@pytest.mark.parametrize("refine_iters", [0, 3])
@pytest.mark.parametrize("scaled", [False, True])
def test_param_cov_matches_jax(fitters, results, z, scaled, refine_iters):
    """One JAX result into both packages' param_cov."""
    jf, tf = fitters[False]
    r_j = results[False][0]
    cov_j = jf.param_cov(r_j, z, scaled=scaled, refine_iters=refine_iters)
    cov_t = tf.param_cov(r_j, z, scaled=scaled, refine_iters=refine_iters)
    p_t = tf._posterior(r_j, z, refine_iters)[0].numpy()
    assert_cov_match(cov_t, cov_j, p_t, jax_precision(jf, r_j, z, refine_iters),
                     cov_readouts(tf) if scaled else None)


@pytest.mark.parametrize("refine_iters", [0, 3])
def test_own_fit_param_cov_matches_jax(fitters, results, z, refine_iters):
    """Each package's own float64 fit into its own param_cov."""
    jf, tf = fitters[False]
    r_j, r_t = results[False]
    cov_j = jf.param_cov(r_j, z, scaled=True, refine_iters=refine_iters)
    cov_t = tf.param_cov(r_t, z, scaled=True, refine_iters=refine_iters)
    p_t = tf._posterior(r_t, z, refine_iters)[0].numpy()
    assert_cov_match(cov_t, cov_j, p_t, jax_precision(jf, r_j, z, refine_iters),
                     cov_readouts(tf))


def test_fused_refinement_matches_jax(fitters, results, z, monkeypatch):
    """A qp_fused fitter's refinement: the JAX package runs it with
    loop_mode="warm" and qp_max_iter_warm=None, so no step count to fuse:
    qp_max_iter unfused Mehrotra steps from the lane's x, the same QPs as a
    plain fitter's. The port's matches the JAX fused fitter's, equals the
    plain fitter's bit for bit, and runs no fused steps."""
    from hybdrt_torch.ops import qp

    jf, tf = fitters[True]
    tf_plain = fitters[False][1]
    r_j = results[True][0]

    def refuse(*args):
        raise AssertionError("the refinement ran the fused steps")

    monkeypatch.setattr(qp, "ip_steps_lane", refuse)
    cov_t = tf.param_cov(r_j, z, scaled=True, refine_iters=3)
    np.testing.assert_array_equal(cov_t, tf_plain.param_cov(r_j, z, scaled=True,
                                                             refine_iters=3))
    cov_j = jf.param_cov(r_j, z, scaled=True, refine_iters=3)
    p_t = tf._posterior(r_j, z, 3)[0].numpy()
    assert_cov_match(cov_t, cov_j, p_t, jax_precision(jf, r_j, z, 3), cov_readouts(tf))


@pytest.mark.parametrize("refine_iters", [0, 3])
def test_lazy_result_matches_full(fitters, z, refine_iters):
    """A lazy result (weights and s_vectors as tensors) gives the full
    result's covariance bit for bit."""
    tf = fitters[False][1]
    full, lazy = tf.fit(z), tf.fit(z, collect="lazy")
    assert isinstance(lazy.s_vectors, torch.Tensor)
    np.testing.assert_array_equal(tf.param_cov(lazy, z, refine_iters=refine_iters),
                                  tf.param_cov(full, z, refine_iters=refine_iters))


def test_physical_units(fitters, results, z):
    """The physical covariance is the scaled one with each row and column
    times the lane's scale, the inductance's also times the inductance
    scale (DRT.estimate_param_cov's factors)."""
    tf = fitters[False][1]
    r_t = results[False][1]
    scaled, phys = tf.param_cov(r_t, z, scaled=True), tf.param_cov(r_t, z)
    col = np.ones(scaled.shape[-1])
    col[tf.special_qp_params["inductance"]["index"]] = tf.inductance_scale
    sv = r_t.scale[:, None] * col[None, :]
    np.testing.assert_allclose(phys, scaled * sv[:, :, None] * sv[:, None, :], rtol=1e-15,
                               atol=0)


def test_inverse_of_the_worst_lane(fitters, results, z):
    """Why the bounds grow with the conditioning: on these posteriors two
    LAPACK inverses of one and the same float64 P (numpy's and torch's)
    differ by far more than 1e-6 of max |cov| on the worst-conditioned lane,
    and within cond(P) eps on every lane; their readouts differ by more than
    1e-6 there too, and within the readout bound everywhere."""
    jf, tf = fitters[False]
    p_j = jax_precision(jf, results[False][0], z, 0)
    cond = np.linalg.cond(p_j)
    c_np, c_t = np.linalg.inv(p_j), torch.linalg.inv(torch.tensor(p_j)).numpy()
    spread = _lane_max(c_np - c_t) / _lane_max(c_np)
    assert cond.max() > 1e15 and spread[np.argmax(cond)] > 1e-4
    assert np.all(spread <= np.maximum(1e-6, cond * EPS))
    err, bound = readout_errors(c_t, p_j, c_np, p_j, cov_readouts(tf))
    assert err[np.argmax(cond)].max() > 1e-6 and np.all(err <= bound)


@pytest.fixture(scope="module")
def bench():
    """8 bench-kind spectra (make_batch at 71 frequencies) fitted by the JAX
    package in float32 with the chip benchmark's knobs, as the card's fits
    that param_cov refines: (JAX f64 fitter, port fitter, JAX result, z)."""
    freq, z = make_batch(8, 71)
    kw = dict(max_iter=50, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)
    r32 = JaxFitter(freq, dtype=jnp.float32, **kw).fit(z)
    return (JaxFitter(freq, dtype=jnp.float64, **kw),
            BatchedEISFitter(freq, dtype=torch.float64, device="cpu", **kw), r32, z)


def test_refinement_condition_matches_jax(bench):
    """cond(P) before and after 3 refinement steps on bench-kind lanes, one
    JAX float32 fit fed to both packages: the covariances match as in the
    tests above, and the two packages agree on cond(P). Where cond(P) (sqrt(N)
    eps + dP) < 1, with dP = ||P_port - P_jax||_2 / ||P_jax||_2, the port's
    cond(P) is within twice that of the JAX package's (the first-order
    change of the extreme singular values); above it, P is numerically
    singular, its cond(P) noise, and the port's is above the line too. The
    refinement turns lanes of cond(P) ~1e5 numerically singular in both
    packages."""
    jf, tf, r32, z = bench
    u = cov_readouts(tf)
    singular = {}
    for r in (0, 3):
        cov_j = jf.param_cov(r32, z, scaled=True, refine_iters=r)
        cov_t = tf.param_cov(r32, z, scaled=True, refine_iters=r)
        p_j = jax_precision(jf, r32, z, r)
        p_t = tf._posterior(r32, z, r)[0].numpy()
        assert_cov_match(cov_t, cov_j, p_t, p_j, u)
        norm = lambda a: np.linalg.norm(a, 2, axis=(1, 2))
        line = np.sqrt(p_j.shape[-1]) * EPS + norm(p_t - p_j) / norm(p_j)
        cond_j, cond_t = np.linalg.cond(p_j), np.linalg.cond(p_t)
        singular[r] = cond_j * line >= 1
        held = ~singular[r]
        assert np.all(np.abs(cond_t / cond_j - 1)[held] <= 2 * (cond_j * line)[held])
        assert np.all(cond_t[singular[r]] * line[singular[r]] >= 1)
    assert np.any(~singular[0] & singular[3]) and np.all(singular[0] <= singular[3])
