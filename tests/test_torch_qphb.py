"""Port parity: QPHB solver steps (hybdrt_torch/solver/qphb.py) against the JAX
reference vmapped over the same lanes: weight initialization and one outer
iteration in each warm mode, float64 on the CPU, B=8, rtol=1e-9 (the same
Mehrotra iterations; only BLAS/LAPACK summation order differs). The
tolerance is normwise: rtol=1e-9 of each array's largest entry, because the
overfit weight-initialization QP has cond(P) ~ 1e7, which amplifies the
summation-order differences in the smallest components."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter
from hybdrt_tpu.solver import qphb as jqphb
from hybdrt_torch import BatchedEISFitter
from hybdrt_torch.solver import fitcore, qphb as tqphb

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

B = 8
RTOL = 1e-9
FREQ = np.logspace(5, -1, 31)
KW = dict(qp_max_iter=20, qp_max_iter_warm=4)


def _spectra():
    rng = np.random.default_rng(21)
    w = 2j * np.pi * FREQ
    z = np.stack([0.4 + rng.uniform(0.5, 1.5) / (1 + (w * 10 ** rng.uniform(-4, -1)) ** 0.85)
                  + rng.uniform(0.2, 1) / (1 + (w * 10 ** rng.uniform(-1, 0.5)) ** 0.9)
                  for _ in range(B)])
    return z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 3e-3


@pytest.fixture(scope="module")
def setup():
    jf = JaxFitter(FREQ, dtype=jnp.float64, **KW)
    tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", **KW)
    rzv, _ = jf.scale_batch(_spectra())
    # a state two outer iterations in, with QP duals to warm-start from
    state2, est, _ = jax.vmap(lambda rv: jf._fit_phase_single(rv, 2))(jnp.asarray(rzv))
    return jf, tf, rzv, state2, est


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.max(np.abs(want)),
                               err_msg=err_msg)


def _assert_state(st_t, st_j):
    for f in dataclasses.fields(tqphb.QPHBState):
        got, want = getattr(st_t, f.name), getattr(st_j, f.name)
        if want is None:
            assert got is None, f.name
            continue
        _close(got.numpy(), want, f.name)


def test_initialize_weights_matches(setup):
    jf, tf, rzv, _, _ = setup
    rho0 = jnp.asarray(jf.hypers["rho_0"])
    s0 = jnp.ones((3, jf.rzm.shape[1]))
    out_j = jax.vmap(lambda rv: jqphb.initialize_weights(
        jf.iw_hyp, jf.m_stack, rho0, jnp.ones(3), s0, rv, jf.rzm, jf.vmm, jf.lb, jf.cfg))(
        jnp.asarray(rzv))
    out_t = tqphb.initialize_weights(tf.iw_hyp, tf.m_stack, _t(rho0), _t(s0), _t(rzv), tf.rzm,
                                     tf.vmm, tf.lb, tf.cfg)
    for name, got, want in zip(("est", "init", "x_overfit", "outlier_t"), out_t, out_j):
        _close(got.numpy(), want, name)


@pytest.mark.parametrize("start,warm_mode", [("it0", "auto"), ("it2", "auto"),
                                             ("it2", "warm"), ("it2", "cold"),
                                             ("it2", "fused")])
def test_iterate_qphb_matches(setup, start, warm_mode):
    """"fused" is warm_mode="warm" with qp_fused_steps=4."""
    fused = 4 if warm_mode == "fused" else None
    warm_mode = "warm" if fused else warm_mode
    jf, tf, rzv, state2, est = setup
    if start == "it0":
        state = state2._replace(it=jnp.zeros_like(state2.it),
                                qp_dual=jnp.zeros_like(state2.qp_dual))
    else:
        state = state2
    assert np.all(np.asarray(state.it) == (0 if start == "it0" else 2))

    def step(st, rv, e):
        return jqphb.iterate_qphb(st, rv, jf.rzm, jf.vmm, jf.m_stack, jf.m_stack[1], None,
                                  jf.l1v, jf.lb, e, jf.hyp, jf.cfg, warm_mode=warm_mode,
                                  qp_fused_steps=fused, **KW)

    st_j, qp_j = jax.vmap(step)(state, jnp.asarray(rzv), est)
    st_t, qp_t = tqphb.iterate_qphb(
        tqphb.state_from_numpy(jax.tree.map(np.asarray, state)), _t(rzv), tf.rzm, tf.vmm,
        tf.m_stack, tf.m_stack[1], tf.l1v, tf.lb, _t(est), tf.hyp, tf.cfg,
        warm_mode=warm_mode, qp_fused_steps=fused, **KW)
    np.testing.assert_array_equal(qp_t.iterations.numpy(), np.asarray(qp_j.iterations))
    _assert_state(st_t, st_j)


def test_fused_fit_resumes_exactly(setup):
    """A fused fit (qp_fused) cut at max_iter=3 and resumed statically warm
    (peel_cold_start=False) with its prediction history lands bit for bit
    where the uninterrupted fused fit lands."""
    _, _, rzv, _, _ = setup
    tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", qp_fused=True,
                          pred_stop=True, pred_rtol=3e-2, **KW)
    rzv = _t(rzv)
    inp = tf._loop_inputs(rzv)
    args = (tf.rzm, rzv, tf.vmm, tf.m_stack, tf.l1v, tf.lb, tf.hyp, inp["x0"], inp["s0"],
            inp["rho0"], inp["dop_rho0"], inp["init_weights"], inp["est_weights"],
            inp["outlier_t0"])
    full, fy1, fy2 = fitcore.qphb_fit_loop(*args, tf.fcfg, return_pred_history=True)
    st, y1, y2 = fitcore.qphb_fit_loop(*args, dataclasses.replace(tf.fcfg, max_iter=3),
                                       return_pred_history=True)
    assert int(st.it.max()) == 3 and int(full.it.max()) > 3
    st, y1, y2 = fitcore.qphb_fit_loop_from_state(
        st, tf.rzm, rzv, tf.vmm, tf.m_stack, tf.l1v, tf.lb, tf.hyp, inp["est_weights"],
        tf.fcfg, y_prev0=y1, y_prev2_0=y2, peel_cold_start=False, return_pred_history=True)
    assert torch.equal(st.it, full.it) and torch.equal(st.converged, full.converged)
    assert torch.equal(st.x, full.x)
    assert torch.equal(y1, fy1) and torch.equal(y2, fy2)


def test_closed_form_updates_match(setup):
    jf, tf, rzv, state2, _ = setup
    ns = jf.cfg.num_special
    x = np.asarray(state2.x)[:, ns:]
    sv = np.asarray(state2.s_vectors)[:, 0, ns:]
    pm = np.asarray(jf.m_stack[0])[ns:, ns:]
    sx = np.sign(x) * np.sqrt(np.abs(x))
    g = np.asarray(jf.m_stack[1])[ns:, ns:][None] * sx[:, :, None] * sx[:, None, :]
    want = jax.vmap(lambda xx, ss, gg: jqphb.solve_s_integral(pm, xx, ss, 1.0, 5.0, 4.0, gg,
                                                              1.0))(x, sv, g)
    got = tqphb.solve_s_integral(_t(pm), _t(x), _t(sv), 1.0, 5.0, 4.0, _t(g), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    xmx = np.asarray(state2.xmx_norms)[:, 0]
    want = jax.vmap(lambda xx, ss, nn: jqphb.solve_rho(pm, xx, ss, 0.15, 0.15, nn))(x, sv, xmx)
    got = tqphb.solve_rho(_t(pm), _t(x), _t(sv), 0.15, 0.15, _t(xmx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    l2_j = jax.vmap(lambda r, s: jqphb.calculate_qp_l2_matrix(jf.hyp, r, None, jf.m_stack, s,
                                                              jf.cfg))(
        state2.rho_vector, state2.s_vectors)
    l2_t = tqphb.calculate_qp_l2_matrix(tf.hyp, _t(state2.rho_vector), tf.m_stack,
                                        _t(state2.s_vectors), tf.cfg)
    _close(l2_t.numpy(), l2_j)


def test_weights_and_convergence_match(setup):
    jf, tf, rzv, state2, est = setup
    x = np.asarray(state2.x)
    w_j, _, _ = jax.vmap(lambda xx, rv, e: jqphb.estimate_weights(xx, rv, jf.vmm, jf.rzm, e))(
        x, jnp.asarray(rzv), est)
    w_t, _ = tqphb.estimate_weights(_t(x), _t(rzv), tf.vmm, tf.rzm, _t(est))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL)
    x2 = x * (1 + np.linspace(-0.02, 0.02, x.shape[1]))
    atol = x.mean(axis=1) * 1e-3
    for rtol in (1e-3, 1e-2, 3e-2):
        want = np.asarray(jax.vmap(lambda a, b, c: jqphb.is_converged(a, b, c, rtol))(x, x2,
                                                                                     atol))
        got = tqphb.is_converged(_t(x), _t(x2), _t(atol), rtol).numpy()
        np.testing.assert_array_equal(got, want)
