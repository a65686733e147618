"""Port parity: the batched EIS fit end to end (hybdrt_torch.BatchedEISFitter)
against the JAX BatchedEISFitter on the same 12 spectra and 31 frequencies,
float64 on the CPU (``device="cpu"``; the fitter's default is the card).
Coefficients within rtol=1e-6, atol=1e-10 (the batched vs single-fit
tolerance of tests/test_parallel.py) and identical per-lane iteration counts
and convergence flags, for the plain and the fused (``qp_fused=True``) warm
QP path."""
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter
from hybdrt_torch import BatchedEISFitter
from hybdrt_torch.solver import fitcore
from hybdrt_torch.solver.qphb import state_from_numpy
from hybdrt_torch.utils.device import resolve_device

# The suite runs several test processes at once; torch's default of one
# thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

FREQ = np.logspace(5, -1, 31)
KW = dict(qp_max_iter=20, qp_max_iter_warm=4, pred_rtol=3e-2)


def _batch(b=12, seed=0):
    rng = np.random.default_rng(seed)
    taus = 10 ** rng.uniform(-3, 0, b)
    rs = rng.uniform(0.5, 2.0, b)
    z = 0.5 + np.stack([r / (1 + (2j * np.pi * FREQ * t) ** 0.9) for r, t in zip(rs, taus)])
    return z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 0.003


def jax_problem(jf):
    """The JAX fitter's problem as the dict BatchedEISFitter.from_arrays takes."""
    t = jf.template
    cfg = {k: v for k, v in jf.cfg._asdict().items() if k not in ("nonlin", "half_size")}
    return {
        "frequencies": jf.frequencies, "rzm": np.asarray(jf.rzm), "vmm": np.asarray(jf.vmm),
        "m_stack": np.asarray(jf.m_stack), "l1v": np.asarray(jf.l1v), "lb": np.asarray(jf.lb),
        "hypers": dict(jf.hypers),
        "iw_hypers": {k: v if v is None or np.isscalar(v) else np.asarray(v)
                      for k, v in jf.iw_hyp.items()},
        "cfg": cfg, "special_qp_params": dict(t.special_qp_params),
        "basis_tau": np.asarray(jf.basis_tau), "tau_epsilon": float(t.tau_epsilon),
        "inductance_scale": t.inductance_scale,
    }


@pytest.fixture(scope="module")
def data():
    z = _batch()
    out = {"z": z}
    for ps in (False, True):
        jf = JaxFitter(FREQ, dtype=jnp.float64, pred_stop=ps, **KW)
        tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", pred_stop=ps, **KW)
        out[ps] = (jf, tf, jf.fit(z), tf.fit(z))
    return out


@pytest.fixture(scope="module")
def fused(data):
    """qp_fused=True fits of the same spectra: (port fitter, JAX result,
    port result) per pred_stop."""
    out = {}
    for ps in (False, True):
        jf = JaxFitter(FREQ, dtype=jnp.float64, pred_stop=ps, qp_fused=True, **KW)
        tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", pred_stop=ps,
                              qp_fused=True, **KW)
        out[ps] = (tf, jf.fit(data["z"]), tf.fit(data["z"]))
    return out


def _assert_fit_match(r_t, r_j, rtol=1e-6, atol=1e-10):
    np.testing.assert_array_equal(r_t.n_iter, r_j.n_iter)
    np.testing.assert_array_equal(r_t.converged, r_j.converged)
    for f in ("x", "r_inf", "inductance", "x_raw", "rho", "weights", "s_vectors"):
        np.testing.assert_allclose(np.asarray(getattr(r_t, f)), np.asarray(getattr(r_j, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("adaptive", [False, "staged"])
@pytest.mark.parametrize("pred_stop", [False, True])
def test_fit_matches_jax(data, pred_stop, adaptive):
    jf, tf, r_j, r_plain = data[pred_stop]
    r_t = r_plain if adaptive is False else tf.fit(data["z"], adaptive=adaptive)
    _assert_fit_match(r_t, r_j)
    np.testing.assert_allclose(tf.predict_z(r_t), jf.predict_z(r_j), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tf.predict_r_p(r_t), jf.predict_r_p(r_j), rtol=1e-6)


@pytest.mark.parametrize("pred_stop", [False, True])
def test_staged_matches_plain(data, pred_stop):
    """adaptive="staged" runs the same live-lane loop as the plain fit, so
    the two agree bit for bit."""
    _, tf, _, r_plain = data[pred_stop]
    r_st = tf.fit(data["z"], adaptive="staged")
    _assert_fit_match(r_st, r_plain, rtol=0, atol=0)


@pytest.mark.parametrize("adaptive", [False, "staged"])
@pytest.mark.parametrize("pred_stop", [False, True])
def test_fused_fit_matches_jax(data, fused, pred_stop, adaptive):
    """The fused warm QP path (cold iteration 0 peeled off, then qp_max_iter_warm
    fixed Mehrotra steps per warm QP) against the JAX fused fit."""
    tf, r_j, r_fused = fused[pred_stop]
    assert tf.fcfg.qp_fused and tf.fcfg.qp_max_iter_warm == KW["qp_max_iter_warm"]
    r_t = r_fused if adaptive is False else tf.fit(data["z"], adaptive=adaptive)
    _assert_fit_match(r_t, r_j)


def test_fused_matches_plain(data, fused):
    """Fused and plain warm QPs take different steps but polish onto the same
    KKT points: fit-level outputs agree at the tolerances of
    tests/test_parallel.py::test_qp_fused_matches_plain."""
    _, tf_plain, _, r_p = data[True]
    tf, _, r_f = fused[True]
    assert np.all(np.isfinite(r_f.x))
    assert np.max(np.abs(tf_plain.predict_r_p(r_p) - tf.predict_r_p(r_f))) < 2e-3
    assert np.max(np.abs(r_p.r_inf - r_f.r_inf)) < 1e-3
    assert np.max(np.abs(tf_plain.predict_z(r_p) - tf.predict_z(r_f))) < 2e-3


def test_qp_fused_defaults_its_step_count():
    """qp_fused runs the warm cap as its step count, 8 when none is given
    (hybdrt_tpu/parallel/batch.py:252-256)."""
    tf = BatchedEISFitter(FREQ, device="cpu", qp_fused=True)
    assert tf.fcfg.qp_fused and tf.fcfg.qp_max_iter_warm == 8
    tf = BatchedEISFitter(FREQ, device="cpu", qp_fused=True, qp_max_iter_warm=3)
    assert tf.fcfg.qp_max_iter_warm == 3
    assert not BatchedEISFitter(FREQ, device="cpu").fcfg.qp_fused


def test_from_arrays_matches_own_assembly(data):
    jf, tf, _, r_t = data[True]
    tf2 = BatchedEISFitter.from_arrays(jax_problem(jf), dtype=torch.float64, device="cpu",
                                       pred_stop=True, **KW)
    _assert_fit_match(tf2.fit(data["z"]), r_t)


def test_resume_from_jax_state_matches(data):
    """A JAX fit cut at 3 iterations, resumed by the port from its state and
    prediction history, lands where the uninterrupted JAX fit lands."""
    jf, tf, r_j, _ = data[True]
    rzv, _ = jf.scale_batch(data["z"])
    state, est, (y1, y2) = jax.vmap(lambda rv: jf._fit_phase_single(rv, 3))(jnp.asarray(rzv))
    assert np.all(np.asarray(state.it) <= 3)
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    st = fitcore.qphb_fit_loop_from_state(
        state_from_numpy(jax.tree.map(np.asarray, state)), tf.rzm, t(rzv), tf.vmm,
        tf.m_stack, tf.l1v, tf.lb, tf.hyp, t(est), tf.fcfg, y_prev0=t(y1), y_prev2_0=t(y2))
    np.testing.assert_array_equal(st.it.numpy(), r_j.n_iter)
    np.testing.assert_allclose(st.x.numpy(), r_j.x_raw, rtol=1e-6, atol=1e-10)


def test_resume_own_state_matches(data):
    """The port's own loop cut at 3 iterations (with its prediction history)
    and resumed to max_iter lands exactly where the uninterrupted fit does."""
    _, tf, _, r_t = data[True]
    rzv, _ = tf.scale_batch(data["z"])
    rzv = torch.as_tensor(rzv, dtype=torch.float64)
    inp = tf._loop_inputs(rzv)
    st, y1, y2 = fitcore.qphb_fit_loop(
        tf.rzm, rzv, tf.vmm, tf.m_stack, tf.l1v, tf.lb, tf.hyp, inp["x0"], inp["s0"],
        inp["rho0"], inp["dop_rho0"], inp["init_weights"], inp["est_weights"],
        inp["outlier_t0"], replace(tf.fcfg, max_iter=3), return_pred_history=True)
    assert int(st.it.max()) <= 3
    st = fitcore.qphb_fit_loop_from_state(st, tf.rzm, rzv, tf.vmm, tf.m_stack, tf.l1v, tf.lb,
                                          tf.hyp, inp["est_weights"], tf.fcfg, y_prev0=y1,
                                          y_prev2_0=y2)
    np.testing.assert_array_equal(st.it.numpy(), r_t.n_iter)
    np.testing.assert_array_equal(st.x.numpy(), r_t.x_raw)


def test_lazy_collect_matches_full(data):
    _, tf, _, r_full = data[False]
    r_lazy = tf.fit(data["z"], collect="lazy")
    assert isinstance(r_lazy.weights, torch.Tensor)
    assert isinstance(r_lazy.s_vectors, torch.Tensor)
    np.testing.assert_array_equal(r_lazy.weights.numpy(), r_full.weights)
    np.testing.assert_array_equal(r_lazy.s_vectors.numpy(), r_full.s_vectors)
    np.testing.assert_array_equal(r_lazy.x, r_full.x)


def test_bucket_pad_and_state_shapes(data):
    """The port pads no batch to a bucket size (eager PyTorch compiles
    nothing per shape): a batch of 5 runs as 5 lanes and fits each spectrum
    as the batch of 12 does."""
    _, tf, _, r = data[False]
    res, states = tf.fit(data["z"][:5], return_states=True)
    assert res.x.shape == (5, len(tf.basis_tau)) and states.x.shape[0] == 5
    np.testing.assert_allclose(res.x, r.x[:5], rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("kw,exc", [
    ({"adaptive": 1}, ValueError), ({"adaptive": "stage"}, ValueError),
    ({"adaptive": "staged", "phase_budgets": (14, 8)}, ValueError),
    ({"collect": "lazy", "return_states": True}, ValueError),
    ({"collect": "eager"}, ValueError),
    ({"adaptive": True, "phase_budgets": (8, 20)}, ValueError),
    ({"return_history": True, "collect": "lazy"}, ValueError),
])
def test_fit_rejects_bad_options(data, kw, exc):
    _, tf, _, _ = data[False]
    with pytest.raises(exc):
        tf.fit(data["z"][:2], **kw)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        BatchedEISFitter(FREQ, device="cpu", mesh=object())


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEISFitter(FREQ, device="cuda")


def test_default_device_is_the_card(data):
    """With no device given the fitter takes the CUDA card, and without one
    it raises instead of falling back to the CPU; device="cpu" asks for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jf = data[False][0]
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEISFitter(FREQ)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEISFitter.from_arrays(jax_problem(jf))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert BatchedEISFitter(FREQ, device="cpu").device == torch.device("cpu")
    assert BatchedEISFitter.from_arrays(jax_problem(jf), device="cpu").rzm.device.type == "cpu"
