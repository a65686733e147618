"""Port parity: ``BatchedEISFitter.fit(return_history=True)`` against the JAX
package's on the CPU in float64 (``device="cpu"``), on the 12 spectra and 31
frequencies of tests/test_torch_batch.py.

Every key of the history, at every iteration, is held within rtol=1e-6,
atol=1e-10 of the JAX package's (the tolerance of tests/test_torch_batch.py);
``it``, ``converged``, ``n_iter`` and the convergence flags are identical.
Cases: plain, pred_stop, and a qp_fused fitter, whose history fit runs
unfused QPs as the JAX package's history scan does.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter
from hybdrt_torch import BatchedEISFitter
from hybdrt_torch.solver.fitcore import HISTORY_FIELDS

from test_torch_batch import FREQ, KW, _assert_fit_match, _batch

CASES = {"plain": dict(pred_stop=False), "pred_stop": dict(pred_stop=True),
         "fused": dict(pred_stop=True, qp_fused=True)}


@pytest.fixture(scope="module")
def z():
    return _batch()


@pytest.fixture(scope="module")
def fits(z):
    """{case: (port fitter, (JAX result, JAX history), (port result, port
    history))}."""
    out = {}
    for name, kw in CASES.items():
        jf = JaxFitter(FREQ, dtype=jnp.float64, **KW, **kw)
        tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", **KW, **kw)
        out[name] = (tf, jf.fit(z, return_history=True), tf.fit(z, return_history=True))
    return out


def _assert_same(a, b):
    """Every field of two BatchFitResults bit for bit."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)


@pytest.mark.parametrize("case", CASES)
def test_history_matches_jax(fits, case):
    _, (r_j, h_j), (r_t, h_t) = fits[case]
    assert set(h_t) == set(h_j) == set(HISTORY_FIELDS)
    _assert_fit_match(r_t, r_j)
    for k in HISTORY_FIELDS:
        want = np.asarray(h_j[k])
        assert h_t[k].shape == want.shape, k
        if want.dtype.kind == "f":
            np.testing.assert_allclose(h_t[k], want, rtol=1e-6, atol=1e-10, err_msg=k)
        else:
            np.testing.assert_array_equal(h_t[k], want, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_history_structure(fits, z, case):
    """tests/test_parallel.py::test_batched_history_matches_serial_eager's
    structure on the port: (B, max_iter, ...) arrays, entries after a lane
    stops repeat its final state, and the last entry is the returned
    state."""
    tf, _, (res, hist) = fits[case]
    b, t_len = z.shape[0], tf.fcfg.max_iter
    n, m = tf.rzm.shape[1], tf.rzm.shape[0]
    shapes = {"x": (b, t_len, n), "s_vectors": (b, t_len, 3, n), "rho_vector": (b, t_len, 3),
              "dop_rho_vector": (b, t_len, 3), "weights": (b, t_len, m),
              "outlier_t": (b, t_len, m), "it": (b, t_len), "converged": (b, t_len)}
    assert {k: v.shape for k, v in hist.items()} == shapes
    assert res.n_iter.min() < t_len  # some lane stops early, so the repeat rule is exercised
    for lane in range(b):
        n_it = int(res.n_iter[lane])
        np.testing.assert_array_equal(hist["it"][lane], np.minimum(np.arange(1, t_len + 1), n_it))
        for k in HISTORY_FIELDS:
            tail = hist[k][lane, n_it - 1:]
            assert (tail == tail[:1]).all(), (k, lane)
        np.testing.assert_array_equal(hist["x"][lane, -1], res.x_raw[lane])
        np.testing.assert_array_equal(hist["weights"][lane, -1], res.weights[lane])
        assert hist["converged"][lane, -1] == res.converged[lane]


@pytest.mark.parametrize("case", ["plain", "pred_stop"])
def test_history_fit_is_the_plain_fit(fits, z, case):
    """Without qp_fused the history fit runs the loop of a plain fit, so its
    result is that fit's bit for bit."""
    tf, _, (res, _) = fits[case]
    _assert_same(res, tf.fit(z))


def test_fused_history_runs_unfused(fits, z, monkeypatch):
    """A qp_fused fitter's history fit runs no fused steps and peels no cold
    pass: it is the history of the plain fitter with the same warm cap, bit
    for bit, as the JAX package's scan calls its loop body with
    warm_mode="auto"."""
    from hybdrt_torch.ops import qp

    tf, _, (res, hist) = fits["fused"]
    plain_res, plain_hist = fits["pred_stop"][2]
    assert tf.fcfg.qp_fused and tf.fcfg.qp_max_iter_warm == KW["qp_max_iter_warm"]
    _assert_same(res, plain_res)
    for k in HISTORY_FIELDS:
        np.testing.assert_array_equal(hist[k], plain_hist[k], err_msg=k)

    def refuse(*args):
        raise AssertionError("the history fit ran the fused steps")

    monkeypatch.setattr(qp, "ip_steps_lane", refuse)
    again, _ = tf.fit(z, return_history=True)
    _assert_same(again, res)
    with pytest.raises(AssertionError, match="fused steps"):
        tf.fit(z)


def test_history_with_states(fits, z):
    """With return_states, fit returns (result, states, history)."""
    tf, _, (res, hist) = fits["pred_stop"]
    out = tf.fit(z, return_history=True, return_states=True)
    assert len(out) == 3
    r2, states, h2 = out
    _assert_same(r2, res)
    np.testing.assert_array_equal(states.x.numpy(), res.x_raw)
    for k in HISTORY_FIELDS:
        np.testing.assert_array_equal(h2[k], hist[k])


@pytest.mark.parametrize("kw,match", [
    ({"collect": "lazy"}, "collect='lazy'"), ({"adaptive": True}, "adaptive"),
    ({"adaptive": "staged"}, "adaptive"),
], ids=["lazy", "adaptive", "staged"])
def test_history_rejects(fits, z, kw, match):
    """collect="lazy" with return_history raises, as with return_states
    (ROADMAP Queue 3 item 3); adaptive scheduling with it raises, as in the
    JAX package."""
    tf = fits["plain"][0]
    with pytest.raises(ValueError, match=match):
        tf.fit(z[:2], return_history=True, **kw)
