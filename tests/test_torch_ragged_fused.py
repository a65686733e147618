"""Port parity: the ragged fitter's fused warm QPs
(``hybdrt_torch.BatchedRaggedFitter(qp_fused=True)``) against the JAX
``BatchedRaggedFitter(qp_fused=True)``, float64 on the CPU.

Observations: the het map's first EIS spectra on its three grids and its
first hybrid observations on its two protocols (``utils/probe.py``,
``make_het_eis`` and ``make_het_hybrid``, small counts), so the lanes have
basis windows and rows of several widths and the padded columns are pinned.
Held at the parity contract's tolerances: the same n_iter and converged
flags, coefficients within 1e-6 of each observation's max, the specials and
weights within rtol=1e-6, atol=1e-10, padded tails exactly zero. The fused
steps against the TPU kernel, #5's admission rule and the routing from
``DRTMD`` are in tests/test_torch_ragged_fused_route.py.
"""
import numpy as np
import pytest
import torch

from hybdrt_tpu.parallel.ragged import BatchedRaggedFitter as JaxRagged
from hybdrt_torch import BatchedRaggedFitter
from hybdrt_torch.ops import qp as qp_mod
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

FUSED = dict(qp_fused=True, qp_max_iter=20, qp_max_iter_warm=4)


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(1e-12, np.max(np.abs(b)))


def _hold(res, ref):
    np.testing.assert_array_equal(res.n_iter, ref.n_iter)
    np.testing.assert_array_equal(res.converged, ref.converged)
    for k in range(len(res.n_iter)):
        assert _rel(res.x[k], np.asarray(ref.x[k])) < 1e-6
    for key in ("r_inf", "inductance", "scale"):
        np.testing.assert_allclose(getattr(res, key), np.asarray(getattr(ref, key)),
                                   rtol=1e-6, atol=1e-10, err_msg=key)
    np.testing.assert_allclose(res.weights, np.asarray(ref.weights), rtol=1e-6, atol=1e-10)
    for k, (left, right) in enumerate(res.tau_indices):
        assert np.all(res.x[k][right - left:] == 0.0)


@pytest.fixture(scope="module")
def eis():
    obs, tau = probe.make_het_eis(24, 8)
    jax_res = JaxRagged(tau, batch_bucket=False, **FUSED).fit(obs)
    calls = []
    orig = qp_mod.ip_steps_lane

    def record(*args):
        calls.append([a.clone() for a in args[:3]])
        return orig(*args)

    qp_mod.ip_steps_lane = record
    try:
        fitter = BatchedRaggedFitter(tau, device="cpu", **FUSED)
        res = fitter.fit(obs)
    finally:
        qp_mod.ip_steps_lane = orig
    return obs, tau, fitter, res, jax_res, calls


@pytest.fixture(scope="module")
def hybrid():
    obs, tau = probe.make_het_hybrid(24, 8)
    return (BatchedRaggedFitter(tau, device="cpu", **FUSED).fit(obs),
            JaxRagged(tau, batch_bucket=False, **FUSED).fit(obs))


def test_fused_eis_rows_match_jax(eis):
    _, _, fitter, res, jax_res, calls = eis
    assert len({r - l for l, r in res.tau_indices}) > 1
    assert fitter.fcfg.qp_fused and calls, "the fused steps did not run"
    _hold(res, jax_res)


def test_fused_hybrid_rows_match_jax(hybrid):
    res, jax_res = hybrid
    _hold(res, jax_res)


def test_fused_pred_stop_matches_jax():
    obs, tau = probe.make_het_eis(6, 2)
    kw = dict(FUSED, pred_stop=True)
    _hold(BatchedRaggedFitter(tau, device="cpu", **kw).fit(obs),
          JaxRagged(tau, batch_bucket=False, **kw).fit(obs))


def test_warm_steps_default_to_eight():
    tau = probe.TAU_SUPER
    assert BatchedRaggedFitter(tau, device="cpu", qp_fused=True).qp_max_iter_warm == 8
    assert JaxRagged(tau, qp_fused=True).qp_max_iter_warm == 8
    assert BatchedRaggedFitter(tau, device="cpu", qp_fused=True,
                               qp_max_iter_warm=3).qp_max_iter_warm == 3
    assert BatchedRaggedFitter(tau, device="cpu").qp_max_iter_warm is None


def test_warm_qps_run_fused_on_per_lane_systems(eis):
    """Every pass after the cold one hands the live lanes' own (P, q, lb)
    to the fused steps: (B_live, n, n) with each lane's padded columns
    decoupled (a unit row of the equilibrated P) and held at lb = 0."""
    _, _, fitter, res, _, calls = eis
    n = fitter._uniq["rzm"].shape[2]
    col_mask = fitter.full("col_mask")
    assert all(c[0].shape[1:] == (n, n) for c in calls)
    assert calls[0][0].shape[0] == len(res.n_iter)
    P, _, lb = (c.numpy() for c in calls[0][:3])
    for k in range(P.shape[0]):
        pad = col_mask[k] == 0
        if pad.any():
            np.testing.assert_array_equal(P[k][np.ix_(pad, pad)], np.eye(pad.sum()))
            assert np.all(P[k][np.ix_(pad, ~pad)] == 0)
            assert np.all(lb[k][pad] == 0)
    assert any((col_mask[k] == 0).any() for k in range(P.shape[0]))
