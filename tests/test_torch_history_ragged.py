"""Port parity: ``return_history=True`` on the ragged fitter
(``BatchedRaggedFitter.fit``, EIS and hybrid rows) and on
``BatchedHybridFitter.fit`` against the JAX package's, float64 on the CPU.

Observations: three EIS spectra on three grids and basis windows
(tests/test_ragged.py::test_ragged_eis_matches_serial's), the het map's
first four hybrid observations on its two protocols (``probe.make_het_hybrid``)
and, for the shared-protocol fitter, ``probe.make_hybrid_batch(4)``. Held as
tests/test_torch_history.py holds the EIS fitter's history: every key at
every iteration within rtol=1e-6, atol=1e-10 of JAX's, ``it`` and
``converged`` identical; the history fit's result bit for bit the plain
fit's, and each lane's last entry its final state.
"""
import numpy as np
import pytest
import torch

from hybdrt_tpu.parallel.batch import BatchedHybridFitter as JaxHybrid
from hybdrt_tpu.parallel.ragged import BatchedRaggedFitter as JaxRagged
from hybdrt_torch import BatchedHybridFitter, BatchedRaggedFitter
from hybdrt_torch.solver.fitcore import HISTORY_FIELDS
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

TAU_SG = np.logspace(-8, 3, 111)


def _eis_obs():
    rng = np.random.default_rng(0)
    grids = [np.logspace(5, -1, 57), np.logspace(3, 0, 31), np.logspace(6, -2, 81)]
    out = []
    for f in grids:
        z = 0.4 + 1.0 / (1 + (2j * np.pi * f * 1e-2) ** 0.85) \
            + 1.5 / (1 + (2j * np.pi * f * 1e-1) ** 0.9)
        out.append((None, (f, z + 0.004 * rng.normal(size=len(f))
                           + 4e-3j * rng.normal(size=len(f)))))
    return out


@pytest.fixture(scope="module")
def fits():
    """{case: (port fitter factory, port inputs, (JAX result, JAX history),
    (port result, port history))}. Each history fit is its fitter's first,
    as the plain fits it is compared with: a ragged fitter's later calls
    rescale every observation from its protocol cache, which moves x by
    ulps."""
    out = {}
    hyb, tau = probe.make_het_hybrid(12, 4)
    for name, obs, tau_ in (("ragged_eis", _eis_obs(), TAU_SG), ("ragged_hybrid", hyb, tau)):
        make = lambda tau_=tau_: BatchedRaggedFitter(tau_, device="cpu")
        out[name] = (make, (obs,),
                     JaxRagged(tau_, batch_bucket=False).fit(obs, return_history=True),
                     make().fit(obs, return_history=True))
    times, i_sig, freq, v, z = probe.make_hybrid_batch(4)
    make = lambda: BatchedHybridFitter(times, i_sig, freq, tau_supergrid=TAU_SG, device="cpu")
    jf = JaxHybrid(times, i_sig, freq, tau_supergrid=TAU_SG, batch_bucket=False)
    out["hybrid_fitter"] = (make, (v, z), jf.fit(v, z, return_history=True),
                            make().fit(v, z, return_history=True))
    return out


CASES = ("ragged_eis", "ragged_hybrid", "hybrid_fitter")


@pytest.mark.parametrize("case", CASES)
def test_history_matches_jax(fits, case):
    _, _, (r_j, h_j), (r_t, h_t) = fits[case]
    assert set(h_t) == set(h_j) == set(HISTORY_FIELDS)
    np.testing.assert_array_equal(r_t.n_iter, np.asarray(r_j.n_iter))
    np.testing.assert_array_equal(r_t.converged, np.asarray(r_j.converged))
    for k in HISTORY_FIELDS:
        want = np.asarray(h_j[k])
        assert h_t[k].shape == want.shape, k
        if want.dtype.kind == "f":
            np.testing.assert_allclose(h_t[k], want, rtol=1e-6, atol=1e-10, err_msg=k)
        else:
            np.testing.assert_array_equal(h_t[k], want, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_history_fit_is_the_plain_fit(fits, case):
    """The history fit's result is the plain fit's bit for bit, and each
    lane's last history entry is its final state."""
    make, args, _, (res, hist) = fits[case]
    plain = make().fit(*args)
    for f in res._fields:
        a, b = getattr(res, f), getattr(plain, f)
        if f == "tau_indices":
            assert a == b
        elif a is None:
            assert b is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    for lane in range(len(res.n_iter)):
        np.testing.assert_array_equal(hist["x"][lane, -1], res.x_raw[lane])
        assert hist["it"][lane, -1] == res.n_iter[lane]
        assert hist["converged"][lane, -1] == res.converged[lane]


@pytest.mark.parametrize("case", CASES)
def test_history_with_states(fits, case):
    make, args, _, (res, hist) = fits[case]
    r2, states, h2 = make().fit(*args, return_history=True, return_states=True)
    np.testing.assert_array_equal(states.x.numpy(), res.x_raw)
    for k in HISTORY_FIELDS:
        np.testing.assert_array_equal(h2[k], hist[k])


@pytest.mark.parametrize("case", CASES)
def test_history_with_adaptive_raises(fits, case):
    """A history is a whole-batch scan: with adaptive scheduling it raises
    ValueError, as in the JAX package."""
    make, args, _, _ = fits[case]
    with pytest.raises(ValueError, match="return_history"):
        make().fit(*args, return_history=True, adaptive="staged")


def test_fused_ragged_history_runs_unfused(fits, monkeypatch):
    """A qp_fused ragged fitter's history runs no fused steps, as the JAX
    scan calls its loop body with warm_mode="auto": it is the history of
    the plain fitter with the same warm cap."""
    from hybdrt_torch.ops import qp

    _, (obs,), _, _ = fits["ragged_eis"]
    plain = BatchedRaggedFitter(TAU_SG, device="cpu", qp_max_iter_warm=8)
    _, want = plain.fit(obs, return_history=True)

    def refuse(*args):
        raise AssertionError("the history fit ran the fused steps")

    monkeypatch.setattr(qp, "ip_steps_lane", refuse)
    fused = BatchedRaggedFitter(TAU_SG, device="cpu", qp_fused=True)
    _, got = fused.fit(obs, return_history=True)
    for k in HISTORY_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
