"""Port parity: frame-to-frame warm starts, ``BatchedEISFitter.fit(z,
warm_from=prev)``, against the JAX package's on the CPU in float64
(``device="cpu"``).

Two frames of 12 spectra on 31 frequencies drifting by 0.02, built as
tests/test_parallel.py::test_warm_from_previous_frame builds its frames.
Both packages are seeded from one JAX frame-0 result, and their warm fits of
frame 1 must stop every lane at the same iteration with the same convergence
flag, coefficients within rtol=1e-6, atol=1e-10 (the tolerance of
tests/test_torch_batch.py), plain and fused, with and without pred_stop.

The JAX fitter runs with ``batch_bucket=False``: the port pads no batch, and
the JAX package's own warm fit moves by up to 1.2e-6 of a coefficient between
its padded (16-lane) and unpadded batch on these frames, on a lane that
reaches max_iter without converging, more than the tolerance allows.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter
from hybdrt_tpu.parallel.batch import _loop_inputs as jax_loop_inputs
from hybdrt_tpu.solver import fitcore as jax_fitcore
from hybdrt_tpu.solver.qphb import QPHBState as JaxState
from hybdrt_torch import BatchedEISFitter
from hybdrt_torch.solver import fitcore
from hybdrt_torch.solver.qphb import state_from_numpy
from hybdrt_torch.utils.probe import make_batch, make_frames

from test_torch_batch import KW, _assert_fit_match

B, NOISE = 12, 0.003
FREQ = np.logspace(5, -1, 31)


def _frames(freq, b, drifts, seed=0):
    """tests/test_parallel.py::test_warm_from_previous_frame's frames: b
    spectra of two ZARCs, the first drifting in R and tau, noise 0.003."""
    rng = np.random.default_rng(seed)
    out = []
    for drift in drifts:
        z = np.zeros((b, len(freq)), dtype=complex)
        for i in range(b):
            r1 = 1.0 + 0.03 * i + drift
            t1 = 10 ** (-3 + 0.05 * i + drift)
            z[i] = (0.5 + 0.1 * drift + r1 / (1 + (2j * np.pi * freq * t1) ** 0.9)
                    + 0.8 / (1 + (2j * np.pi * freq * 1e-1) ** 0.85))
        out.append(z + NOISE * (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)))
    return out


@pytest.fixture(scope="module")
def frames():
    return _frames(FREQ, B, (0.0, 0.02))


@pytest.fixture(scope="module")
def seed(frames):
    """The JAX frame-0 result both packages are seeded from."""
    jf = JaxFitter(FREQ, dtype=jnp.float64, pred_stop=True, **KW)
    return jf.fit(frames[0])


@pytest.fixture(scope="module")
def warm(frames, seed):
    """{(qp_fused, pred_stop): (port fitter, JAX warm result, port warm
    result)} for frame 1 seeded from ``seed``."""
    out = {}
    for fused in (False, True):
        for ps in (False, True):
            kw = dict(KW, pred_stop=ps, qp_fused=fused)
            jf = JaxFitter(FREQ, dtype=jnp.float64, batch_bucket=False, **kw)
            tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", **kw)
            out[fused, ps] = (tf, jf.fit(frames[1], warm_from=seed),
                              tf.fit(frames[1], warm_from=seed))
    return out


@pytest.mark.parametrize("pred_stop", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_warm_fit_matches_jax(warm, fused, pred_stop):
    tf, r_j, r_t = warm[fused, pred_stop]
    assert tf.fcfg.qp_fused == fused and not tf.fcfg.continue_mode
    _assert_fit_match(r_t, r_j)
    np.testing.assert_array_equal(r_t.xmx_norms, r_j.xmx_norms)


@pytest.mark.parametrize("fused", [False, True])
def test_lazy_seed_matches_full_seed(frames, warm, fused):
    """A lazy seed (s_vectors a tensor) and a full one (numpy) give the same
    warm fit bit for bit."""
    tf = warm[fused, True][0]
    full, lazy = tf.fit(frames[0]), tf.fit(frames[0], collect="lazy")
    assert isinstance(lazy.s_vectors, torch.Tensor)
    _assert_fit_match(tf.fit(frames[1], warm_from=lazy), tf.fit(frames[1], warm_from=full),
                      rtol=0, atol=0)


def _continuation(frame, seed, min_iter, max_iter=None, x_rtol=None):
    """One JAX state (the weights of ``frame``, the seed's x, s, rho and
    norms, zero duals) run by the JAX package's qphb_fit_loop_from_state and
    by the port's, in continuation mode with a seeded prediction history and
    the history returned: ((state, y_prev, y_prev2) of JAX as numpy, the same
    of the port)."""
    jf = JaxFitter(FREQ, dtype=jnp.float64, batch_bucket=False, pred_stop=True, **KW)
    tf = BatchedEISFitter(FREQ, dtype=torch.float64, device="cpu", pred_stop=True, **KW)
    rzv, scale = jf.scale_batch(frame)
    rzv = jnp.asarray(rzv)
    init_w, est, out_t = jax.vmap(lambda rv: jax_loop_inputs(jf, rv)[0][12:15])(rzv)
    x0 = np.asarray(seed.x_raw) * (np.asarray(seed.scale) / scale)[:, None]
    state0 = JaxState(x=jnp.asarray(x0), s_vectors=jnp.asarray(seed.s_vectors),
                      rho_vector=jnp.asarray(seed.rho), dop_rho_vector=jnp.asarray(seed.dop_rho),
                      weights=init_w, outlier_t=out_t, xmx_norms=jnp.asarray(seed.xmx_norms),
                      dop_xmx_norms=jnp.asarray(seed.dop_xmx_norms),
                      it=jnp.zeros(B, dtype=jnp.int32), converged=jnp.zeros(B, dtype=bool),
                      qp_dual=jnp.zeros_like(x0))
    loop = dict(continue_mode=True, min_iter=min_iter,
                max_iter=jf.fcfg.max_iter if max_iter is None else max_iter,
                x_rtol=jf.fcfg.x_rtol if x_rtol is None else x_rtol)
    one, m = jnp.asarray(1.0), jf.rzm.shape[0]

    def run(st, rv, e):
        st, _, y1, y2 = jax_fitcore.qphb_fit_loop_from_state(
            st, jf.rzm, rv, jf.vmm, jf.m_stack, None, jf.l1v, jf.lb, jf.hyp, e,
            jnp.zeros_like(jf.rzm), jnp.ones(m), one, one, one, jf.fcfg._replace(**loop),
            seed_pred_history=True, return_pred_history=True)
        return st, y1, y2

    out_j = jax.tree.map(np.asarray, jax.vmap(run)(state0, rzv, est))
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    out_t = fitcore.qphb_fit_loop_from_state(
        state_from_numpy(jax.tree.map(np.array, state0)), tf.rzm, t(rzv), tf.vmm, tf.m_stack,
        tf.l1v, tf.lb, tf.hyp, t(est), replace(tf.fcfg, **loop), seed_pred_history=True,
        return_pred_history=True)
    return out_j, out_t


@pytest.mark.parametrize("frame,min_iter,x_rtol", [(1, 2, None), (1, 6, None), (0, 4, 0.2)],
                         ids=["drift-min2", "drift-min6", "reseed-min4-loose-x"])
def test_continuation_loop_matches_jax(frames, seed, frame, min_iter, x_rtol):
    """fitcore's continuation mode against the JAX package's
    qphb_fit_loop_from_state: the same iteration and flag per lane, the
    seed's norms held, no lane stopped before min_iter. Frame 0 seeded from
    its own fit with x_rtol = 0.2 passes the x test at iteration 3 on some
    lanes, so there min_iter = 4 holds lanes that the x test would stop."""
    (st_j, _, _), (st_t, _, _) = _continuation(frames[frame], seed, min_iter, x_rtol=x_rtol)
    np.testing.assert_array_equal(st_t.it.numpy(), st_j.it)
    np.testing.assert_array_equal(st_t.converged.numpy(), st_j.converged)
    np.testing.assert_allclose(st_t.x.numpy(), st_j.x, rtol=1e-6, atol=1e-10)
    np.testing.assert_array_equal(st_t.xmx_norms.numpy(), seed.xmx_norms)
    assert st_t.converged.all() and int(st_t.it.min()) >= min_iter


def test_continuation_seeds_the_prediction_history(frames, seed):
    """After one iteration the older history slot still holds the seed: the
    prediction of the seed iterate, as the JAX package seeds it."""
    (_, y1_j, y2_j), (_, y1_t, y2_t) = _continuation(frames[1], seed, 2, max_iter=1)
    np.testing.assert_allclose(y2_t.numpy(), y2_j, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(y1_t.numpy(), y1_j, rtol=1e-6, atol=1e-10)
    assert np.max(np.abs(y2_j)) > 1


@pytest.mark.parametrize("fused", [False, True])
def test_warm_from_previous_frame(fused):
    """tests/test_parallel.py::test_warm_from_previous_frame on the port: a
    warm fit converges every lane in fewer iterations than a cold one and
    lands on the same physics; a same-data reseed re-converges at once."""
    freq = np.logspace(5, -1, 61)
    f0, f1 = _frames(freq, 10, (0.0, 0.02))
    fitter = BatchedEISFitter(freq, dtype=torch.float64, device="cpu", max_iter=50,
                              pred_stop=True, pred_rtol=1e-2, qp_fused=fused)
    r0 = fitter.fit(f0)
    cold = fitter.fit(f1)
    warm = fitter.fit(f1, warm_from=r0)

    assert warm.converged.all()
    assert warm.n_iter.mean() < cold.n_iter.mean()
    z_c, z_w = fitter.predict_z(cold), fitter.predict_z(warm)
    assert np.median(np.abs(z_w - f1)) < 1.5 * np.median(np.abs(z_c - f1))
    assert np.max(np.abs(z_w - z_c)) < 3 * NOISE
    rp_c, rp_w = fitter.predict_r_p(cold), fitter.predict_r_p(warm)
    assert np.max(np.abs(rp_w - rp_c) / rp_c) < 0.02

    again = fitter.fit(f0, warm_from=r0)
    assert again.converged.all()
    assert np.median(again.n_iter) <= 8
    assert np.max(np.abs(fitter.predict_z(again) - fitter.predict_z(r0))) < NOISE


@pytest.mark.parametrize("kw,match", [
    ({"lanes": B - 1}, "lanes"), ({"adaptive": True}, "warm_from"),
    ({"adaptive": "staged"}, "warm_from"), ({"return_history": True}, "warm_from"),
], ids=["lanes", "adaptive", "staged", "return_history"])
def test_warm_from_rejects(frames, warm, seed, kw, match):
    """As the JAX package: a seed of another lane count, and warm_from with
    adaptive scheduling or return_history, raise ValueError."""
    tf = warm[False, True][0]
    kw = dict(kw)
    z = frames[1][:kw.pop("lanes", B)]
    with pytest.raises(ValueError, match=match):
        tf.fit(z, warm_from=seed, **kw)


def test_make_frames():
    """make_frames: (n_frames, batch, n_freq) on make_batch's grid, seeded and
    not make_batch's draws; R_inf stays at 0.5 while R1 grows and tau2 falls,
    so the lanes' mean real part at the lowest frequency rises every frame."""
    freq, z = make_frames(512, 41, 3, 0.02)
    assert z.shape == (3, 512, 41) and np.array_equal(freq, make_batch(1, 41)[0])
    np.testing.assert_array_equal(make_frames(512, 41, 3, 0.02)[1], z)
    assert not np.allclose(z[0], make_batch(512, 41)[1])
    np.testing.assert_allclose(np.mean(z[:, :, 0].real, axis=1), 0.5, atol=1e-3)
    assert np.all(np.diff(np.mean(z[:, :, -1].real, axis=1)) > 0.01)
