"""Port parity: hybdrt_torch.BatchedHybridFitter, hybrid (chrono + EIS)
observations on one measurement protocol, against the JAX
BatchedHybridFitter on the same seeded observations (tests/test_parallel.py's
hybrid generators), float64 on the CPU (``device="cpu"``; the default is the
card).

Held: each lane at rel < 1e-6 of the JAX fit's x (tests/test_ragged.py:108's
tolerance) with equal n_iter and converged flags, plain, with pred_stop,
fused and warm from either package's seed; the scaled data to 1e-12; the
adaptive modes bitwise the plain fit; and the float32 spread against
float64 no wider than the JAX package's own. The JAX fitters run with
``batch_bucket=False`` where its padding lanes would only cost time."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybdrt_torch
from hybdrt_tpu.parallel.batch import BatchedHybridFitter as JaxHybrid
from hybdrt_torch import BatchedHybridFitter
from hybdrt_torch.utils.probe import make_hybrid_batch

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(1e-12, np.max(np.abs(b)))


# The mirrors of tests/test_parallel.py:87-126, :400, :515 and :551
TIMES = np.concatenate([np.linspace(-0.005, -0.0005, 8), np.logspace(-5, 0, 60)])
I_SIG = np.where(TIMES >= 0, 0.1, 0.0)
FREQ = np.logspace(5, -1, 25)


def _sim(seed, drift=None):
    """tests/test_parallel.py's hybrid observations: an RC element of
    random (or, with drift, drifting) tau and R behind R_inf = 0.3."""
    r = np.random.default_rng(seed)
    if drift is None:
        tau0, r0 = 10 ** r.uniform(-3, -2), r.uniform(1.0, 2.0)
    else:
        tau0, r0 = 10 ** (-2.5 + drift), 1.5 + drift
    v = 0.3 * I_SIG + 0.1 * r0 * (1 - np.exp(-np.maximum(TIMES, 0) / tau0)) * (TIMES >= 0) \
        + r.normal(0, 2e-4, len(TIMES))
    w = 2j * np.pi * FREQ
    z = 0.3 + r0 / (1 + w * tau0) + r.normal(0, 1e-3, 25) + 1j * r.normal(0, 1e-3, 25)
    return v, z


def _batch(seeds, drift=None):
    return map(np.stack, zip(*[_sim(s, drift) for s in seeds]))


def _same(a, b):
    for k in range(len(b.n_iter)):
        assert _rel(a.x_raw[k], b.x_raw[k]) < 1e-6, k
    np.testing.assert_array_equal(a.n_iter, b.n_iter)
    np.testing.assert_array_equal(a.converged, b.converged)


@pytest.fixture(scope="module")
def batch():
    """Six observations, fitted by both packages with pred_stop off and on."""
    v, z = _batch(range(100, 106))
    out = {"v": v, "z": z}
    for ps in (False, True):
        kw = dict(pred_stop=ps, pred_rtol=3e-2)
        jf = JaxHybrid(TIMES, I_SIG, FREQ, batch_bucket=False, **kw)
        tf = BatchedHybridFitter(TIMES, I_SIG, FREQ, device="cpu", **kw)
        out[ps] = (jf, tf, jf.fit(v, z), tf.fit(v, z))
    return out


def jax_hybrid_problem(jf):
    """The JAX hybrid fitter's arrays and its template's metadata as the
    dict BatchedHybridFitter.from_arrays takes."""
    t = jf.template
    cfg = {k: v for k, v in jf.cfg._asdict().items() if k not in ("nonlin", "half_size")}
    return {
        "times": jf.times, "i_signal": jf.i_signal, "frequencies": jf.frequencies,
        "step_times": jf.step_times, "step_sizes": jf.step_sizes,
        "rzm": np.asarray(jf.rzm), "rzm_vz": np.asarray(jf.rzm_vz),
        "vz_strength_vec": np.asarray(jf.vz_strength_vec), "vmm": np.asarray(jf.vmm),
        "m_stack": np.asarray(jf.m_stack), "l1v": np.asarray(jf.l1v), "lb": np.asarray(jf.lb),
        "hypers": dict(jf.hypers),
        "iw_hypers": {k: v if v is None or np.isscalar(v) else np.asarray(v)
                      for k, v in jf.iw_hyp.items()},
        "cfg": cfg, "num_chrono": jf.num_chrono, "vz_index": jf.vz_index,
        "special_qp_params": dict(t.special_qp_params), "basis_tau": np.asarray(jf.basis_tau),
        "tau_epsilon": float(t.tau_epsilon), "inductance_scale": t.inductance_scale,
        "input_signal_scale": jf.input_signal_scale, "rp_scale": jf.rp_scale,
    }


@pytest.mark.parametrize("pred_stop", [False, True])
def test_batched_hybrid_matches_jax(batch, pred_stop):
    jf, tf, r_jax, res = batch[pred_stop]
    _same(res, r_jax)
    for key in ("r_inf", "inductance", "scale"):
        np.testing.assert_allclose(getattr(res, key), getattr(r_jax, key), rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    np.testing.assert_allclose(res.weights, np.asarray(r_jax.weights), rtol=1e-6, atol=1e-10)
    rzv_t, sc_t = tf.scale_batch(batch["v"], batch["z"])
    rzv_j, sc_j = jf.scale_batch(batch["v"], batch["z"])
    np.testing.assert_allclose(rzv_t, rzv_j, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-12)
    # test_parallel.py:87: each lane agrees with its single fit
    rp = tf.predict_r_p(res)
    drt = hybdrt_torch.DRT(warn=False, device="cpu")
    drt.fit_hybrid(TIMES, I_SIG, batch["v"][2], FREQ, batch["z"][2])
    assert abs(drt.predict_r_p() - rp[2]) < 0.01
    assert np.max(np.abs(res.r_inf - 0.3)) < 0.02


def test_from_arrays_runs_the_jax_problem(batch):
    """from_arrays on the JAX fitter's own arrays: its fit, independent of
    the port's assembly."""
    jf, _, r_jax, _ = batch[False]
    tf = BatchedHybridFitter.from_arrays(jax_hybrid_problem(jf), device="cpu")
    _same(tf.fit(batch["v"], batch["z"]), r_jax)


@pytest.mark.parametrize("pred_stop", [False, True])
def test_adaptive_modes_bitwise_plain(batch, pred_stop):
    """adaptive "staged" and True run the same live-lane loop as False:
    bitwise the plain fit (tests/test_parallel.py:400)."""
    _, tf, _, res = batch[pred_stop]
    for mode in ("staged", True):
        r = tf.fit(batch["v"], batch["z"], adaptive=mode)
        np.testing.assert_array_equal(r.x_raw, res.x_raw)
        np.testing.assert_array_equal(r.n_iter, res.n_iter)
    lazy = tf.fit(batch["v"], batch["z"], adaptive="staged", collect="lazy")
    assert isinstance(lazy.weights, torch.Tensor)
    np.testing.assert_array_equal(lazy.weights.numpy(), res.weights)


def test_fused_matches_jax_fused(batch):
    """qp_fused: the fused warm QPs against the JAX package's fused fit,
    equal n_iter."""
    kw = dict(qp_max_iter=20, qp_max_iter_warm=8, pred_stop=True, pred_rtol=3e-2,
              qp_fused=True)
    r_jax = JaxHybrid(TIMES, I_SIG, FREQ, batch_bucket=False, **kw).fit(batch["v"], batch["z"])
    res = BatchedHybridFitter(TIMES, I_SIG, FREQ, device="cpu", **kw).fit(batch["v"], batch["z"])
    _same(res, r_jax)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_warm_frames_match_jax(fused):
    """A frame warm from the previous one (tests/test_parallel.py:515): the
    vz-offset column is rebuilt from the seed iterate; against the JAX warm
    fit from either package's seed, and close to a cold fit."""
    kw = dict(max_iter=40, pred_stop=True, pred_rtol=1e-2)
    if fused:
        kw.update(qp_fused=True, qp_max_iter=20, qp_max_iter_warm=8)
    v0, z0 = _batch(range(100, 104), drift=0.0)
    v1, z1 = _batch(range(200, 204), drift=0.02)
    jf = JaxHybrid(TIMES, I_SIG, FREQ, batch_bucket=False, **kw)
    tf = BatchedHybridFitter(TIMES, I_SIG, FREQ, device="cpu", **kw)
    j0, t0 = jf.fit(v0, z0), tf.fit(v0, z0)
    want = jf.fit(v1, z1, warm_from=j0)
    for seed in (t0, j0, tf.fit(v0, z0, collect="lazy")):
        _same(tf.fit(v1, z1, warm_from=seed), want)
    warm, cold = tf.fit(v1, z1, warm_from=t0), tf.fit(v1, z1)
    assert warm.converged.all()
    rp_c, rp_w = tf.predict_r_p(cold), tf.predict_r_p(warm)
    assert np.max(np.abs(rp_w - rp_c) / rp_c) < 0.02
    assert np.max(np.abs(warm.r_inf - cold.r_inf)) < 5e-3


def test_final_design_matrices(batch):
    """The designs as the loop left them: the vz-offset column rewritten
    from each lane's final iterate; their predictions fit the data."""
    _, tf, _, res = batch[False]
    rzm = tf.final_design_matrices(res)
    rzv, _ = tf.scale_batch(batch["v"], batch["z"])
    y = np.einsum("bmn,bn->bm", rzm, res.x_raw)
    nc = tf.num_chrono
    assert np.median(np.abs(y[:, nc:] - rzv[:, nc:]) / np.abs(rzv[:, nc:]).max(1)[:, None]) < 0.01
    sign = np.where(np.arange(rzm.shape[1]) < nc, 1.0, -1.0)
    col = (res.x_raw @ np.asarray(tf.hybrid["rzm_vz"]).T) * sign \
        * np.asarray(tf.hybrid["vz_strength"])
    np.testing.assert_array_equal(rzm[:, :, tf.vz_index], col)


@pytest.mark.parametrize("kw,exc,match", [
    ({"adaptive": "stagedd"}, ValueError, "adaptive="),
    ({"phase_budgets": (12, 6), "adaptive": "staged"}, ValueError, "phase_budgets"),
    ({"staged_capacities": (2,)}, ValueError, "staged_capacities"),
    ({"collect": "eager"}, ValueError, "collect="),
    ({"return_history": True}, NotImplementedError, "item 7"),
    ({"warm_from": "seed", "adaptive": True}, ValueError, "warm_from"),
    ({"return_states": True, "collect": "lazy"}, ValueError, "lazy"),
], ids=["adaptive", "budgets", "capacities", "collect", "history", "warm_adaptive", "lazy_states"])
def test_option_checks(kw, exc, match):
    """The fitter fails fast on a bad option (tests/test_parallel.py:551)."""
    times = np.concatenate([np.linspace(-0.005, -0.0005, 4), np.logspace(-5, 0, 20)])
    i_sig = np.where(times >= 0, 0.1, 0.0)
    fitter = BatchedHybridFitter(times, i_sig, np.logspace(4, 0, 11), max_iter=10,
                                 device="cpu")
    bad = np.zeros((2, len(times)))
    with pytest.raises(exc, match=match):
        fitter.fit(bad, np.zeros((2, 11), dtype=complex), **kw)


def test_constructor_checks():
    with pytest.raises(NotImplementedError, match="item 10"):
        BatchedHybridFitter(TIMES, I_SIG, FREQ, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="batch_bucket"):
        BatchedHybridFitter(TIMES, I_SIG, FREQ, device="cpu", batch_bucket=True)
    with pytest.raises(ValueError, match="Invalid keyword"):
        BatchedHybridFitter(TIMES, I_SIG, FREQ, device="cpu", l2_lambda=1.0)
    fitter = BatchedHybridFitter(TIMES, I_SIG, FREQ, device="cpu")
    with pytest.raises(ValueError, match="v_batch shape"):
        fitter.fit(np.zeros((2, 3)), np.zeros((2, 25), dtype=complex))
    with pytest.raises(ValueError, match="z_batch shape"):
        fitter.fit(np.zeros((2, len(TIMES))), np.zeros((3, 25), dtype=complex))


def test_float32_spread_is_the_references():
    """The float32 fit of make_hybrid_batch's last 16 lanes (where lanes run
    to max_iter on a limit cycle) against float64: the port's Rp spread is
    the JAX package's own, within 2x + 1e-3, on every lane; on the lanes
    converged in both precisions it is within phase 5's bounds. Prints both
    packages' spreads."""
    t, i, f, v, z = make_hybrid_batch(64, proto=0)
    v, z = v[48:], z[48:]
    kw = dict(qp_max_iter=20, qp_max_iter_warm=4)
    spread = {}
    for name, make in (("port", lambda dt: BatchedHybridFitter(t, i, f, dtype=dt, device="cpu",
                                                               **kw)),
                       ("jax", lambda dt: JaxHybrid(t, i, f, batch_bucket=False,
                                                    dtype={torch.float32: jnp.float32,
                                                           torch.float64: jnp.float64}[dt],
                                                    **kw))):
        fit32, fit64 = make(torch.float32), make(torch.float64)
        r32, r64 = fit32.fit(v, z), fit64.fit(v, z)
        rp32, rp64 = fit32.predict_r_p(r32), fit64.predict_r_p(r64)
        rel = np.abs(rp32 - rp64) / rp64
        both = np.asarray(r32.converged) & np.asarray(r64.converged)
        spread[name] = (np.percentile(rel, 95), np.max(rel), rel[both], both)
        print(f"{name}: f32 vs f64 Rp rel err p95 {spread[name][0]:.3g} max {spread[name][1]:.3g}"
              f" over 16 lanes; {int(both.sum())} converged in both")
    p95, mx, rel_both, both = spread["port"]
    assert p95 <= 2 * spread["jax"][0] + 1e-3 and mx <= 2 * spread["jax"][1] + 1e-3
    assert both.sum() >= 4
    assert np.median(rel_both) < 1e-3 and np.percentile(rel_both, 95) < 3e-3
