"""Port parity: ``BatchedEISFitter(fit_dop=True)`` and ``fit_capacitance``
(hybdrt_torch/parallel/batch.py) against the JAX package's batched fitter
and the port's own serial fit, float64 on the CPU.

Spectra: tests/test_parallel.py:292's ZARC with a constant-phase term, and
``probe.make_dop_batch``'s (the main leg's spectra with a constant-phase
term each, on the leg's grid of 71 frequencies: n = 143), with the bench's
knobs where a case says so. Held: the batched fit against the serial one
and against the JAX batched fit at tests/test_parallel.py:292's atol 1e-8
(x and x_dop), the same iteration counts; the JAX fitter's
arrays through ``from_arrays`` (the DOP's smoothing matrices and scales
carried over) and a JAX result as ``warm_from`` (its dop_rho and
dop_xmx_norms carried over, plain and fused), each against the port's own;
the fused fit (``qp_fused=True``) against the JAX package's fused fit at the
same atol (it is held card against CPU by tests/test_torch_cuda.py);
``param_cov``
within ``probe.cov_bound`` of the JAX package's; the capacitance against the
serial fit; the hybrid fitter's refusal of both.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import hybdrt_torch
from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter
from hybdrt_torch import BatchedEISFitter, BatchedHybridFitter
from hybdrt_torch.models.drt import build_hybrid_problem
from hybdrt_torch.utils import probe

torch.set_num_threads(1)

ATOL = 1e-8
# the bench's knobs (chip_smoke.FIT_KW)
BENCH_KW = dict(max_iter=50, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True,
                pred_rtol=3e-2)


def _parallel_batch():
    """tests/test_parallel.py:296-300's spectrum and a scaled, re-noised
    copy of it."""
    rng = np.random.default_rng(0)
    f = np.logspace(5, -2, 51)
    w = 2j * np.pi * f
    z = 0.4 + 1.0 / (1 + (w * 1e-2) ** 0.9) + 0.05 * (w ** -0.5)
    z = z + rng.normal(0, 1e-3, 51) + 1j * rng.normal(0, 1e-3, 51)
    z2 = 1.3 * z + 2e-3 * (rng.normal(size=51) + 1j * rng.normal(size=51))
    return f, np.stack([z, z2])


def jax_problem(jf):
    """The JAX fitter's problem as the dict from_arrays takes, its DOP's
    smoothing matrices and its template's scales and nu basis included."""
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
        "inductance_scale": t.inductance_scale, "capacitance_scale": t.capacitance_scale,
        "dop_gmat": None if jf.dop_gmat is None else np.asarray(jf.dop_gmat),
        "dop_scale_vector": t.dop_scale_vector, "basis_nu": t.basis_nu,
        "nu_basis_type": t.nu_basis_type, "nu_epsilon": t.nu_epsilon,
    }


@pytest.fixture(scope="module")
def fitted():
    f, z = _parallel_batch()
    out = {"f": f, "z": z}
    jf = JaxFitter(f, fit_dop=True, dtype=jnp.float64, batch_bucket=False)
    tf = BatchedEISFitter(f, fit_dop=True, dtype=torch.float64, device="cpu")
    out[False] = (jf, tf, jf.fit(z), tf.fit(z))
    jf_fused = JaxFitter(f, fit_dop=True, dtype=jnp.float64, batch_bucket=False, qp_fused=True)
    tf_fused = BatchedEISFitter(f, fit_dop=True, dtype=torch.float64, device="cpu",
                                qp_fused=True)
    out[True] = (jf_fused, tf_fused, jf_fused.fit(z), tf_fused.fit(z))
    return out


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def test_batched_dop_matches_jax(fitted):
    jf, tf, rj, rt = fitted[False]
    np.testing.assert_array_equal(rt.n_iter, np.asarray(rj.n_iter))
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    for key in ("x", "x_dop", "r_inf", "inductance", "c_inv", "scale"):
        _close(getattr(rt, key), getattr(rj, key))
    for key in ("dop_rho", "dop_xmx_norms", "rho", "xmx_norms"):
        np.testing.assert_allclose(getattr(rt, key), np.asarray(getattr(rj, key)), rtol=1e-6)
    _close(tf.predict_z(rt), jf.predict_z(rj))
    np.testing.assert_allclose(tf.predict_r_p(rt), jf.predict_r_p(rj), rtol=1e-8)


def test_fused_batched_dop_matches_jax(fitted):
    """The fused warm QPs (qp_fused=True, ip_steps_lane's plain version
    here) against the JAX package's fused DOP fit of the same spectra."""
    jf, tf, rj, rt = fitted[True]
    assert tf.fcfg.qp_fused
    np.testing.assert_array_equal(rt.n_iter, np.asarray(rj.n_iter))
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    for key in ("x", "x_dop", "r_inf", "inductance"):
        _close(getattr(rt, key), getattr(rj, key))
    np.testing.assert_allclose(rt.dop_rho, np.asarray(rj.dop_rho), rtol=1e-6)
    _close(tf.predict_z(rt), jf.predict_z(rj))


def test_batched_dop_matches_serial(fitted):
    """tests/test_parallel.py::test_fit_dop_batched_matches_serial on the
    port: the batched fit carries the serial loop's DOP smoothing matrices."""
    _, _, _, rt = fitted[False]
    for b in range(2):
        drt = hybdrt_torch.DRT(warn=False, fit_dop=True, device="cpu").fit_eis(
            fitted["f"], fitted["z"][b])
        _close(rt.x[b], drt.fit_parameters["x"])
        _close(rt.x_dop[b], drt.fit_parameters["x_dop"])
        assert rt.n_iter[b] == drt.qphb_params["n_iter"]


def test_from_arrays_takes_the_jax_dop_problem(fitted):
    jf, tf, _, rt = fitted[False]
    tf2 = BatchedEISFitter.from_arrays(jax_problem(jf), dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tf2.dop_gmat.numpy(), tf.dop_gmat.numpy(), rtol=1e-12,
                               atol=1e-300)
    r2 = tf2.fit(fitted["z"])
    np.testing.assert_array_equal(r2.n_iter, rt.n_iter)
    _close(r2.x_dop, rt.x_dop)
    _close(r2.x, rt.x)


def test_warm_from_a_jax_dop_result(fitted):
    """A frame warm from the JAX package's result carries its dop_rho and
    dop_xmx_norms; it lands where the frame warm from the port's own result
    lands (the two seeds agree to the fit tolerance), on the plain and the
    fused fitter."""
    _, _, rj, rt = fitted[False]
    for fused in (False, True):
        tf = fitted[fused][1]
        z1 = fitted["z"] * 1.02
        a = tf.fit(z1, warm_from=rj)
        b = tf.fit(z1, warm_from=rt)
        np.testing.assert_array_equal(a.n_iter, b.n_iter)
        _close(a.x, b.x, atol=1e-6 * np.max(np.abs(b.x)))
        _close(a.x_dop, b.x_dop, atol=1e-6 * np.max(np.abs(b.x)))
        assert np.all(np.isfinite(a.dop_rho)) and not np.array_equal(a.dop_rho, rt.dop_rho)


def test_param_cov_matches_jax(fitted):
    jf, tf, rj, rt = fitted[False]
    cov_j = np.asarray(jf.param_cov(rj, fitted["z"]))
    cov_t = tf.param_cov(rt, fitted["z"])
    rzv, _ = tf.scale_batch(fitted["z"])
    p_t = tf.posterior_pq(rzv, rt)[0].numpy()
    p_j = np.linalg.inv(np.asarray(jf.param_cov(rj, fitted["z"], scaled=True)))
    for b in range(2):
        bound = probe.cov_bound(p_t[b], p_j[b])
        assert np.max(np.abs(cov_t[b] - cov_j[b])) <= bound * np.max(np.abs(cov_j[b]))
    # the DOP block's physical units: the scaled inverse times the lane's
    # scale and the DOP scale vector
    scaled = tf.param_cov(rt, fitted["z"], scaled=True)
    ds, de = tf.cfg.dop_start, tf.cfg.dop_start + tf.cfg.dop_size
    sv = rt.scale[0] * tf.dop_scale_vector
    np.testing.assert_allclose(cov_t[0, ds:de, ds:de],
                               scaled[0, ds:de, ds:de] * sv[:, None] * sv[None, :], rtol=1e-12)


def test_history_records_the_dop_rho(fitted):
    """return_history on a DOP fit records dop_rho per pass, and the fit
    under it is bitwise the plain fit."""
    _, tf, _, rt = fitted[False]
    res, hist = tf.fit(fitted["z"], return_history=True)
    np.testing.assert_array_equal(res.x_dop, rt.x_dop)
    last = hist["dop_rho_vector"][np.arange(2), rt.n_iter - 1]
    np.testing.assert_array_equal(last, rt.dop_rho)
    assert not np.array_equal(hist["dop_rho_vector"][:, 0], hist["dop_rho_vector"][:, 1])


def test_capacitance_batched_matches_serial():
    f, z = _parallel_batch()
    z = z + 1 / (2j * np.pi * f * 0.5)
    tf = BatchedEISFitter(f, fit_capacitance=True, dtype=torch.float64, device="cpu")
    rt = tf.fit(z)
    assert tf.special_qp_params["C_inv"]["index"] == tf.num_special - 1
    for b in range(2):
        drt = hybdrt_torch.DRT(warn=False, fit_capacitance=True, device="cpu").fit_eis(f, z[b])
        _close(rt.x[b], drt.fit_parameters["x"])
        assert rt.c_inv[b] == pytest.approx(drt.fit_parameters["C_inv"], abs=ATOL)
    assert np.all(rt.c_inv > 0) and rt.x_dop is None


def test_bench_dop_batch_at_n143():
    """make_dop_batch's spectra on the main leg's grid: n = 143 (50 nu
    functions beside the leg's 93), fitted with the bench's knobs, plain,
    batched against serial at the same atol, the residuals at the noise."""
    freq, z = probe.make_dop_batch(2, 71)
    tf = BatchedEISFitter(freq, fit_dop=True, dtype=torch.float64, device="cpu", **BENCH_KW)
    assert tf.rzm.shape[1] == 143
    rt = tf.fit(z, adaptive="staged", collect="lazy")
    assert rt.converged.all()
    rel = np.abs(tf.predict_z(rt) - z) / np.abs(z)
    assert np.median(rel) < 0.02
    base_f, base_z = probe.make_batch(2, 71)
    np.testing.assert_array_equal(freq, base_f)
    assert np.all(np.abs(z - base_z) > 0)


def test_hybrid_fitter_refuses_dop_and_capacitance():
    times, i_sig, _, freq, _ = probe.hybrid_data()
    prob = build_hybrid_problem(times, i_sig, freq)
    cfg = dict(vars(prob["cfg"]), dop_start=0, dop_size=3)
    with pytest.raises(ValueError, match="ragged fitter"):
        BatchedHybridFitter.from_arrays(dict(prob, cfg=cfg), device="cpu")
    sp = dict(prob["special_qp_params"], C_inv={"index": 0, "nonneg": True, "size": 1})
    with pytest.raises(ValueError, match="ragged fitter"):
        BatchedHybridFitter.from_arrays(dict(prob, special_qp_params=sp), device="cpu")
