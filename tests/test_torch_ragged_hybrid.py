"""Port parity: the ragged fitter's hybrid rows (hybdrt_torch.
BatchedRaggedFitter on chrono + EIS observations) against the JAX
BatchedRaggedFitter and the single fit_hybrid, float64 on the CPU
(``device="cpu"``; the fitter's default is the card). The counterparts of
tests/test_ragged.py's hybrid tests (:88, :234, :301, :385, :463), at their
tolerances: coefficients within 1e-6 of each observation's max (1e-5 against
the serial fit where the JAX test holds 1e-5), R_inf within 1e-6, the same
n_iter, padded coefficient tails exactly zero; the fast path's prep to
1e-12. The JAX fitter runs with ``batch_bucket=False``."""
import numpy as np
import pytest
import torch

import bench
import hybdrt_tpu
import hybdrt_torch
from hybdrt_tpu.parallel.ragged import BatchedRaggedFitter as JaxRagged
from hybdrt_torch import BatchedRaggedFitter
from hybdrt_torch.utils.probe import HET_PROTOCOLS, make_het_hybrid

torch.set_num_threads(1)

TAU_SG = np.logspace(-8, 3, 111)  # 10 ppd supergrid


def _zarc(f, r, tau0, a):
    return r / (1 + (2j * np.pi * f * tau0) ** a)


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(1e-12, np.max(np.abs(b)))


def _eis_obs(f, rng):
    z = 0.4 + _zarc(f, 1.0, 1e-2, 0.85) + _zarc(f, 1.5, 1e-1, 0.9)
    return (None, (f, z + 0.004 * rng.normal(size=len(f)) + 4e-3j * rng.normal(size=len(f))))


def _rc_v(t, ts, amp, r, tau0):
    dt = t - ts
    return amp * r * np.where(dt > 0, 1 - np.exp(-np.maximum(dt, 0) / tau0), 0.0)


def _hybrid_obs(times, st, amp, f, rng, r1=1.0):
    """tests/test_ragged.py's hybrid observation: R_inf 0.4 and two
    elements, the chrono record and the spectrum with their noise."""
    tau1, r2, tau2 = 1e-2, 1.5, 1e-4
    i_sig = np.where(times >= st, amp, 0.0)
    v = 0.4 * i_sig + _rc_v(times, st, amp, r1, tau1) + _rc_v(times, st, amp, r2, tau2)
    v = v + 5e-4 * rng.normal(size=len(times))
    z = 0.4 + _zarc(f, r1, tau1, 0.99) + _zarc(f, r2, tau2, 0.99)
    z = z + 0.003 * rng.normal(size=len(f)) + 3e-3j * rng.normal(size=len(f))
    return (times, i_sig, v), (f, z)


def _two_protocol_obs(seed=1):
    """One observation on each het protocol (tests/test_ragged.py:88)."""
    rng = np.random.default_rng(seed)
    return [_hybrid_obs(t, st, amp, f, rng) for (t, st, amp, f) in HET_PROTOCOLS]


@pytest.fixture(scope="module")
def hybrid():
    """Two hybrid observations on different protocols: the JAX ragged fit,
    the port's, and the port's fitter."""
    obs = _two_protocol_obs()
    fitter = BatchedRaggedFitter(TAU_SG, device="cpu")
    return obs, JaxRagged(TAU_SG, batch_bucket=False).fit(obs), fitter.fit(obs), fitter


def test_ragged_hybrid_matches_serial(hybrid):
    """Each observation as its single fit_hybrid (the port's and the JAX
    package's) at rel < 1e-6 and the same n_iter; the padded tails exactly
    zero; R_max 156 and N_max 83 as on the het map."""
    obs, _, res, _ = hybrid
    assert res.x_raw.shape[1] == 83 and res.weights.shape[1] == 156
    np.testing.assert_array_equal(res.num_chrono, [90, 66])
    for k, (c, e) in enumerate(obs):
        for drt in (hybdrt_torch.DRT(tau_supergrid=TAU_SG, warn=False, device="cpu"),
                    hybdrt_tpu.DRT(tau_supergrid=TAU_SG, warn=False)):
            drt.fit_hybrid(*c, *e)
            li, ri = res.tau_indices[k]
            assert _rel(res.x[k][:ri - li], drt.fit_parameters["x"]) < 1e-6
            assert res.n_iter[k] == drt.qphb_params["n_iter"]
            assert abs(res.r_inf[k] - drt.fit_parameters["R_inf"]) < 1e-6
        assert np.all(res.x[k][ri - li:] == 0.0)
        assert np.all(res.x_raw[k][4 + ri - li:] == 0.0)


def test_ragged_hybrid_matches_jax_ragged(hybrid):
    """Against the JAX ragged fit: x, n_iter, the effective weights, the
    predictions and the final designs with their vz-offset columns."""
    obs, r_jax, res, fitter = hybrid
    np.testing.assert_array_equal(res.n_iter, r_jax.n_iter)
    np.testing.assert_array_equal(res.num_chrono, r_jax.num_chrono)
    np.testing.assert_array_equal(res.num_rows, r_jax.num_rows)
    for k in range(len(obs)):
        assert _rel(res.x_raw[k], r_jax.x_raw[k]) < 1e-6
        n = res.num_rows[k]
        assert _rel(res.weights[k][:n], np.asarray(r_jax.weights)[k][:n]) < 1e-6
    jf = JaxRagged(TAU_SG, batch_bucket=False)
    jf.prepare(obs)
    y, yj = fitter.final_predictions(res), jf.final_predictions(r_jax)
    assert _rel(y, yj) < 1e-6
    assert _rel(fitter.final_design_matrices(res), jf.final_design_matrices(r_jax)) < 1e-6


def test_ragged_hybrid_from_jax_systems(hybrid):
    """from_systems on the JAX fitter's hybrid prep-only systems (with its
    host weight factors): the JAX ragged fit, independent of the port's
    assembly."""
    obs, r_jax, _, _ = hybrid
    jf = JaxRagged(TAU_SG, batch_bucket=False)
    systems = [jf._prep_obs(c, e) for c, e in obs]
    res = BatchedRaggedFitter.from_systems(systems, TAU_SG, device="cpu").fit()
    np.testing.assert_array_equal(res.n_iter, r_jax.n_iter)
    np.testing.assert_allclose(res.x, r_jax.x, rtol=0, atol=1e-8)
    assert res.tau_indices == r_jax.tau_indices


@pytest.mark.parametrize("fit_kw", [{"eis_weight_factor": 2.0, "chrono_weight_factor": 0.5},
                                    {"hybrid_weight_factor_method": "rp"},
                                    {"hybrid_weight_factor_method": "weight"}],
                         ids=["explicit", "rp", "weight"])
def test_ragged_hybrid_weight_factors(fit_kw):
    """Explicit factors and the "rp" method (resolved on the host) and the
    "weight" method (on the device, per lane) against the JAX ragged fit,
    and against the serial fit within rtol 1e-5 (tests/test_ragged.py:234,
    on its observation)."""
    rng = np.random.default_rng(3)
    times = np.concatenate([np.linspace(-0.005, -0.0005, 8), np.logspace(-5, 0, 50)])
    i_sig = np.where(times >= 0, 0.1, 0.0)
    freq = np.logspace(5, -1, 25)
    tau0, r0 = 3e-3, 1.5
    v = 0.3 * i_sig + 0.1 * r0 * (1 - np.exp(-np.maximum(times, 0) / tau0)) * (times >= 0) \
        + rng.normal(0, 2e-4, len(times))
    z = 0.3 + r0 / (1 + 2j * np.pi * freq * tau0) + rng.normal(0, 1e-3, 25) \
        + 1j * rng.normal(0, 1e-3, 25)
    obs = [((times, i_sig, v), (freq, z))]
    res = BatchedRaggedFitter(TAU_SG, fit_kw=dict(fit_kw), device="cpu").fit(obs)
    r_jax = JaxRagged(TAU_SG, fit_kw=dict(fit_kw), batch_bucket=False).fit(obs)
    np.testing.assert_array_equal(res.n_iter, r_jax.n_iter)
    assert _rel(res.x_raw[0], r_jax.x_raw[0]) < 1e-6
    assert _rel(res.weights[0], np.asarray(r_jax.weights)[0]) < 1e-6
    drt = hybdrt_tpu.DRT(warn=False, tau_supergrid=TAU_SG)
    drt.fit_hybrid(times, i_sig, v, freq, z, **fit_kw)
    x_serial = drt.fit_parameters["x"]
    np.testing.assert_allclose(res.x[0][:len(x_serial)], x_serial, rtol=1e-5, atol=1e-8)


def _shared_protocol_obs(rng, r1s):
    """Hybrid observations on one protocol: only the sample's first element
    and the noise vary (tests/test_ragged.py:281)."""
    times = np.concatenate([np.linspace(-0.05, -0.001, 10), np.logspace(-5, 0.0, 120)])
    freq = np.logspace(5, -1, 31)
    return [_hybrid_obs(times, 0.0, 1.0, freq, rng, r1) for r1 in r1s]


@pytest.mark.parametrize("fit_kw", [{}, {"hybrid_weight_factor_method": "rp"}],
                         ids=["default", "rp"])
def test_hybrid_fast_path_matches_serial_prep(fit_kw):
    """The second and third observations of a protocol take the cached
    system and redo only its scaling: equal to a fresh fitter's full prep
    (tests/test_ragged.py:301), and to the JAX fitter's own prep of them."""
    obs = _shared_protocol_obs(np.random.default_rng(7), (0.8, 1.3, 0.5))
    fitter = BatchedRaggedFitter(TAU_SG, fit_kw=fit_kw, device="cpu")
    systems = [fitter._prep_obs(c, e) for c, e in obs]
    jf = JaxRagged(TAU_SG, fit_kw=fit_kw, batch_bucket=False)
    jsys = [jf._prep_obs(c, e) for c, e in obs]
    for k in (1, 2):
        slow = BatchedRaggedFitter(TAU_SG, fit_kw=fit_kw, device="cpu")._prep_obs(*obs[k])
        fast = systems[k]
        assert fast["rzm"] is systems[0]["rzm"]
        for key in ("coefficient_scale", "impedance_scale", "response_signal_scale",
                    "scaled_response_offset"):
            assert fast[key] == pytest.approx(slow[key], rel=1e-12, abs=1e-15), key
            assert fast[key] == pytest.approx(jsys[k][key], rel=1e-12, abs=1e-15), key
        np.testing.assert_allclose(fast["rzv"], slow["rzv"], rtol=0, atol=1e-14)
        np.testing.assert_allclose(fast["rzv"], jsys[k]["rzv"], rtol=0, atol=1e-13)
        for key in ("host_eis_wf", "host_chrono_wf"):
            want = jsys[k][key]
            assert (fast[key] is None) == (want is None) == (slow[key] is None), key
            if want is not None:
                assert fast[key] == pytest.approx(want, rel=1e-12), key
                assert fast[key] == pytest.approx(slow[key], rel=1e-12), key
    # the batch built from the cache equals the per-observation build
    fast = BatchedRaggedFitter(TAU_SG, fit_kw=fit_kw, device="cpu")
    batch_fast = fast.prepare(obs)
    slow = BatchedRaggedFitter(TAU_SG, fit_kw=fit_kw, device="cpu")
    slow._prep_systems = lambda observations: [slow._prep_obs(c, e) for c, e in observations]
    batch_slow = slow.prepare(obs)
    for key in ("rzv", "var_floor"):
        np.testing.assert_allclose(batch_fast[key], batch_slow[key], rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(np.isnan(batch_fast["host_row_factors"]),
                                  np.isnan(batch_slow["host_row_factors"]))
    for key in fast._uniq:
        np.testing.assert_array_equal(fast._uniq[key], slow._uniq[key])


def test_hybrid_fast_path_end_to_end_matches_serial():
    """A ragged fit over shared-protocol hybrid observations (the fast path's
    prep) matches the serial fit_hybrid (tests/test_ragged.py:385)."""
    obs = _shared_protocol_obs(np.random.default_rng(3), (0.8, 1.2))
    res = BatchedRaggedFitter(TAU_SG, device="cpu").fit(obs)
    for k, (c, e) in enumerate(obs):
        drt = hybdrt_tpu.DRT(tau_supergrid=TAU_SG, warn=False)
        drt.fit_hybrid(*c, *e)
        li, ri = res.tau_indices[k]
        assert _rel(res.x[k][:ri - li], drt.fit_parameters["x"]) < 1e-5


@pytest.mark.parametrize("pred_stop", [False, True])
def test_ragged_hybrid_adaptive_modes_are_one_loop(hybrid, pred_stop):
    """adaptive True and "staged" on hybrid lanes run the same live-lane loop
    as False, bitwise (tests/test_ragged.py:463 holds the JAX staged
    schedule to its plain fit)."""
    obs = hybrid[0]
    fitter = BatchedRaggedFitter(TAU_SG, device="cpu", pred_stop=pred_stop, pred_rtol=3e-2)
    plain = fitter.fit(obs)
    for mode in (True, "staged"):
        r = fitter.fit(obs, adaptive=mode)
        np.testing.assert_array_equal(r.x_raw, plain.x_raw)
        np.testing.assert_array_equal(r.n_iter, plain.n_iter)


def test_mixed_data_types_rejected(hybrid):
    obs = hybrid[0]
    with pytest.raises(ValueError, match="identical QPHB config|one data type"):
        f = np.logspace(5, -1, 31)
        BatchedRaggedFitter(TAU_SG, device="cpu").fit(obs + [_eis_obs(f, np.random.default_rng(0))])


def test_het_hybrid_residuals_are_the_references():
    """On the het map's hybrid observations the fit cannot reach the noise,
    in the JAX package either: the ideal step is placed one sample interval
    before the first sample after it, 1e-4 s or more after the true step
    (preprocessing.get_step_info with offset_steps), against a 1e-4 s
    element. The port's ragged fit leaves the JAX single fits' residuals, to
    1e-6, above 0.02 on the EIS rows. Prints them."""
    obs, tau = make_het_hybrid(6, 2)
    fitter = BatchedRaggedFitter(tau, device="cpu")
    res = fitter.fit(obs)
    y = fitter.final_predictions(res)
    for k, ((t, i, v), (f, z)) in enumerate(obs):
        drt = hybdrt_tpu.DRT(tau_supergrid=tau, warn=False).fit_hybrid(t, i, v, f, z)
        nc, nf = len(t), len(f)
        z_hat = (y[k, nc:nc + nf] + 1j * y[k, nc + nf:nc + 2 * nf]) * res.scale[k]
        rel, rel_j = (np.median(np.abs(zz - z) / np.abs(z)) for zz in (z_hat, drt.predict_z(f)))
        print(f"obs {k}: median EIS residual port {rel:.4g}, JAX {rel_j:.4g}; step at "
              f"{drt.step_times[0]:.3g} s")
        assert abs(rel - rel_j) < 1e-6 and rel_j > 0.02
        assert drt.step_times[0] >= 8e-5


def test_make_het_hybrid_is_the_bench_map():
    """utils/probe.py::make_het_hybrid gives the hybrid observations of
    bench.make_het_map, in its order, value for value (a small map)."""
    md = bench.make_het_map(24, 8)
    want = [md.get_obs_data(i) for i in range(md.num_obs) if md.get_obs_data(i)[0][0] is not None]
    obs, _ = make_het_hybrid(24, 8)
    assert len(obs) == len(want) == 8
    for (c, e), (cw, ew) in zip(obs, want):
        for a, b in zip((*c, *e), (*cw, *ew)):
            np.testing.assert_array_equal(a, b)
