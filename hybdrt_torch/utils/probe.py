"""Inputs and timers shared by the repository's scripts that drive the port on
a CUDA card (``chip_smoke.py``, ``torch_fit_walls.py``,
``torch_resolve_walls.py``, the experiments ``hybdrt_torch.experiments.
layouts`` and ``ip_loop``, ``utils/kernel_digest.py``) and by its tests.

Nothing here is on a fitting path: it makes seeded test inputs (and holds
the single-spectrum fit's golden spectrum and values), reads the
card's name and power limit, times calls, computes a call's bound (the
least time the card could take for its bytes and operations), holds one
parameter covariance against another by the readouts users take from it,
and runs the benchmark's post-fit map pipeline stage by stage
(``run_postproc_pipeline``) with the checks the het map's truth allows.
"""
import hashlib
import subprocess
import time

import numpy as np
import torch

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes through HBM and do n_ops float32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lower_bytes(b, n, itemsize=4):
    """Bytes of the lower triangles (diagonal included) of b (n, n) matrices,
    b n (n + 1) / 2 values: what a function defined on the lower triangle
    must read of its matrix."""
    return b * n * (n + 1) // 2 * itemsize


def chol_ops(b, n):
    """Operations of b Cholesky factorizations: the trailing updates of the
    lower triangle, sum_k k (k + 1) / 2 = (n^3 - n) / 6 multiply-adds each
    (about n^3 / 6), two operations a multiply-add."""
    return b * (n ** 3 - n) / 3


def solve_ops(b, n):
    """Operations of b forward and backward substitutions."""
    return b * 2 * n * n


def ip_steps_bound(b, n, n_steps):
    """(bound_ms, bound_by) of ``n_steps`` fused Mehrotra steps on b lanes of
    size n, float32: P and five vectors read once, three vectors written once;
    per step the factor, the matvec and two substitutions (the O(n) vector
    work, under 1 % of it, is left out)."""
    ops = n_steps * (chol_ops(b, n) + b * 2 * n * n + 2 * solve_ops(b, n))
    return bound(4 * b * n * n + 8 * 4 * b * n, ops)


def card_line():
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi exit {smi.returncode}: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def make_batch(batch, n_freq, seed=1):
    """The benchmark's spectra (``bench.py::make_batch``, copied so that the
    port's scripts need nothing of the TPU benchmark): ``batch`` 2-ZARC
    spectra with a series inductance on ``logspace(6, -1, n_freq)``, complex
    noise of 0.004. Returns (freq, z)."""
    rng = np.random.default_rng(seed)
    freq = np.logspace(6, -1, n_freq)
    z = np.zeros((batch, n_freq), dtype=complex)
    for i in range(batch):
        r1, r2 = rng.uniform(0.3, 1.5, 2)
        t1 = 10 ** rng.uniform(-5, -2)
        t2 = 10 ** rng.uniform(-2, 0.5)
        a1, a2 = rng.uniform(0.8, 0.95, 2)
        z[i] = (0.5 + r1 / (1 + (2j * np.pi * freq * t1) ** a1)
                + r2 / (1 + (2j * np.pi * freq * t2) ** a2)
                + 2j * np.pi * freq * 1e-7)
    noise = rng.normal(size=(batch, n_freq)) + 1j * rng.normal(size=(batch, n_freq))
    return freq, z + noise * 0.004


def make_dop_batch(batch, n_freq, seed=1):
    """``make_batch``'s spectra plus a seeded constant-phase term each,
    amplitude (j omega)^nu with nu in [-0.6, -0.4] and amplitude in [0.02,
    0.1] (the form of tests/test_parallel.py:292-300's DOP spectrum), for
    ``BatchedEISFitter(fit_dop=True)`` to find. The draws of ``make_batch``
    are unchanged; the term's come from their own generator. Returns (freq,
    z)."""
    freq, z = make_batch(batch, n_freq, seed)
    rng = np.random.default_rng([seed, 1])
    amp = rng.uniform(0.02, 0.1, batch)
    nu = rng.uniform(-0.6, -0.4, batch)
    return freq, z + amp[:, None] * (2j * np.pi * freq[None, :]) ** nu[:, None]


# The het leg's basis supergrid (bench.py:175): 10 points a decade
TAU_SUPER = np.logspace(-8, 3, 111)


def make_het_eis(n_eis=768, n_hybrid=256, seed=3):
    """The EIS observations of the benchmark's heterogeneous map
    (``bench.py::make_het_map``, copied so that the port's scripts need
    nothing of the TPU benchmark): the same random numbers drawn in the same
    order, the hybrid observations' draws consumed and discarded, so the
    ``n_eis`` spectra are the map's, on three grids (57, 71 and 49
    frequencies), in the map's order. Returns (observations, TAU_SUPER),
    each observation (None, (freq, z)) as the ragged fitter takes it."""
    rng = np.random.default_rng(seed)
    grids = [np.logspace(6, -1, 57), np.logspace(5, -1, 71), np.logspace(6, 0, 49)]
    # the hybrid protocols' sample counts (times) and frequency counts
    hybrid_sizes = [(10 + 80, 33), (6 + 60, 41)]
    n_tot = n_eis + n_hybrid
    kinds = np.array(["eis"] * n_eis + ["hyb"] * n_hybrid)
    rng.shuffle(kinds)
    obs = []
    for i, kind in enumerate(kinds):
        p = i / max(n_tot - 1, 1)
        r1 = 0.8 + 0.5 * p + rng.uniform(-0.05, 0.05)
        t1 = 10 ** (-2.8 + 1.2 * p)
        r2, t2 = 1.2, 1e-4
        r_inf = 0.4 + 0.1 * p
        if kind == "eis":
            freq = grids[i % 3]
            z = (r_inf + r1 / (1 + (2j * np.pi * freq * t1) ** 0.88)
                 + r2 / (1 + (2j * np.pi * freq * t2) ** 0.9))
            z = z + (rng.normal(size=len(freq)) + 1j * rng.normal(size=len(freq))) * 0.003
            obs.append((None, (freq, z)))
        else:
            n_times, n_freq = hybrid_sizes[i % 2]
            rng.normal(size=n_times)  # the voltage noise
            rng.normal(size=n_freq)   # the impedance noise, real
            rng.normal(size=n_freq)   # and imaginary
    return obs, TAU_SUPER



# The het map's two chrono protocols (bench.py:166-174): (times, step time,
# current step, frequencies)
HET_PROTOCOLS = [
    (np.concatenate([np.linspace(-0.05, -0.001, 10), np.geomspace(1e-4, 1.0, 80)]), 0.0, 0.1,
     np.logspace(5, 1, 33)),
    (np.concatenate([np.linspace(-0.02, -0.001, 6), np.geomspace(2e-4, 0.5, 60)]), 0.0, -0.08,
     np.logspace(4, 0, 41)),
]


def _rc_v(t, ts, amp, r, tau0):
    dt = t - ts
    return amp * r * np.where(dt > 0, 1 - np.exp(-np.maximum(dt, 0) / tau0), 0.0)


def _het_hybrid_obs(proto, p, rng):
    """One hybrid observation of the het map at map position p in [0, 1]
    (bench.py:196-222): two RC/ZARC elements, R_inf and the first element
    drifting with p, the draws in the map's order."""
    r1 = 0.8 + 0.5 * p + rng.uniform(-0.05, 0.05)
    t1 = 10 ** (-2.8 + 1.2 * p)
    r2, t2 = 1.2, 1e-4
    r_inf = 0.4 + 0.1 * p
    times, st, amp, freq = HET_PROTOCOLS[proto]
    i_sig = np.where(times >= st, amp, 0.0)
    v = r_inf * i_sig + _rc_v(times, st, amp, r1, t1) + _rc_v(times, st, amp, r2, t2)
    v = v + 5e-4 * rng.normal(size=len(times))
    z = (r_inf + r1 / (1 + (2j * np.pi * freq * t1) ** 0.99)
         + r2 / (1 + (2j * np.pi * freq * t2) ** 0.99))
    z = z + (rng.normal(size=len(freq)) + 1j * rng.normal(size=len(freq))) * 0.003
    return (times, i_sig, v), (freq, z)


def make_het_hybrid(n_eis=768, n_hybrid=256, seed=3):
    """The hybrid observations of the benchmark's heterogeneous map
    (``bench.py::make_het_map``, copied as ``make_het_eis`` is): the same
    random numbers drawn in the same order, the EIS observations' draws
    consumed and discarded, so the ``n_hybrid`` observations are the map's,
    on its two chrono protocols (90 samples and 33 frequencies, 66 and 41),
    in the map's order. Returns (observations, TAU_SUPER), each observation
    ((times, i_signal, v_signal), (freq, z)) as the ragged fitter takes
    it."""
    rng = np.random.default_rng(seed)
    eis_sizes = [57, 71, 49]
    n_tot = n_eis + n_hybrid
    kinds = np.array(["eis"] * n_eis + ["hyb"] * n_hybrid)
    rng.shuffle(kinds)
    obs = []
    for i, kind in enumerate(kinds):
        p = i / max(n_tot - 1, 1)
        if kind == "eis":
            rng.uniform(-0.05, 0.05)          # r1's jitter
            rng.normal(size=eis_sizes[i % 3])  # the impedance noise, real
            rng.normal(size=eis_sizes[i % 3])  # and imaginary
        else:
            obs.append(_het_hybrid_obs(i % 2, p, rng))
    return obs, TAU_SUPER


def make_het_map(n_eis=768, n_hybrid=256, seed=3, schedule="staged", device=None, **md_kw):
    """The benchmark's heterogeneous map as the port's ``DRTMD``
    (``bench.py::make_het_map``, copied as ``make_het_eis`` is): ``n_eis``
    EIS spectra on three grids and ``n_hybrid`` hybrid observations on two
    chrono protocols, shuffled, all in group "g" at psi "i" = their index,
    the random numbers drawn in the benchmark's order; ``batch_fit_kw`` the
    het leg's (``qp_max_iter=20, qp_max_iter_warm=4``, and
    ``adaptive="staged"`` with ``schedule="staged"``). ``device`` is the
    map's (the card by default); ``md_kw`` are further DRTMD options, such
    as ``fit_dop=True``."""
    from ..mapping.drtmd import DRTMD

    rng = np.random.default_rng(seed)
    grids = [np.logspace(6, -1, 57), np.logspace(5, -1, 71), np.logspace(6, 0, 49)]
    qp_kw = {"qp_max_iter": 20, "qp_max_iter_warm": 4}
    md = DRTMD(tau_supergrid=TAU_SUPER, psi_dim_names=["i"], warn=False, print_progress=False,
               batch_fit_kw={"adaptive": "staged", **qp_kw} if schedule == "staged"
               else dict(qp_kw), device=device, **md_kw)
    n_tot = n_eis + n_hybrid
    kinds = np.array(["eis"] * n_eis + ["hyb"] * n_hybrid)
    rng.shuffle(kinds)
    for i, kind in enumerate(kinds):
        p = i / max(n_tot - 1, 1)
        if kind == "eis":
            r1 = 0.8 + 0.5 * p + rng.uniform(-0.05, 0.05)
            t1, r_inf, freq = 10 ** (-2.8 + 1.2 * p), 0.4 + 0.1 * p, grids[i % 3]
            z = (r_inf + r1 / (1 + (2j * np.pi * freq * t1) ** 0.88)
                 + 1.2 / (1 + (2j * np.pi * freq * 1e-4) ** 0.9))
            z = z + (rng.normal(size=len(freq)) + 1j * rng.normal(size=len(freq))) * 0.003
            md.add_observation([float(i)], None, (freq, z), group_id="g")
        else:
            md.add_observation([float(i)], *_het_hybrid_obs(i % 2, p, rng), group_id="g")
    return md


def _zarc(f, r, tau0, a=0.9):
    return r / (1 + (2j * np.pi * f * tau0) ** a)


def small_map(kind):
    """A small seeded map for the port's DRTMD tests: (tau_supergrid,
    [(psi, chrono_data, eis_data)]). ``"mixed"``: 8 observations, EIS on two
    grids and hybrid on two chrono protocols (the map of
    tests/test_get_fits_batched.py:141); ``"eis"``: 6 spectra on one grid
    (tests/test_get_fits_batched.py:30); ``"hybrid"``: 4 hybrid observations
    on one protocol (tests/test_mapping.py:189)."""
    if kind == "eis":
        freq, rng = np.logspace(5, -1, 41), np.random.default_rng(3)
        obs = []
        for k in range(6):
            z = 0.4 + _zarc(freq, 1.0 + 0.1 * k, 10 ** (-3 + 0.2 * k))
            z = z + (rng.normal(size=len(freq)) + 1j * rng.normal(size=len(freq))) * 0.002
            obs.append(([float(k)], None, (freq, z)))
        return np.logspace(-7, 2, 71), obs
    if kind == "hybrid":
        times = np.concatenate([np.linspace(-0.005, -0.0005, 8), np.logspace(-5, 0, 60)])
        i_sig = np.where(times >= 0, 0.1, 0.0)
        freq = np.logspace(5, -1, 25)
        obs = []
        for k in range(4):
            r = np.random.default_rng(k)
            tau0, r0 = 10 ** r.uniform(-3, -2), r.uniform(1.0, 2.0)
            v = 0.3 * i_sig + 0.1 * r0 * (1 - np.exp(-np.maximum(times, 0) / tau0)) \
                * (times >= 0) + r.normal(0, 2e-4, len(times))
            z = 0.3 + r0 / (1 + 2j * np.pi * freq * tau0) + r.normal(0, 1e-3, 25) * (1 + 1j)
            obs.append(([700.0 + k], (times, i_sig, v), (freq, z)))
        return np.logspace(-7, 2, 91), obs
    if kind != "mixed":
        raise ValueError(f"kind {kind!r}: expected 'mixed', 'eis' or 'hybrid'")
    rng = np.random.default_rng(7)
    grids = [np.logspace(5, -1, 41), np.logspace(4, 0, 31)]
    protos = [np.concatenate([np.linspace(-0.05, -0.001, 8), np.geomspace(1e-4, 1.0, 60)]),
              np.concatenate([np.linspace(-0.02, -0.001, 6), np.geomspace(2e-4, 0.5, 50)])]
    obs, n_hyb = [], 0
    for k in range(8):
        r1 = 0.9 + 0.05 * k
        if k % 3 == 2:
            times = protos[n_hyb % 2]
            n_hyb += 1
            i_sig = np.where(times >= 0.0, 0.1, 0.0)
            v = 0.4 * i_sig + _rc_v(times, 0.0, 0.1, r1, 1e-3) + _rc_v(times, 0.0, 0.1, 1.2, 1e-1)
            v = v + 5e-4 * rng.normal(size=len(times))
            z = 0.4 + _zarc(grids[0], r1, 1e-3, 0.99) + _zarc(grids[0], 1.2, 1e-1, 0.99)
            z = z + 0.003 * (rng.normal(size=len(z)) + 1j * rng.normal(size=len(z)))
            obs.append(([float(k)], (times, i_sig, v), (grids[0], z)))
        else:
            f = grids[k % 2]
            z = 0.4 + _zarc(f, r1, 1e-3) + _zarc(f, 1.2, 1e-1)
            z = z + 0.003 * (rng.normal(size=len(f)) + 1j * rng.normal(size=len(f)))
            obs.append(([float(k)], None, (f, z)))
    return np.logspace(-7, 2, 71), obs


def make_hybrid_batch(batch, proto=0, seed=3):
    """``batch`` hybrid observations on het protocol ``proto``, their
    parameters drifting over the map as in ``bench.py::make_het_map``
    (observation k at map position k / (batch - 1)). Returns (times,
    i_signal, freq, v (batch, n_times), z (batch, n_freq)), as
    ``BatchedHybridFitter`` takes them."""
    rng = np.random.default_rng(seed)
    obs = [_het_hybrid_obs(proto, k / max(batch - 1, 1), rng) for k in range(batch)]
    (times, i_sig, _), (freq, _) = obs[0]
    return (times, i_sig, freq, np.stack([c[2] for c, _ in obs]),
            np.stack([e[1] for _, e in obs]))


def simulate_chrono(rng, r_inf=0.3, rcs=((1.0, 1e-3), (0.8, 1e-1)), v_base=0.05, i_step=0.1,
                    noise=2e-4):
    """A noisy chronopotentiometry record of R_inf and RC elements after one
    current step at t = 0, 20 samples before it (the generator of
    tests/test_chrono_hybrid.py:12-21): (times, i_signal, v_signal)."""
    t_pre = np.linspace(-0.01, -0.0005, 20)
    t_post = np.logspace(-5, 0.5, 150)
    times = np.concatenate([t_pre, t_post])
    i_sig = np.where(times >= 0, i_step, 0.0)
    v = v_base + r_inf * i_sig
    for r, tau in rcs:
        v = v + i_step * np.where(times >= 0, r * (1 - np.exp(-np.maximum(times, 0) / tau)), 0.0)
    v = v + rng.normal(size=len(times)) * noise
    return times, i_sig, v


def simulate_eis(rng, r_inf=0.3, rcs=((1.0, 1e-3), (0.8, 1e-1)), induc=1e-7, noise=2e-3):
    """The noisy spectrum of the same elements and an inductance on
    logspace(5, -1, 41) (tests/test_chrono_hybrid.py:24-31): (freq, z)."""
    freq = np.logspace(5, -1, 41)
    z = r_inf + 2j * np.pi * freq * induc
    for r, tau in rcs:
        z = z + r / (1 + 2j * np.pi * freq * tau)
    z = z + (rng.normal(size=len(freq)) + 1j * rng.normal(size=len(freq))) * noise
    return freq, z


def quickstart_eis(seed=0, noise=1e-3):
    """The quick start's spectrum (examples/quickstart.py:34-40): 0.4 ohm,
    ZARCs of 1.0 ohm at 1e-3 s and 0.8 ohm at 1e-1 s, 51 frequencies,
    seeded noise."""
    rng = np.random.default_rng(seed)
    freq = np.logspace(5, -1, 51)
    w = 2j * np.pi * freq
    z = 0.4 + 1.0 / (1 + (w * 1e-3) ** 0.9) + 0.8 / (1 + (w * 1e-1) ** 0.85)
    return freq, z + rng.normal(0, noise, len(freq)) * (1 + 1j)


def quickstart_readouts(drt):
    """The quick start's readouts of a fitted DRT (``chip_smoke.py`` phase
    16a), each on the DRT's device: a dict by name."""
    tau = drt.get_tau_eval(20)
    out = {"tau": tau, "ci": drt.predict_drt_ci(tau=tau),
           "peaks": drt.find_peaks(return_info=True),
           "peaks_prob": drt.find_peaks(method="prob", return_info=True),
           "quantify": drt.quantify_peaks(), "peak_drts": drt.estimate_peak_distributions(),
           "split": drt.split_r_p([1e-2]), "integral": drt.integrate_drt(1e-4, 1e0),
           "peak_prob": drt.predict_peak_prob(), "fisher": drt.fisher_matrix(),
           "sigma": drt.predict_sigma("eis"), "chi_sq": drt.evaluate_chi_sq(),
           "cov": drt.estimate_param_cov(),
           "var": np.diag(drt.estimate_distribution_cov(tau=tau))}
    for fn in ("rss", "llh", "bic", "lml"):
        out[fn] = getattr(drt, f"evaluate_{fn}")()
    return out


def basis_probe(seed=0):
    """The probes of the tau bases other than gaussian: ((times, i, v),
    (freq, z)). The spectrum is one RC element after an ohmic 1 ohm, Rp = 1,
    z = 1 + 1 / (1 + j omega 1e-3) on logspace(5, -1, 41), noiseless; the
    chrono record a unit current step at t = 0, sampled 8 times before it and
    60 times on logspace(-5, 0) after, v = i (2 - exp(-t / 1e-3)) plus
    N(0, 1e-3) noise from ``seed``."""
    freq = np.logspace(5, -1, 41)
    z = 1 + 1 / (1 + 2j * np.pi * freq * 1e-3)
    times = np.concatenate([np.linspace(-5e-3, -5e-4, 8), np.logspace(-5, 0, 60)])
    i_sig = np.where(times >= 0, 1.0, 0.0)
    v = i_sig * (2 - np.exp(-np.maximum(times, 0) / 1e-3)) \
        + np.random.default_rng(seed).normal(0, 1e-3, len(times))
    return (times, i_sig, v), (freq, z)


def eis_systems(drt, freq, z_batch):
    """Prep-only EIS systems of the spectra ``z_batch`` (B, F) on one grid
    for ``BatchedRaggedFitter.from_systems``: the first spectrum's system as
    ``drt`` (a ``DRT`` of any basis) assembles it, and each spectrum's own
    scaled data vector and scales on the same matrices, as the ragged
    fitter's EIS fast path rescales a cached grid's
    (``BatchedRaggedFitter._eis_rescale_batch``). The systems share one
    design-matrix array, so they are one protocol."""
    from ..parallel.ragged import BatchedRaggedFitter
    tmpl = drt._qphb_fit_core(None, None, None, freq, z_batch[0], prep_only=True)
    return BatchedRaggedFitter._eis_rescale_batch(tmpl, list(z_batch))


def hybrid_data(seed=0):
    """simulate_chrono then simulate_eis from one seeded generator, as
    tests/test_chrono_hybrid.py draws them: (times, i, v, freq, z)."""
    rng = np.random.default_rng(seed)
    return (*simulate_chrono(rng), *simulate_eis(rng))

# The single-spectrum fit's golden spectrum and values
# (tests/test_drt_fit_golden.py, the reference implementation's own test): a
# noisy 71-point spectrum of a 3-HN model on logspace(6, -1, 71), fitted with
# the hyperparameters GOLDEN_HYPERS
_GOLDEN_Z_RE = np.array([
    0.99889671, 1.00364568, 1.00802691, 1.00868921, 1.01193953, 1.01167283, 1.01045899,
    1.01238999, 1.02235713, 1.0179453, 1.01815705, 1.02482687, 1.02840612, 1.03968502,
    1.03310749, 1.05056441, 1.05762158, 1.06837122, 1.07359505, 1.09137543, 1.10002385,
    1.11654741, 1.12038788, 1.13607981, 1.1444828, 1.14813794, 1.1529311, 1.17390042, 1.17778932,
    1.19168201, 1.20029145, 1.19913226, 1.21694161, 1.22941691, 1.24410305, 1.25726756,
    1.26743061, 1.28597281, 1.30467801, 1.32656415, 1.3521177, 1.38470823, 1.40523225, 1.4434634,
    1.47156977, 1.49632288, 1.52847188, 1.55965783, 1.58105599, 1.62653981, 1.64960656,
    1.68402514, 1.7129335, 1.73225266, 1.75441692, 1.77836734, 1.79861273, 1.81508215,
    1.83830849, 1.84387732, 1.85843918, 1.88833325, 1.88512901, 1.90256583, 1.9059794, 1.9272862,
    1.93782168, 1.94043462, 1.94148382, 1.94846802, 1.97133255,
])
_GOLDEN_Z_IM = np.array([
    0.62833408, 0.49781925, 0.38723232, 0.29846879, 0.2428213, 0.18923525, 0.14173219,
    0.10196859, 0.07665613, 0.05918841, 0.03406093, 0.02169228, 0.00164515, -0.01330543,
    -0.02751008, -0.04152612, -0.04401618, -0.0523578, -0.05895716, -0.06154152, -0.0577652,
    -0.0612978, -0.05449876, -0.05682261, -0.06512134, -0.06226965, -0.06317847, -0.06342293,
    -0.0676267, -0.07460637, -0.07316576, -0.08130117, -0.09472669, -0.09355075, -0.11112609,
    -0.11285912, -0.10348278, -0.12893697, -0.14401065, -0.1521387, -0.15353221, -0.1607032,
    -0.18158171, -0.18865052, -0.18284169, -0.18323229, -0.18958442, -0.19855012, -0.20208253,
    -0.1810663, -0.18390339, -0.16729184, -0.16708122, -0.14868366, -0.14412821, -0.14484088,
    -0.14164223, -0.12675187, -0.12669647, -0.10207541, -0.09934482, -0.10690078, -0.08903131,
    -0.08346884, -0.06585967, -0.06949637, -0.06116268, -0.05517752, -0.04811498, -0.0405763,
    -0.02605813,
])
_GOLDEN_X = np.array([
    0.00019874, 0.00041775, 0.00069699, 0.00098508, 0.00127749, 0.00155336, 0.00180174,
    0.0020093, 0.00216608, 0.00226478, 0.00230431, 0.00229261, 0.00224983, 0.00220968,
    0.00221841, 0.00233105, 0.00260575, 0.00309815, 0.00385803, 0.0049305, 0.00636303,
    0.00821776, 0.01058845, 0.01361917, 0.01747668, 0.02213164, 0.02700166, 0.03101173,
    0.03321168, 0.03328916, 0.03160234, 0.02888696, 0.02589884, 0.02317529, 0.02098151,
    0.01938761, 0.01837268, 0.01789392, 0.01791649, 0.01842183, 0.01940827, 0.02088956,
    0.02289336, 0.0254588, 0.02863303, 0.03246775, 0.03701578, 0.04231712, 0.04836101, 0.0550291,
    0.06205095, 0.06900713, 0.07540005, 0.08077218, 0.08480078, 0.08729458, 0.08811254,
    0.08712343, 0.08429337, 0.07983642, 0.07426128, 0.06823928, 0.062385, 0.05710335, 0.0525589,
    0.0487345, 0.04551335, 0.04274385, 0.04027294, 0.03795622, 0.03565898, 0.03326137,
    0.03067286, 0.02785433, 0.02483919, 0.0217362, 0.01869895, 0.01586952, 0.01333301,
    0.01111093, 0.009184, 0.00751758, 0.00607658, 0.00483089, 0.00375698, 0.00283644, 0.00205698,
    0.00140697, 0.00088439, 0.00047408, 0.00019762,
])
_GOLDEN_SIGMA_RE = np.array([
    0.00352773, 0.00355584, 0.00358423, 0.00361284, 0.00364164, 0.00367057, 0.00369959,
    0.00372863, 0.00375765, 0.00378659, 0.00381541, 0.00384406, 0.0038725, 0.0039007, 0.00392864,
    0.00395629, 0.00398365, 0.00401072, 0.00403752, 0.00406408, 0.00409042, 0.00411659,
    0.00414266, 0.00416869, 0.00419474, 0.00422089, 0.00424723, 0.00427383, 0.00430076,
    0.00432811, 0.00435594, 0.00438432, 0.0044133, 0.00444293, 0.00447324, 0.00450428,
    0.00453606, 0.0045686, 0.00460191, 0.004636, 0.00467088, 0.00470653, 0.00474295, 0.00478014,
    0.00481808, 0.00485678, 0.0048962, 0.00493635, 0.0049772, 0.00501873, 0.00506092, 0.00510374,
    0.00514716, 0.00519115, 0.00523566, 0.00528066, 0.0053261, 0.00537193, 0.0054181, 0.00546455,
    0.00551124, 0.0055581, 0.00560508, 0.00565214, 0.00569921, 0.00574625, 0.00579321,
    0.00584006, 0.00588676, 0.00593327, 0.00597956,
])
_GOLDEN_SIGMA_IM = np.array([
    0.00393066, 0.0039453, 0.00396083, 0.00397739, 0.00399509, 0.00401407, 0.0040345, 0.00405652,
    0.00408032, 0.00410607, 0.00413395, 0.00416412, 0.00419677, 0.00423202, 0.00427003,
    0.00431088, 0.00435465, 0.00440137, 0.00445102, 0.00450355, 0.00455885, 0.00461677,
    0.00467709, 0.00473957, 0.00480392, 0.00486982, 0.0049369, 0.00500477, 0.00507305,
    0.00514131, 0.00520914, 0.00527613, 0.00534187, 0.00540598, 0.0054681, 0.00552789,
    0.00558505, 0.00563931, 0.00569046, 0.00573831, 0.00578272, 0.00582359, 0.00586087,
    0.00589454, 0.00592464, 0.00595121, 0.00597435, 0.00599416, 0.0060108, 0.00602441,
    0.00603518, 0.00604327, 0.00604888, 0.0060522, 0.00605342, 0.00605275, 0.00605037,
    0.00604646, 0.00604121, 0.00603479, 0.00602737, 0.0060191, 0.00601015, 0.00600064,
    0.00599072, 0.00598052, 0.00597015, 0.00595973, 0.00594936, 0.00593914, 0.00592916,
])
_GOLDEN_Q = np.array([
    -320211.857, -459442.569, -130321.812, -130209.048, -130057.266, -129851.869, -129573.211,
    -129195.938, -128689.482, -128020.927, -127161.115, -126093.171, -124820.06, -123366.151,
    -121771.022, -120078.48, -118326.941, -116544.584, -114749.202, -112950.524, -111153.021,
    -109358.185, -107565.941, -105775.436, -103985.409, -102194.43, -100401.057, -98604.014,
    -96802.3405, -94995.5192, -93183.5517, -91366.9873, -89546.9026, -87724.8161, -85902.5306,
    -84081.9328, -82264.8079, -80452.7118, -78646.9162, -76848.4103, -75057.9258, -73275.9286,
    -71502.5848, -69737.7094, -67980.7539, -66230.8571, -64486.9232, -62747.6598, -61011.5491,
    -59276.7988, -57541.3584, -55803.0364, -54059.6871, -52309.3909, -50550.5903, -48782.1724,
    -47003.4922, -45214.337, -43414.8463, -41605.4724, -39787.0094, -37960.6683, -36128.1231,
    -34291.4767, -32453.1337, -30615.6266, -28781.4499, -26952.9648, -25132.4006, -23321.9259,
    -21523.7474, -19740.2187, -17973.9904, -16228.2734, -14507.2684, -12816.7916, -11165.1229,
    -9564.06425, -8030.06941, -6584.97664, -5255.47649, -4070.23466, -3054.23879, -2221.77302,
    -1571.38003, -1085.91711, -737.718617, -495.76587, -331.455594, -221.527108, -148.587525,
    -100.336558, -68.3843652,
])
GOLDEN_R_INF = 0.997377866144492
GOLDEN_INDUCTANCE = 1.0101699023637295e-07
GOLDEN_HYPERS = dict(rp_scale=14, derivative_weights=np.array([1.5, 1.0, 0.5]),
                     sigma_ds=np.array([1, 1000, 1000]), l1_lambda_0=0, l2_lambda_0=142,
                     s_alpha=np.array([5, 10, 25]), rho_alpha=np.array([0.15, 0.2, 0.25]),
                     iw_alpha=None, iw_beta=None, s_0=np.ones(3), rho_0=np.ones(3),
                     outlier_p=None)


def golden_fit():
    """(freq, z, expected): the golden spectrum and the expected values of
    its fit (x, R_inf, inductance, z_sigma_tot, q_vector)."""
    return np.logspace(6, -1, 71), _GOLDEN_Z_RE + 1j * _GOLDEN_Z_IM, {
        "x": _GOLDEN_X, "R_inf": GOLDEN_R_INF, "inductance": GOLDEN_INDUCTANCE,
        "z_sigma_tot": _GOLDEN_SIGMA_RE + 1j * _GOLDEN_SIGMA_IM, "q_vector": _GOLDEN_Q}


def make_frames(batch, n_freq, n_frames, drift, seed=1):
    """An operando sequence of ``n_frames`` frames of ``batch`` spectra of
    ``make_batch``'s kind: each lane draws ``make_batch``'s parameters once
    (two ZARCs and a series inductance on ``logspace(6, -1, n_freq)``), and
    in frame f its R1 is scaled by 1 + drift f, log10 tau1 moves by
    +drift f and log10 tau2 by -drift f, with fresh complex noise of 0.004
    in every frame, all from one numpy seed. Frame 0 is of ``make_batch``'s
    distribution but not its draws. Returns (freq, z) with z of shape
    (n_frames, batch, n_freq)."""
    rng = np.random.default_rng(seed)
    freq = np.logspace(6, -1, n_freq)
    r1, r2 = rng.uniform(0.3, 1.5, (2, batch, 1))
    lt1, lt2 = rng.uniform(-5, -2, (batch, 1)), rng.uniform(-2, 0.5, (batch, 1))
    a1, a2 = rng.uniform(0.8, 0.95, (2, batch, 1))
    jw = 2j * np.pi * freq
    frames = []
    for f in range(n_frames):
        z = (0.5 + r1 * (1 + drift * f) / (1 + (jw * 10 ** (lt1 + drift * f)) ** a1)
             + r2 / (1 + (jw * 10 ** (lt2 - drift * f)) ** a2) + jw * 1e-7)
        noise = rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)
        frames.append(z + noise * 0.004)
    return freq, np.stack(frames)


def make_stream(batch, n_freq):
    """A stream of four batches of ``make_batch``'s spectra, of batch, batch,
    batch // 2 and batch lanes, each from its own seed (11 to 14). Returns
    (freq, [z, ...])."""
    sizes = (batch, batch, batch // 2, batch)
    return (make_batch(1, n_freq)[0],
            [make_batch(n, n_freq, seed=11 + i)[1] for i, n in enumerate(sizes)])


def cov_readouts(fitter, n_tau=56):
    """(Q, N) rows u of the variances a user reads off a parameter covariance
    C as u^T C u: the DRT at ``n_tau`` log-spaced points over the basis (the
    CI band squared, on the grid of tests/test_f32_accuracy.py) and R_inf
    (sigma(R_inf) squared)."""
    from ..ops import basis as basis_mod

    tau = np.logspace(np.log10(fitter.basis_tau[0]), np.log10(fitter.basis_tau[-1]), n_tau)
    em = basis_mod.construct_func_eval_matrix(np.log(fitter.basis_tau), np.log(tau),
                                              epsilon=fitter.tau_epsilon)
    ns = fitter.num_special
    u = np.zeros((n_tau + 1, ns + em.shape[1]))
    u[:n_tau, ns:] = em
    u[n_tau, fitter.special_qp_params["R_inf"]["index"]] = 1.0
    return u


def readout_errors(cov, p, cov_ref, p_ref, u):
    """The readouts u^T C u (rows of ``u``) of the scaled covariance ``cov``
    against those of ``cov_ref``, both (B, N, N) float64 inverses of the
    posterior precisions ``p`` and ``p_ref``: (relative error, bound), each
    (B, Q). The bound is first order in the perturbation of P behind the
    difference: each inverse's rounding, a componentwise perturbation of
    sqrt(N) eps |P| (the probabilistic backward error of an LU inverse, in
    place of the worst case's 3 N eps), and |p - p_ref|. With C = cov_ref,

        |C u|^T (sqrt(N) eps |P| + |p - p_ref|) |C u| / |u^T C u|,

    the readout's own sensitivity: near eps on a well-conditioned lane, and
    as loose along P's near-null directions as float64 leaves them."""
    v = np.einsum("qi,bij,qj->bq", u, cov, u)
    v_ref = np.einsum("qi,bij,qj->bq", u, cov_ref, u)
    cu = np.abs(np.einsum("bij,qj->bqi", cov_ref, u))
    pert = np.sqrt(p.shape[-1]) * np.finfo(float).eps * np.abs(p_ref) + np.abs(p - p_ref)
    bound = np.einsum("bqi,bij,bqj->bq", cu, pert, cu) / np.abs(v_ref)
    return np.abs(v - v_ref) / np.abs(v_ref), bound


def cov_bound(p, p_ref):
    """The relative bound tests/test_torch_cov.py holds a posterior
    covariance to: max(1e-6, cond(P_ref) max(eps, dP)) of its
    max |cov|, dP the relative difference of the two packages' P."""
    d_p = np.max(np.abs(p - p_ref)) / np.max(np.abs(p_ref))
    return max(1e-6, np.linalg.cond(p_ref) * max(np.finfo(float).eps, d_p))


def variance_errors(var, var_ref, p, p_ref, em, ns, tau=None, basis_tau=None):
    """(relative error, bound) of distribution variances ``var`` against
    ``var_ref`` (T,) read off the DRT block (columns ``ns:``) of posteriors
    of precision ``p`` and ``p_ref`` through the rows of ``em`` (T,
    n_basis): ``readout_errors``' first-order bound. Where ``tau`` and
    ``basis_tau`` are given, a point beyond the basis, whose variance
    ``extend_var`` extrapolates from the nearest point inside, takes the
    larger of its own bound and that point's."""
    u = np.zeros((len(em), p.shape[-1]))
    u[:, ns:] = em
    c_ref = np.linalg.inv(p_ref)[None]
    _, bound = readout_errors(c_ref, p[None], c_ref, p_ref[None], u)
    bound = bound[0]
    if tau is not None:
        # where the basis reads nothing (far beyond it) the own bound is 0/0
        inside = np.flatnonzero((tau >= basis_tau[0]) & (tau <= basis_tau[-1]))
        left, right = tau < basis_tau[0], tau > basis_tau[-1]
        bound[left] = np.fmax(bound[left], bound[inside[0]])
        bound[right] = np.fmax(bound[right], bound[inside[-1]])
    return np.abs(var - var_ref) / np.abs(var_ref), bound


def posterior_definite(md, obs_index):
    """Per observation of the map ``md``, whether its posterior precision P
    has a float64 Cholesky factor on the CPU: where it has none,
    ``invert_psd`` falls back to the general inverse in both packages, and
    the variances read off it may be negative (ROADMAP Queue 3 item 17)."""
    fits = md.get_fits_batched(obs_index)
    return np.array([int(torch.linalg.cholesky_ex(torch.as_tensor(
        np.asarray(fits[i].fit_parameters["p_matrix"])))[1]) == 0 for i in obs_index])


def lml_bound(p, a):
    """First-order bound on how far the log-marginal likelihood of a
    posterior of precision ``p`` = Omega + A^T A (``a`` = W rm, m x n) moves
    under the rounding of its two log dets: 1/2 sum |M^-1| |dM| over M = P
    and Omega, dM the rounding of P's assembly (m eps |A|^T |A|) and of each
    LU (n eps |M|), componentwise. At cond(P) 1e14-1e17 it reaches 1e-4-10
    on fit posteriors, where two LAPACKs' log dets differ by 1e-4-1e-2."""
    eps = np.finfo(float).eps
    m, n = a.shape
    omega = p - a.T @ a
    b_p = eps * np.sum(np.abs(np.linalg.inv(p)) * (m * np.abs(a).T @ np.abs(a) + n * np.abs(p)))
    b_o = eps * n * np.sum(np.abs(np.linalg.inv(omega)) * np.abs(omega))
    return 0.5 * (b_p + b_o)


# which standardized values each probability map reads, and how often: the
# peak map pp (1 - tp) reads the slope's window twice and the curvature twice
# (surface.peak_prob, surface.trough_prob); predict_curv_prob reads the height
# and the curvature once
PROB_FACTORS = {"peak": (1, 1, 1), "trough": (0, 1, 1), "peak_prob": (1, 2, 2),
                "curv": (1, 0, 1)}
# a probability is held where its bound is at most this; elsewhere the two
# readings' inputs lie too far apart to say more, and the point is counted as
# left out
PROB_HOLD = 0.05


def read_sigma(var, kind, floor=False):
    """The sigma a probability map ``kind`` reads off the variances ``var``
    (..., T), as it reads it: ``floor`` first applies the single fit's floor,
    median - 1.5 IQR over tau (models/drt.py::predict_peak_trough_probs);
    predict_curv_prob takes sqrt(max(var, 1e-30)), mapping/surface.py
    var ** 0.5 + 1e-12 (NaN where var < 0)."""
    var = np.asarray(var, dtype=float)
    with np.errstate(invalid="ignore"):
        if floor:
            sigma = var ** 0.5
            q25, q50, q75 = np.percentile(sigma, (25, 50, 75), axis=-1, keepdims=True)
            var = np.maximum(sigma, q50 - 1.5 * (q75 - q25)) ** 2
        if kind == "curv":
            return np.sqrt(np.maximum(var, 1e-30))
        return var ** 0.5 + 1e-12


def prob_bounds(kind, mus, mus_ref, var, var_ref, floor=False):
    """Per point, how far the probability map ``kind`` (``PROB_FACTORS``)
    may lie from its reference given the two readings' inputs: the means
    ``mus`` and ``mus_ref`` and the variances ``var`` and ``var_ref`` of
    orders 0-2 (each (..., T)), which the caller holds to their own bounds
    (``variance_errors``). Each factor is a normal CDF (or a difference of
    two along one argument) of a standardized value w = mu / sigma, with
    sigma as the map reads it (``read_sigma``); the CDF's slope is at most
    1/sqrt(2 pi), so a factor moves by at most |w - w_ref| / sqrt(2 pi) and
    by at most 1, and a product of factors in [0, 1] by at most the sum of
    theirs. Where the two heights differ in sign, the curvature factors,
    which read sign(f), may move by 1. Each factor's bound carries the
    rounding of its argument, 8 eps (6 + |w| + |w_ref|), and the sum that
    of the CDFs and products."""
    eps = np.finfo(float).eps
    out = 0.0
    for k, weight in enumerate(PROB_FACTORS[kind]):
        if not weight:
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            w = np.asarray(mus[k], dtype=float) / read_sigma(var[k], kind, floor)
            w_ref = np.asarray(mus_ref[k], dtype=float) / read_sigma(var_ref[k], kind, floor)
            dw = np.abs(w - w_ref) + 8 * eps * (6 + np.abs(w) + np.abs(w_ref))
        b = np.where(np.isfinite(dw), np.fmin(1.0, dw / np.sqrt(2 * np.pi)), 1.0)
        if k == 2 and kind != "curv":
            b = np.where(np.sign(mus[0]) == np.sign(mus_ref[0]), b, 1.0)
        out = out + weight * b
    return out + 16 * eps


def drt_prob_inputs(drt, drt_ref, tau):
    """What ``prob_bounds`` reads for two fitted single DRTs (``drt_ref``
    may be the JAX package's) on ``tau``: per order 0-2 each one's means
    and distribution variances, and the worst excess of the variances'
    difference over its readout bound (``variance_errors`` on both
    posteriors, points beyond the basis taking the nearest inside point's;
    <= 0 holds)."""
    from ..ops import basis as basis_mod
    out = {"mus": [], "mus_ref": [], "var": [], "var_ref": [], "var_excess": -np.inf}
    p, p_ref = (np.asarray(d.qphb_params["p_matrix"]) for d in (drt, drt_ref))
    for order in (0, 1, 2):
        em = basis_mod.func_eval_matrix_host(np.log(drt.basis_tau), np.log(tau), "gaussian",
                                             drt.tau_epsilon, order)
        var = np.diag(np.asarray(drt.estimate_distribution_cov(tau, order=order)))
        var_ref = np.diag(np.asarray(drt_ref.estimate_distribution_cov(tau, order=order)))
        err, bound = variance_errors(var, var_ref, p, p_ref, em, drt.get_qp_mat_offset(), tau,
                                     drt.basis_tau)
        out["var_excess"] = max(out["var_excess"], float(np.max(err - bound)))
        out["mus"].append(np.asarray(drt.predict_distribution(tau, order=order)))
        out["mus_ref"].append(np.asarray(drt_ref.predict_distribution(tau, order=order)))
        out["var"].append(var)
        out["var_ref"].append(var_ref)
    return out


def map_prob_inputs(md, md_ref, obs_index, tau):
    """``drt_prob_inputs`` for the observations ``obs_index`` of two fitted
    maps (``md_ref`` may be the JAX package's), through their
    ``predict_drt`` and ``predict_drt_var``: each of (n, T)."""
    from ..ops import basis as basis_mod
    fits = md.get_fits_batched(obs_index)
    p = {i: np.asarray(fits[i].fit_parameters["p_matrix"]) for i in obs_index}
    p_ref = {i: np.asarray(md_ref.get_fit(i).fit_parameters["p_matrix"]) for i in obs_index}
    out = {"mus": [], "mus_ref": [], "var": [], "var_ref": [], "var_excess": -np.inf}
    for order in (0, 1, 2):
        var = md.predict_drt_var(obs_index, tau, order=order)
        var_ref = np.asarray(md_ref.predict_drt_var(obs_index, tau, order=order))
        for k, i in enumerate(obs_index):
            d = fits[i]
            em = basis_mod.func_eval_matrix_host(np.log(d.basis_tau), np.log(tau), "gaussian",
                                                 d.tau_epsilon, order)
            err, bound = variance_errors(var[k], var_ref[k], p[i], p_ref[i], em,
                                         d.get_qp_mat_offset(), tau, d.basis_tau)
            out["var_excess"] = max(out["var_excess"], float(np.max(err - bound)))
        out["mus"].append(md.predict_drt(obs_index=obs_index, tau=tau, order=order))
        out["mus_ref"].append(np.asarray(md_ref.predict_drt(obs_index=obs_index, tau=tau,
                                                            order=order)))
        out["var"].append(var)
        out["var_ref"].append(var_ref)
    return out


def held_probabilities(p, p_ref, bound):
    """(held, worst excess, largest |dp| held): the points whose bound is
    at most ``PROB_HOLD``, and how far the two maps' difference there
    exceeds its bound (<= 0 holds)."""
    held = bound <= PROB_HOLD
    d = np.abs(np.asarray(p) - np.asarray(p_ref))
    excess = float(np.max(d[held] - bound[held])) if held.any() else -np.inf
    return held, excess, float(np.max(d[held])) if held.any() else 0.0


def inverse_residual(p, cov):
    """Per lane ||P C - I||_2 / (||P||_2 ||C||_2): the normwise backward
    error of C as the inverse of P, which a stable inverse keeps below
    N eps however ill-conditioned P is."""
    eye = np.eye(p.shape[-1])
    norm = lambda a: np.linalg.norm(a, 2, axis=(1, 2))
    return norm(p @ cov - eye) / (norm(p) * norm(cov))


def spd_batch(b, n, dtype, seed, device="cuda"):
    """b seeded SPD matrices G G^T + n I of size n and b right-hand sides."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, n))
    a = g @ np.swapaxes(g, 1, 2) + n * np.eye(n)
    rhs = rng.normal(size=(b, n))
    return (torch.as_tensor(a, dtype=dtype, device=device),
            torch.as_tensor(rhs, dtype=dtype, device=device))


def qp_batch(b, n, dtype, seed, device="cuda"):
    """b equilibrated (unit-diagonal) SPD box QPs of size n with a strictly
    interior warm start and lb in {-1, 0}, as ``ops/qp.py::solve_qp_box``
    hands them to the fused steps: [P, q, lb, x0, s0, z0]."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, n, n))
    a = g @ np.swapaxes(g, 1, 2) / n + 0.1 * np.eye(n)
    dinv = 1 / np.sqrt(np.einsum("bii->bi", a))
    lb = np.where(rng.uniform(size=(b, n)) < 0.25, -1.0, 0.0)
    s0 = rng.uniform(0.05, 2.0, size=(b, n))
    arrays = (a * dinv[:, :, None] * dinv[:, None, :], rng.normal(size=(b, n)), lb, lb + s0,
              s0, rng.uniform(0.05, 2.0, size=(b, n)))
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in arrays]


def freeze_lane(args, lane):
    """Make ``lane`` of the box QPs ``args`` (``qp_batch``) indefinite: -P,
    with s = 1 and z = 0.1 so that z/s cannot lift its negated diagonal. Its
    first pivot is negative, so the fused steps must leave it as it was."""
    args[0][lane] = -args[0][lane]
    args[4][lane], args[5][lane] = 1.0, 0.1
    args[3][lane] = args[2][lane] + args[4][lane]


def check_steps(name, fn, plain, args, n_steps, tol, frozen=None, label=""):
    """Fused steps ``fn`` against ``plain`` on the same box QPs ``args``
    (``qp_batch``), within rtol = atol = ``tol`` on x, s and z; lane
    ``frozen`` must keep its input while its neighbours step. Prints the
    errors and returns the max abs errors of x, s and z; raises RuntimeError
    on a miss."""
    got, want = fn(*args, n_steps), plain(*args, n_steps)
    b, n = args[1].shape
    errs = []
    for part, g, w in zip("xsz", got, want):
        err = (g - w).abs()
        if not bool(torch.all(err <= tol + tol * w.abs())):
            raise RuntimeError(f"{name} at ({b}, {n}, {n_steps} steps) {part}: max abs err "
                               f"{float(err.max())} beyond rtol = atol = {tol}")
        errs.append(float(err.max()))
    if frozen is not None:
        others = torch.ones(b, dtype=torch.bool, device=args[1].device)
        others[frozen] = False
        for g, inp in zip(got, args[3:]):
            if not torch.equal(g[frozen], inp[frozen]):
                raise RuntimeError(f"{name}: the failed lane {frozen} does not keep its input")
            if not bool(torch.isfinite(g).all() and (g[others] != inp[others]).any(dim=1).all()):
                raise RuntimeError(f"{name}: a neighbour of the failed lane {frozen} did not step")
    tag = {torch.float32: "f32", torch.float64: "f64"}[args[1].dtype]
    print(f"{name} vs plain at B={b} n={n} {tag} {n_steps} steps{label}: max abs err "
          f"x {errs[0]:.3g}, s {errs[1]:.3g}, z {errs[2]:.3g}"
          + (f"; lane {frozen} (indefinite P) kept its input" if frozen is not None else ""))
    return errs


def resolve_map(n_obs, seed=8):
    """The smooth analytic map of tests/test_resolve_coupled.py:93-125 on the
    benchmark's grids (71 frequencies, the 111-point supergrid of
    bench.py:180): z = 0.4 + R_ct / (1 + (j w tau)^0.85), R_ct = 1 + 0.5 p,
    tau = 10^(-3 + 2 p), p = linspace(0, 1, n_obs), noise 0.004. Returns
    (freq, tau_supergrid, p, z)."""
    freq, tau_super = np.logspace(6, -1, 71), np.logspace(-8, 3, 111)
    p = np.linspace(0, 1, n_obs)
    rng = np.random.default_rng(seed)
    z = 0.4 + (1 + 0.5 * p[:, None]) / (
        1 + (2j * np.pi * freq[None, :] * 10 ** (-3 + 2 * p[:, None])) ** 0.85)
    z = z + (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape)) * 0.004
    return freq, tau_super, p, z


def cuda_ms(fn, reps=20):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns, reps=20):
    """{name: [ms, ms]}: each callable of the dict ``fns`` timed by
    ``cuda_ms`` in turns, the list and then the list backwards."""
    ms = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        ms[k].append(cuda_ms(fns[k], reps))
    return ms


class FitLaunches:
    """Inside ``with``, records the lane kernels' launches made by each call
    of ``fitter._fit_plain`` (the fit of one batch, by ``fit`` or
    ``fit_stream``) in ``per_fit``, one dict per call, as the difference of
    the wrappers' counts around the call (no count is reset)."""

    def __init__(self, fitter):
        self.fitter, self.per_fit = fitter, []

    def __enter__(self):
        from ..ops import chol_lane, ip_lane

        real = self.fitter._fit_plain
        counts = lambda: {**chol_lane.LAUNCHES, **ip_lane.LAUNCHES}

        def counted(rzv):
            before = counts()
            out = real(rzv)
            self.per_fit.append({k: v - before[k] for k, v in counts().items()})
            return out

        self.fitter._fit_plain = counted
        return self

    def __exit__(self, *exc):
        del self.fitter._fit_plain


class SerialFits:
    """Inside ``with``, records each ``fit_observation`` of the map ``md`` (the
    serial ``fit_all``'s unit): in ``per_obs`` one dict per call, its
    observation, kind ("eis", "chrono" or "hybrid"), host wall (ending in a
    synchronize where the map is on the card), the launches of the lane
    kernels and the box QPs by route it made, as differences of the counts
    around the call (no count is reset)."""

    def __init__(self, md):
        self.md, self.per_obs = md, []

    def __enter__(self):
        from ..ops import chol_lane

        real = self.md.fit_observation
        counts = lambda: {**chol_lane.LAUNCHES, **{f"qp_{k}": v for k, v in
                                                   chol_lane.QP_ROUTES.items()}}
        cuda = self.md.device.type == "cuda"

        def recorded(i, ignore_errors=False):
            c, e = self.md.obs_data[i]
            kind = "eis" if c is None else ("chrono" if e is None else "hybrid")
            before = counts()
            t0 = time.time()
            real(i, ignore_errors=ignore_errors)
            if cuda:
                torch.cuda.synchronize()
            self.per_obs.append({"obs": i, "kind": kind, "wall": time.time() - t0,
                                 **{k: v - before[k] for k, v in counts().items()}})

        self.md.fit_observation = recorded
        return self

    def __exit__(self, *exc):
        del self.md.fit_observation

    def summary(self):
        """{kind: {"n", "median_wall", and the launches and QP routes of
        one fit, min and max}} over the recorded fits."""
        out = {}
        for kind in sorted({r["kind"] for r in self.per_obs}):
            rows = [r for r in self.per_obs if r["kind"] == kind]
            out[kind] = {"n": len(rows), "median_wall": float(np.median([r["wall"] for r in rows]))}
            for k in rows[0]:
                if k not in ("obs", "kind", "wall"):
                    vals = [r[k] for r in rows]
                    out[kind][k] = (min(vals), max(vals))
        return out


def serial_map(n_eis=96, n_hybrid=32, device=None):
    """The het leg's map at its full per-observation widths with fewer
    observations (``make_het_map(n_eis, n_hybrid)``: three EIS grids, two
    hybrid protocols, ``TAU_SUPER``, shuffled, group "g"), fitted by the
    reference's default ``fit_all()`` (serial, float64) inside
    ``SerialFits``. Returns (map, SerialFits, wall)."""
    md = make_het_map(n_eis, n_hybrid, device=device)
    with SerialFits(md) as log:
        t0 = time.time()
        md.fit_all()
        wall = time.time() - t0
    return md, log, wall


def serial_batched_agreement(md_serial, md_batched, rtol=1e-6):
    """(share of observations fitted to the same iteration count, share
    whose obs_x lies within ``rtol`` of max |x| as well) of a serially
    fitted map against the same observations fitted by
    ``fit_all(batched=True)``."""
    it_s = np.array([a["qphb_params"]["n_iter"] for a in md_serial.obs_fit_attr])
    it_b = np.array([a["n_iter"] for a in md_batched.obs_fit_attr])
    dx = np.max(np.abs(md_serial.obs_x - md_batched.obs_x), axis=1)
    close = dx <= rtol * np.max(np.abs(md_batched.obs_x), axis=1)
    return float(np.mean(it_s == it_b)), float(np.mean((it_s == it_b) & close))


def timed(fn):
    """Host-clock seconds of one call of ``fn`` that ends in a synchronize."""
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def device_event_sums(prof):
    """{name: (device ns, count)} of the CUDA events of a finished
    ``torch.profiler`` run, summed from the profiler's raw results: the
    sums of ``key_averages``' CUDA rows without its parse of every event
    (tens of seconds at 1e5 kernels). ``tests/test_torch_cuda.py::
    test_device_event_sums_match_key_averages`` holds the two equal."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ns, count = rows.get(e.name(), (0, 0))
            rows[e.name()] = (ns + e.duration_ns(), count + 1)
    return rows


def key_average_sums(prof):
    """{name: (device ns, count)} of ``key_averages``' CUDA rows."""
    return {e.key: (e.self_device_time_total * 1e3, e.count) for e in prof.key_averages()
            if e.device_type.name == "CUDA"}


def profile(label, fn, top=8, key_averages=False):
    """One call of ``fn`` under ``torch.profiler`` with CUDA activity: prints
    its wall, summed kernel time (``device_event_sums``), busy share and the
    ``top`` kernels by device time; with ``key_averages`` also the same
    sums from ``key_averages``, timed."""
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CUDA]) as p:
        wall = timed(fn)
    rows = device_event_sums(p)
    total_s = sum(ns for ns, _ in rows.values()) / 1e9
    print(f"{label} profiled: wall {wall:.4f} s, kernel time {total_s:.4f} s in "
          f"{sum(c for _, c in rows.values())} kernels, busy {total_s / wall:.3f}")
    for name, (ns, count) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ns / 1e6:10.2f} ms {count:6d}x  {name[:90]}")
    if key_averages:
        t0 = time.time()
        ka = key_average_sums(p)
        t_ka = time.time() - t0
        print(f"{label} profiled, key_averages ({t_ka:.1f} s): kernel time "
              f"{sum(ns for ns, _ in ka.values()) / 1e9:.6f} s in "
              f"{sum(c for _, c in ka.values())} kernels, {len(ka)} names; raw events "
              f"{total_s:.6f} s in {sum(c for _, c in rows.values())} kernels, {len(rows)} names")


POSTPROC_STAGES = ("assemble_s", "filter_s", "flag_s", "ridges_s", "extrema_s")


def run_postproc_pipeline(md, return_outputs=False):
    """The post-fit map pipeline of ``bench.py::run_postproc_pipeline``
    (``bench.py:349-379``) on the port's modules, with its calls and
    arguments: ``assemble_ndx`` of ``md.obs_x`` sorted by psi "i",
    ``filter_ndx`` (sigma (2, 1)), ``flag_bad_obs``, ``coef_to_ridges`` and
    ``optimize_extrema``, each timed on the host clock. Returns the bench's
    keys: each stage's seconds (unrounded), ``total_s``, ``bad_obs``; with
    ``return_outputs`` also a dict of the outputs (x_nd, x_filt, bad,
    ridge_mask, trough_mask, p_ridge, p_trough, and the optimized masks
    ridge_opt, trough_opt)."""
    from ..mapping import extrema, nddata, ndx, surface

    out, res = {}, {}
    t0 = time.perf_counter()
    _, res["x_nd"] = ndx.assemble_ndx(md.obs_x, md.obs_psi, md.psi_dim_names,
                                      md.tau_supergrid, sort_by=["i"])
    out["assemble_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["x_filt"] = ndx.filter_ndx(res["x_nd"], 0, sigma=(2, 1))
    out["filter_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["bad"] = nddata.flag_bad_obs(res["x_nd"], res["x_filt"])
    out["flag_s"] = time.perf_counter() - t0
    out["bad_obs"] = int(np.sum(res["bad"]))
    t0 = time.perf_counter()
    res["ridge_mask"], res["trough_mask"], res["p_ridge"], res["p_trough"] = \
        surface.coef_to_ridges(res["x_filt"], md, num_group_dims=0)
    out["ridges_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["ridge_opt"], res["trough_opt"] = extrema.optimize_extrema(
        res["ridge_mask"], res["trough_mask"], res["p_ridge"], res["p_trough"])
    out["extrema_s"] = time.perf_counter() - t0
    out["total_s"] = sum(out[k] for k in POSTPROC_STAGES)
    return (out, res) if return_outputs else out


def postproc_digest(res):
    """SHA-256 of the pipeline's discrete outputs: the bad observations'
    indices and the optimized ridge and trough masks, as
    ``utils/fit_digest.py`` digests a fit."""
    h = hashlib.sha256()
    h.update(np.flatnonzero(res["bad"]).astype(np.int64).tobytes())
    for key in ("ridge_opt", "trough_opt"):
        h.update(np.asarray(res[key].shape, dtype=np.int64).tobytes())
        h.update(np.packbits(np.asarray(res[key], dtype=bool)).tobytes())
    return h.hexdigest()


def max_troughs_between_ridges(ridge_mask, trough_mask):
    """The most troughs any row of (rows, tau) masks has between two
    adjacent ridges (at most 1 where ridges and troughs alternate)."""
    most = 0
    for r, t in zip(np.asarray(ridge_mask, dtype=bool), np.asarray(trough_mask, dtype=bool)):
        ridges, troughs = np.flatnonzero(r), np.flatnonzero(t)
        if len(ridges) > 1 and len(troughs):
            between = np.histogram(troughs, bins=ridges)[0]
            most = max(most, int(between.max()))
    return most


def het_truth_shares(md, ridge_mask, reach=2):
    """Shares of the het map's rows (``make_het_map``, ``bench.py:202-206``:
    tau_2 = 1e-4 s everywhere, tau_1 = 10^(-2.8 + 1.2 p), p = i / (n - 1) at
    psi "i") whose ridge mask has a ridge within ``reach`` supergrid points
    of tau_1, of tau_2, and of both; ``ridge_mask`` (rows, tau) has the rows
    in psi order, as ``assemble_ndx`` sorts them. Returns {"eis" | "hybrid":
    {"tau1", "tau2", "both": share, "rows": count}}, hybrid rows being the
    observations with chrono data."""
    order = np.argsort(md.obs_psi[:, 0])
    hybrid = np.array([md.obs_data[k][0] is not None for k in order])
    log_grid = np.log10(md.tau_supergrid)
    p = md.obs_psi[order, 0] / max(md.num_obs - 1, 1)
    idx1 = np.argmin(np.abs(log_grid[None, :] - (-2.8 + 1.2 * p)[:, None]), axis=1)
    idx2 = int(np.argmin(np.abs(log_grid + 4.0)))
    cols = np.arange(len(log_grid))
    rm = np.asarray(ridge_mask, dtype=bool)
    near1 = (rm & (np.abs(cols[None, :] - idx1[:, None]) <= reach)).any(axis=1)
    near2 = (rm & (np.abs(cols - idx2) <= reach)[None, :]).any(axis=1)
    out = {}
    for name, sel in (("eis", ~hybrid), ("hybrid", hybrid)):
        n = int(sel.sum())
        out[name] = {"tau1": float(near1[sel].mean()) if n else float("nan"),
                     "tau2": float(near2[sel].mean()) if n else float("nan"),
                     "both": float((near1 & near2)[sel].mean()) if n else float("nan"),
                     "rows": n}
    return out
