"""Inputs and timers shared by the repository's scripts that drive the port on
a CUDA card (``chip_smoke.py``, ``torch_fit_walls.py``,
``torch_resolve_walls.py``, the experiments ``hybdrt_torch.experiments.
layouts`` and ``ip_loop``, ``utils/kernel_digest.py``) and by its tests.

Nothing here is on a fitting path: it makes seeded test inputs (and holds
the single-spectrum fit's golden spectrum and values), reads the
card's name and power limit, times calls, computes a call's bound (the
least time the card could take for its bytes and operations), and holds one
parameter covariance against another by the readouts users take from it.
"""
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


def timed(fn):
    """Host-clock seconds of one call of ``fn`` that ends in a synchronize."""
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def profile(label, fn, top=8):
    """One call of ``fn`` under ``torch.profiler`` with CUDA activity: prints
    its wall, summed kernel time, busy share and the ``top`` kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CUDA]) as p:
        wall = timed(fn)
    rows = [e for e in p.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in rows)
    print(f"{label} profiled: wall {wall:.4f} s, kernel time {total_us / 1e6:.4f} s in "
          f"{sum(e.count for e in rows)} kernels, busy {total_us / 1e6 / wall:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x  {e.key[:90]}")
