"""The small maps whose serial ``fit_all()``
tests/test_torch_drtmd_serial.py and tests/test_torch_resolve_dense.py both
hold: the tests/test_mapping.py map of ten spectra ("ten") and
``probe.small_map("mixed")``, built unfitted for the JAX package's DRTMD and
the port's (``pair``); each module fits its own, float64 on the CPU. Not a
test module.
"""
import numpy as np

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_torch.mapping.drtmd import DRTMD
from hybdrt_torch.utils import probe

FREQ = np.logspace(5, -1, 41)
TAU_SUPER = np.logspace(-7, 2, 91)
PSIS = np.linspace(0, 1, 10)


def _zarc(f, r, tau0, a=0.9):
    return r / (1 + (2j * np.pi * f * tau0) ** a)


def ten_spectra():
    """tests/test_mapping.py:18-26."""
    rng = np.random.default_rng(0)
    out = []
    for p in PSIS:
        z = 0.3 + 0.2 * p + _zarc(FREQ, 1.0 + 0.5 * p, 10 ** (-3 + 2 * p))
        out.append(z + (rng.normal(size=len(FREQ)) + 1j * rng.normal(size=len(FREQ))) * 0.002)
    return out


def observations(kind):
    if kind == "ten":
        return TAU_SUPER, [([p], None, (FREQ, z)) for p, z in zip(PSIS, ten_spectra())]
    return probe.small_map(kind)


def pair(kind, **kw):
    """The JAX and the port's map of ``kind``, unfitted."""
    tau, obs = observations(kind)
    mj = JaxDRTMD(tau, psi_dim_names=["T"], warn=False, print_progress=False, **kw)
    mt = DRTMD(tau, psi_dim_names=["T"], warn=False, print_progress=False, device="cpu", **kw)
    for psi, c, e in obs:
        mj.add_observation(psi, c, e, group_id="g")
        mt.add_observation(psi, c, e, group_id="g")
    return mj, mt

