"""The small maps whose serial ``fit_all()`` tests/test_torch_drtmd_serial.py
holds, and resolves: the tests/test_mapping.py map of ten spectra ("ten") and
``probe.small_map("mixed")``, built unfitted for the JAX package's DRTMD and
the port's (``pair``); float64 on the CPU. Also ``jax_free_run``, the one
process without JAX in which the map modules' pickle tests read their
files. Not a test module.
"""
import subprocess
import sys
from pathlib import Path

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



ROOT = Path(__file__).resolve().parents[1]
JAX_FREE = ("jax", "jaxlib", "hybdrt_tpu")


def jax_free_run(parts, tmp_path, blocked=JAX_FREE):
    """Run each script of ``parts`` ({name: code}) in turn in one Python
    process started from the repository root, where the modules ``blocked``
    cannot be imported, whatever the scripts before it raised (one process
    start, which imports torch, instead of one a script). Returns {name:
    (ok, its standard output, its traceback or "")}."""
    runner = ["import contextlib, io, sys, traceback",
              f"for name in {tuple(blocked)!r}:",
              "    sys.modules[name] = None",
              f"for name, path in {[(n, str(tmp_path / f'{n}.py')) for n in parts]!r}:",
              "    out, err = io.StringIO(), ''",
              "    try:",
              "        with contextlib.redirect_stdout(out):",
              "            exec(compile(open(path).read(), path, 'exec'), {'__name__': name})",
              "    except BaseException:",
              "        err = traceback.format_exc()",
              "    with open(path + '.out', 'w') as f:",
              "        f.write(out.getvalue())",
              "    with open(path + '.err', 'w') as f:",
              "        f.write(err)"]
    for name, code in parts.items():
        (tmp_path / f"{name}.py").write_text(code)
    res = subprocess.run([sys.executable, "-c", "\n".join(runner)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = {}
    for name in parts:
        path = tmp_path / f"{name}.py"
        err = Path(f"{path}.err").read_text()
        out[name] = (not err, Path(f"{path}.out").read_text(), err)
    return out
