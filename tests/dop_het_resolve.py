"""The DOP het map's group resolve in both packages, on the CPU: the
heterogeneous map of ``hybdrt_torch/utils/probe.py::make_het_map`` at a
small size (48 EIS spectra, 16 hybrid observations) with ``fit_dop=True``,
fitted by the JAX package's ``DRTMD.fit_all(batched=True)`` in float64, its
state carried into the port's map (``load_fit_state``), and the group
resolved windowed and coupled by both. Prints each form's IP iterations
(per window where windowed), the JAX package's and the port's walls, the
coupled KKT residual against its tolerance (a warning where it is above),
and max |dx| / max |x| between the packages' resolved coefficients.

Not a test (pytest collects ``test_*.py`` only); run

    python tests/dop_het_resolve.py

from the repository root on a machine with the JAX package (about six
minutes on one core).
"""
import copy
import sys
import time
import warnings
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD  # noqa: E402
from hybdrt_torch.mapping.drtmd import STATE_KEYS, load_fit_state  # noqa: E402
from hybdrt_torch.utils.probe import TAU_SUPER, make_het_map  # noqa: E402


def plain(v):
    if isinstance(v, dict):
        return {k: plain(u) for k, u in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(u) for u in v)
    if v is None or isinstance(v, (bool, int, float, str, np.ndarray)):
        return v
    return np.asarray(v)


def main():
    torch.set_num_threads(1)
    mt = make_het_map(48, 16, device="cpu", fit_dop=True)
    mj = JaxDRTMD(TAU_SUPER, psi_dim_names=["i"], warn=False, print_progress=False,
                  fit_dop=True, batch_fit_kw={"qp_max_iter": 20, "qp_max_iter_warm": 4})
    for i in range(mt.num_obs):
        mj.add_observation(mt.obs_psi[i], *mt.get_obs_data(i), group_id="g")
    t0 = time.time()
    mj.fit_all(batched=True)
    print(f"JAX fit_all(batched=True) of {mj.num_obs} observations: {time.time() - t0:.1f} s")
    mt = load_fit_state(mt, {k: plain(getattr(mj, k)) for k in STATE_KEYS})
    for form, kw in (("windowed", {"batched": True}), ("coupled", {"coupled": True})):
        rj = copy.deepcopy(mj)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.time()
            rj.resolve_group("g", psi_sort_dims=["i"], **kw)
            t_j = time.time() - t0
            t0 = time.time()
            mt.resolve_group("g", psi_sort_dims=["i"], **kw)
            t_t = time.time() - t0
        info = mt.resolve_info
        dx = np.max(np.abs(mt.obs_x_resolved - rj.obs_x_resolved)) \
            / np.max(np.abs(rj.obs_x_resolved))
        line = (f"{form} f64: JAX {t_j:.1f} s, port {t_t:.1f} s; IP iterations "
                f"{np.atleast_1d(info['n_iter']).tolist()}")
        if info["coupled"]:
            line += f"; KKT residual {info['kkt_residual']:.4g} (tolerance {info['kkt_tol']:.4g})"
        print(line + f"; max |dx| / max |x| between the packages {dx:.3g}; warnings "
              f"{sorted({str(w.message)[:60] for w in caught})}")


if __name__ == "__main__":
    main()
