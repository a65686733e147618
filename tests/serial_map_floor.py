"""The CPU's readings of ``chip_smoke.py`` phase 16b's and 16d's guards on
the serial het map: ``make_het_map(n_eis, n_hybrid)`` fitted by the port's
``fit_all()`` (serial, float64) and by ``fit_all(batched=True,
dtype=float64)`` with the DRT's own solver settings (``batch_fit_kw={}``),
on the CPU: the share of observations at the same iteration count, and of
those with obs_x within 1e-6 of max |x| as well (``SERIAL_SHARE_FLOOR``);
then the default (dense) resolve of group "g" against the batched windows:
max |dx| / max |x| (``DENSE_X_BOUND`` is 3x it), the objectives' relative
difference and the number of windows. Not a test (pytest collects
``test_*.py`` only); run

    python tests/serial_map_floor.py [n_eis n_hybrid]

from the repository root (default 48 16; about a minute on one core). The
last line is one JSON object.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hybdrt_torch.utils.probe import make_het_map, serial_batched_agreement  # noqa: E402


def main():
    torch.set_num_threads(1)
    n_eis, n_hybrid = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (48, 16)
    md = make_het_map(n_eis, n_hybrid, device="cpu")
    t0 = time.time()
    md.fit_all()
    t_serial = time.time() - t0
    mb = make_het_map(n_eis, n_hybrid, device="cpu")
    mb.batch_fit_kw = {}
    mb.fit_all(batched=True, dtype=torch.float64)
    same_it, share = serial_batched_agreement(md, mb)
    md.resolve_group("g", psi_sort_dims=["i"])
    xd, fd = md.obs_x_resolved.copy(), md.group_objective("g", psi_sort_dims=["i"])
    windows = md.resolve_info["windows"]
    md.resolve_group("g", psi_sort_dims=["i"], batched=True)
    xb, fb = md.obs_x_resolved.copy(), md.group_objective("g", psi_sort_dims=["i"])
    out = {"map": [n_eis, n_hybrid], "observations": md.num_obs, "serial_s": t_serial,
           "same_n_iter": same_it, "share": share,
           "shared_count": int(round(share * md.num_obs)),
           "dense_vs_batched_dx": float(np.max(np.abs(xd - xb)) / np.max(np.abs(xb))),
           "objective_rel": float((fd - fb) / abs(fb)), "dense_windows": windows}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
