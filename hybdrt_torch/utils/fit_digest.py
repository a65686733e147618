"""SHA-256 digests of the batched fit's results on the card, to show that two
checkouts fit bitwise alike.

Fits ``make_batch(8192, 71)`` (``utils/probe.py``, the benchmark's spectra)
with the benchmark's settings in float32 (``max_iter=50, qp_max_iter=20,
qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2``,
``fit(adaptive="staged")``), plain and with ``qp_fused=True``, and prints for
each the digest of ``x_raw``, ``n_iter`` and ``converged`` and the wall of a
second call. Everything (the package, its kernels and the inputs) comes from
the checkout ROOT (default: this one). Run from the repository root on a
machine with a CUDA card:

    python hybdrt_torch/utils/fit_digest.py [ROOT]

Run it for two checkouts on one card, parent, change, change, parent: equal
digests mean bitwise equal fits.
"""
import hashlib
import sys
import time
from pathlib import Path


def main():
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[2])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import hybdrt_torch
    from hybdrt_torch.utils.probe import make_batch

    if not Path(hybdrt_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {hybdrt_torch.__file__}, not the package of {root}")
    freq, z = make_batch(8192, 71)
    for fused in (False, True):
        fitter = hybdrt_torch.BatchedEISFitter(freq, dtype=torch.float32, max_iter=50,
                                               qp_max_iter=20, qp_max_iter_warm=4,
                                               pred_stop=True, pred_rtol=3e-2, qp_fused=fused)
        fitter.fit(z, adaptive="staged")
        torch.cuda.synchronize()
        t0 = time.time()
        res = fitter.fit(z, adaptive="staged")
        wall = time.time() - t0
        h = hashlib.sha256()
        for a in (res.x_raw, res.n_iter, res.converged):
            h.update(np.ascontiguousarray(a).tobytes())
        print(f"fit {'fused' if fused else 'plain'} (8192, 71) f32: {h.hexdigest()}  "
              f"wall {wall:.4f} s  root {root.name}")


if __name__ == "__main__":
    main()
