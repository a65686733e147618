"""The float32 spread of the JAX package's own DOP fit, on the CPU: the
bounds that ``chip_smoke.py`` phase 18a holds the card's float32 DOP fit to.

Runs ``hybdrt_tpu.parallel.BatchedEISFitter(fit_dop=True)`` on the first 64
spectra of ``hybdrt_torch/utils/probe.py::make_dop_batch(8192, 71)`` with the
benchmark's knobs (``chip_smoke.FIT_KW``), plain and fused, in float32 and
float64, with ``fit(z)``'s schedule and with ``adaptive="staged"`` (the one
phase 18a runs), and prints the float32-vs-float64 spread of the quantities
phase 18a reads (Rp median, p95 and max relative error, max |dR_inf|, the
functional fit, max |dx_dop| / max |x|), on all lanes and on the lanes that
stop at the same iteration in both precisions; then the same spread of the
port's own staged fits on the CPU (float32 through the kernels' plain
versions against float64), and the port's float64 staged fit against the
JAX package's. Not a test (pytest collects ``test_*.py`` only); run

    python tests/dop_f32_spread.py

from the repository root on a machine with the JAX package (about ten minutes
on one core). The last line is one JSON object.
"""
import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter  # noqa: E402
import hybdrt_torch  # noqa: E402
from hybdrt_torch.utils.probe import make_dop_batch  # noqa: E402

# chip_smoke.FIT_KW, the benchmark's knobs (bench.py:458-483)
FIT_KW = dict(max_iter=50, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)
LANES = 64


def spread(f32, f64, res32, res64, z):
    """The float32-vs-float64 spread of two fits of ``z``, as phase 18a
    reads it: on all lanes and on the lanes at the same iteration count."""
    rp32, rp64 = f32.predict_r_p(res32), f64.predict_r_p(res64)
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)
    d_rinf = np.abs(np.asarray(res32.r_inf) - np.asarray(res64.r_inf))
    zrel = np.max(np.abs(f32.predict_z(res32) - f64.predict_z(res64)), axis=1) \
        / np.max(np.abs(z), axis=1)
    xmax = np.max(np.abs(np.asarray(res64.x)), axis=1)
    dop = np.max(np.abs(np.asarray(res32.x_dop) - np.asarray(res64.x_dop)), axis=1) / xmax
    same = np.asarray(res32.n_iter) == np.asarray(res64.n_iter)
    out = {}
    for name, sel in (("all", np.ones(len(z), dtype=bool)), ("same", same)):
        out[name] = {"lanes": int(sel.sum()),
                     "rp_median": float(np.median(rel_rp[sel])),
                     "rp_p95": float(np.percentile(rel_rp[sel], 95)),
                     "rp_max": float(np.max(rel_rp[sel])),
                     "r_inf_max": float(np.max(d_rinf[sel])),
                     "z_max": float(np.max(zrel[sel])),
                     "x_dop_max": float(np.max(dop[sel]))}
    out["converged_f32"] = int(np.sum(res32.converged))
    out["converged_f64"] = int(np.sum(res64.converged))
    return out


def main():
    torch.set_num_threads(1)
    freq, z = make_dop_batch(8192, 71)
    z = z[:LANES]
    out = {}
    for fused in (False, True):
        kw = dict(FIT_KW, qp_fused=fused)
        label = "fused" if fused else "plain"
        out[label] = {}
        jax64 = None
        for sched, fit_kw in (("default", {}), ("staged", {"adaptive": "staged"})):
            fits = {}
            for name, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
                f = JaxFitter(freq, fit_dop=True, dtype=dt, batch_bucket=False, **kw)
                fits[name] = (f, f.fit(z, **fit_kw))
            out[label][f"jax_{sched}"] = spread(fits["f32"][0], fits["f64"][0], fits["f32"][1],
                                                fits["f64"][1], z)
            jax64 = fits["f64"][1]
            print(label, sched, json.dumps(out[label][f"jax_{sched}"]), flush=True)
        # the port's own float32 fit on the CPU (the kernels' plain versions),
        # with the schedule the card runs
        port = {name: hybdrt_torch.BatchedEISFitter(freq, fit_dop=True, dtype=dt, device="cpu",
                                                    **kw)
                for name, dt in (("f32", torch.float32), ("f64", torch.float64))}
        res = {name: p.fit(z, adaptive="staged") for name, p in port.items()}
        out[label]["port_cpu_staged"] = spread(port["f32"], port["f64"], res["f32"],
                                               res["f64"], z)
        print(label, "port", json.dumps(out[label]["port_cpu_staged"]), flush=True)
        rp, rj = res["f64"], jax64
        xmax = np.max(np.abs(rj.x), axis=1)
        out[label]["port_f64_vs_jax_f64"] = {
            "same_n_iter": int(np.sum(rp.n_iter == np.asarray(rj.n_iter))),
            "x_max": float(np.max(np.max(np.abs(rp.x - rj.x), axis=1) / xmax)),
            "x_dop_max": float(np.max(np.max(np.abs(rp.x_dop - rj.x_dop), axis=1) / xmax))}
        print(label, "port_f64_vs_jax_f64", json.dumps(out[label]["port_f64_vs_jax_f64"]),
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
