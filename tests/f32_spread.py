"""The float32 spread of the JAX package's own batched fits, on the CPU: the
bounds ``chip_smoke.py`` holds the card's float32 fits to, where they
exceed phase 5's. One configuration a run:

    python tests/f32_spread.py dop     # phase 18a's DOP fit (about ten minutes)
    python tests/f32_spread.py delta   # phase 19b's delta-basis batch (a few minutes)

from the repository root on a machine with the JAX package (times on one
core). Not a test (pytest collects ``test_*.py`` only).

Each configuration fits the first 64 spectra of a ``utils/probe.py`` batch
with the benchmark's knobs (``chip_smoke.FIT_KW``), plain and fused, in
float32 and float64, and prints the float32-vs-float64 spread of what its
phase reads (Rp median, p95 and max relative error, max |dR_inf|, the
functional fit), on all lanes and on the lanes that stop at the same
iteration in both precisions; then the same spread of the port's own fits on
the CPU (float32 through the kernels' plain versions), and the port's
float64 fit against the JAX package's. The last line is one JSON object.

* ``dop``: ``hybdrt_tpu.parallel.BatchedEISFitter(fit_dop=True)`` on
  ``make_dop_batch(8192, 71)``, with ``fit(z)``'s schedule and with
  ``adaptive="staged"`` (the one phase 18a runs; the port's fits take that
  one); also max |dx_dop| / max |x|.
* ``delta``: delta-basis EIS systems of ``make_batch(8192, 71)``. The JAX
  ``BatchedRaggedFitter`` fits the gaussian basis only (ROADMAP Queue 3
  item 27), so it is handed the systems: the first spectrum as the JAX
  package's ``DRT(tau_basis_type="delta")`` prepares it, each spectrum
  rescaled by its own data as the JAX ragged fitter's EIS fast path does
  (``_eis_rescale_batch``), passed in through its ``_prep_systems``; the
  port's fits take ``probe.eis_systems``. ``adaptive="staged"``.
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

import hybdrt_tpu  # noqa: E402
from hybdrt_tpu.parallel import BatchedEISFitter as JaxFitter  # noqa: E402
from hybdrt_tpu.parallel.ragged import BatchedRaggedFitter as JaxRagged  # noqa: E402
import hybdrt_torch  # noqa: E402
from hybdrt_torch.utils.probe import eis_systems, make_batch, make_dop_batch  # noqa: E402

# chip_smoke.FIT_KW, the benchmark's knobs (bench.py:458-483)
FIT_KW = dict(max_iter=50, qp_max_iter=20, qp_max_iter_warm=4, pred_stop=True, pred_rtol=3e-2)
LANES = 64


def spread(rp32, rp64, rinf32, rinf64, zrel, it32, it64, x_dop=None):
    """The float32-vs-float64 spread of two fits, as the phases read it:
    on all lanes and on the lanes at the same iteration count. ``zrel`` is
    each lane's functional-fit error, ``x_dop`` its max |dx_dop| / max |x|."""
    rel_rp = np.abs(rp32 - rp64) / np.abs(rp64)
    d_rinf = np.abs(np.asarray(rinf32) - np.asarray(rinf64))
    same = np.asarray(it32) == np.asarray(it64)
    out = {}
    for name, sel in (("all", np.ones(len(rp64), dtype=bool)), ("same", same)):
        out[name] = {"lanes": int(sel.sum()),
                     "rp_median": float(np.median(rel_rp[sel])),
                     "rp_p95": float(np.percentile(rel_rp[sel], 95)),
                     "rp_max": float(np.max(rel_rp[sel])),
                     "r_inf_max": float(np.max(d_rinf[sel])),
                     "z_max": float(np.max(zrel[sel]))}
        if x_dop is not None:
            out[name]["x_dop_max"] = float(np.max(x_dop[sel]))
    return out


def dop_spread(f32, f64, res32, res64, z):
    rp32, rp64 = f32.predict_r_p(res32), f64.predict_r_p(res64)
    zrel = np.max(np.abs(f32.predict_z(res32) - f64.predict_z(res64)), axis=1) \
        / np.max(np.abs(z), axis=1)
    xmax = np.max(np.abs(np.asarray(res64.x)), axis=1)
    x_dop = np.max(np.abs(np.asarray(res32.x_dop) - np.asarray(res64.x_dop)), axis=1) / xmax
    out = spread(rp32, rp64, res32.r_inf, res64.r_inf, zrel, res32.n_iter, res64.n_iter, x_dop)
    out["converged_f32"] = int(np.sum(res32.converged))
    out["converged_f64"] = int(np.sum(res64.converged))
    return out


def run_dop():
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
            out[label][f"jax_{sched}"] = dop_spread(fits["f32"][0], fits["f64"][0],
                                                    fits["f32"][1], fits["f64"][1], z)
            jax64 = fits["f64"][1]
            print(label, sched, json.dumps(out[label][f"jax_{sched}"]), flush=True)
        port = {name: hybdrt_torch.BatchedEISFitter(freq, fit_dop=True, dtype=dt, device="cpu",
                                                    **kw)
                for name, dt in (("f32", torch.float32), ("f64", torch.float64))}
        res = {name: p.fit(z, adaptive="staged") for name, p in port.items()}
        out[label]["port_cpu_staged"] = dop_spread(port["f32"], port["f64"], res["f32"],
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
    return out


def delta_fit(systems, dtype, fused, basis_tau=None):
    """(x, R_inf, final predictions, n_iter): the JAX ragged fit of
    ``systems``, or with ``basis_tau`` the port's on the CPU."""
    if basis_tau is None:
        fitter = JaxRagged(np.asarray(systems[0]["basis_tau"]), dtype=dtype, qp_fused=fused,
                           batch_bucket=False, **FIT_KW)
        fitter._prep_systems = lambda observations: systems
        res = fitter.fit([None] * len(systems), adaptive="staged")
    else:
        fitter = hybdrt_torch.BatchedRaggedFitter.from_systems(
            systems, basis_tau, device="cpu", dtype=dtype, qp_fused=fused, **FIT_KW)
        res = fitter.fit(adaptive="staged")
    y = np.asarray(fitter.final_predictions(res))
    return np.asarray(res.x), np.asarray(res.r_inf), y, np.asarray(res.n_iter)


def delta_spread(f32, f64):
    # the delta basis's area is 1: Rp is the coefficients' sum
    (x32, rinf32, y32, it32), (x64, rinf64, y64, it64) = f32, f64
    zrel = np.max(np.abs(y32 - y64), axis=1) / np.max(np.abs(y64), axis=1)
    return spread(np.sum(np.abs(x32), axis=1), np.sum(np.abs(x64), axis=1), rinf32, rinf64,
                  zrel, it32, it64)


def run_delta():
    freq, z = make_batch(8192, 71)
    z = z[:LANES]
    drt_j = hybdrt_tpu.DRT(tau_basis_type="delta", warn=False)
    tmpl = drt_j._qphb_fit_core(None, None, None, freq, z[0], prep_only=True)
    systems_j = JaxRagged._eis_rescale_batch(None, tmpl, list(z))
    drt_t = hybdrt_torch.DRT(tau_basis_type="delta", warn=False, device="cpu")
    systems_t = eis_systems(drt_t, freq, z)
    out = {}
    for fused in (False, True):
        label = "fused" if fused else "plain"
        j32, j64 = (delta_fit(systems_j, dt, fused) for dt in (jnp.float32, jnp.float64))
        out[f"jax {label}"] = delta_spread(j32, j64)
        t32, t64 = (delta_fit(systems_t, dt, fused, drt_t.basis_tau)
                    for dt in (torch.float32, torch.float64))
        out[f"port {label}"] = delta_spread(t32, t64)
        out[f"port vs jax f64 {label}"] = float(np.max(np.abs(t64[0] - j64[0]))
                                                / np.max(np.abs(j64[0])))
        for key in (f"jax {label}", f"port {label}"):
            print(key, json.dumps(out[key]), flush=True)
        print(f"port f64 against jax f64 ({label}): max |dx| / max |x| "
              f"{out[f'port vs jax f64 {label}']:.3g}", flush=True)
    return out


def main():
    runs = {"dop": run_dop, "delta": run_delta}
    if len(sys.argv) != 2 or sys.argv[1] not in runs:
        sys.exit(f"usage: python tests/f32_spread.py {'|'.join(runs)}")
    torch.set_num_threads(1)
    print(json.dumps(runs[sys.argv[1]]()))


if __name__ == "__main__":
    main()
