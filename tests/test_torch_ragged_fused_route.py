"""The ragged fitter's fused steps on per-lane systems against the TPU
kernel, #5's admission rule on the het map's padded systems, and the routing
of ``qp_fused`` from ``DRTMD(batch_fit_kw=...)``, on the CPU (the fused fits'
parity with the JAX package is in tests/test_torch_ragged_fused.py).

On the CPU the fused steps are ``ip_steps_lane``'s plain version. On the
first warm QP of a fused EIS fit (the per-lane systems as the loop hands
them over, padded columns included; a 34-point supergrid keeps the Pallas
interpret mode to seconds) that version and the TPU kernel
(``hybdrt_tpu/ops/pallas_ip_lane.py::ip_steps_lane``, Pallas interpret mode,
float32 only) take one step in float32, on the lanes whose corrector ratios
are both at most 1, where the TPU kernel's full-step rule (ROADMAP Queue 3
item 5) and the port's agree. These QPs are ill-conditioned, so two float32
factor orders part by far more than on tests/test_torch_ip_lane.py's seeded
problems: the kernel is held to the float64 step within 6x the plain
version's own float32-vs-float64 spread on each lane, Queue 3 item 12's
bound, which ``chip_smoke.py`` applies to the CUDA kernel (the measured
ratio is 0.86-1.11).

The map's fit with ``qp_fused`` is held bit for bit to the fused ragged fits
of its two halves.
"""
import numpy as np
import torch
import jax.numpy as jnp

from hybdrt_tpu.ops.pallas_ip_lane import ip_steps_lane as tpu_ip_steps_lane
from hybdrt_torch import BatchedRaggedFitter, DRTMD
from hybdrt_torch.ops import chol_lane, ip_lane, qp as qp_mod
from hybdrt_torch.utils import probe
from test_torch_ip_lane import _corrector_ratios

torch.set_num_threads(1)

FUSED = dict(qp_fused=True, qp_max_iter=20, qp_max_iter_warm=4)


def test_plain_steps_match_the_tpu_kernel_on_per_lane_systems(monkeypatch):
    obs, _ = probe.make_het_eis(8, 2)
    calls = []
    orig = qp_mod.ip_steps_lane

    def record(*args):
        calls.append([a.numpy().copy() for a in args[:6]])
        return orig(*args)

    monkeypatch.setattr(qp_mod, "ip_steps_lane", record)
    BatchedRaggedFitter(np.logspace(-8, 3, 34), device="cpu", **FUSED).fit(obs)
    a64 = calls[0]
    a32 = [a.astype(np.float32) for a in a64]
    want = ip_lane.ip_steps_lane(*(torch.as_tensor(a) for a in a64), 1)
    plain = ip_lane.ip_steps_lane(*(torch.as_tensor(a) for a in a32), 1)
    tpu = tpu_ip_steps_lane(*map(jnp.asarray, a32), n_steps=1, interpret=True)
    r_s, r_z = _corrector_ratios(*a64)
    clamp_free = (r_s <= 1) & (r_z <= 1)
    assert clamp_free.sum() >= 4
    for name, w, p, t in zip("xsz", want, plain, tpu):
        spread = np.abs(p.numpy() - w.numpy()).max(-1)
        err = np.abs(np.asarray(t) - w.numpy()).max(-1)
        assert np.all(err[clamp_free] <= 6 * spread[clamp_free] + 1e-6), name


def test_het_padded_systems_take_the_fused_kernel():
    """#5's admission rule (``ip_lane.admitted``, n <= 216 in float32 and
    152 in float64) against the padded n of the het map's EIS and hybrid
    batches: the het leg's fused QPs take the kernel, not the plain steps
    above its rule."""
    for obs, tau in (probe.make_het_eis(6, 2), probe.make_het_hybrid(6, 2)):
        fitter = BatchedRaggedFitter(tau, device="cpu", qp_fused=True)
        fitter.prepare(obs)
        n = fitter._uniq["rzm"].shape[2]
        assert n <= len(tau) + 5
        assert ip_lane.admitted(n, torch.float32) and ip_lane.admitted(n, torch.float64)
        assert qp_mod.fused_route(n, torch.float32) == "fused"


def test_padded_systems_above_the_rule_raise(monkeypatch):
    """A batch whose padded n exceeds #5's rule but not the lane kernels'
    (216 < n <= 268 in float32) no longer raises: its fused QPs run the
    same Mehrotra steps as a loop on the dispatching Cholesky routines
    (``qp.fused_route`` "fused_plain", counted in ``QP_ROUTES``), chosen by
    n before any launch, and never reach ``ip_steps_lane``."""
    tau = np.logspace(-8, 3, 276)
    obs, _ = probe.make_het_eis(3, 1)
    fitter = BatchedRaggedFitter(tau, device="cpu", dtype=torch.float32, qp_fused=True,
                                 max_iter=3)
    arrays = fitter._device_arrays(fitter.prepare(obs))
    n = arrays["rzm"].shape[2]
    assert chol_lane.admitted(n, torch.float32) and not ip_lane.admitted(n, torch.float32)
    assert qp_mod.fused_route(n, torch.float32) == "fused_plain"

    def refuse(*args):
        raise AssertionError("ip_steps_lane reached above its rule")

    monkeypatch.setattr(qp_mod, "ip_steps_lane", refuse)
    chol_lane.reset_launch_counts()
    res = fitter.fit(obs)
    assert chol_lane.QP_ROUTES["fused_plain"] > 0 and chol_lane.QP_ROUTES["library"] == 0
    assert np.all(np.isfinite(res.x))


def test_drtmd_routes_qp_fused_to_both_ragged_fits(monkeypatch):
    """``batch_fit_kw={"qp_fused": True}`` reaches the ragged fitter of
    each half of a mixed map (EIS on two grids, hybrid on two protocols),
    and each half's coefficients are bit for bit those of the fused ragged
    fit of its observations (whose parity with the JAX package
    tests/test_torch_ragged_fused.py holds)."""
    tau, obs = probe.small_map("mixed")
    md = DRTMD(tau, psi_dim_names=["T"], batch_fit_kw=FUSED, warn=False, device="cpu")
    for psi, c, e in obs:
        md.add_observation(psi, c, e, group_id="g")
    fused_fits = []
    orig = BatchedRaggedFitter.fit

    def fit(self, *a, **k):
        fused_fits.append(self.qp_fused)
        return orig(self, *a, **k)

    monkeypatch.setattr(BatchedRaggedFitter, "fit", fit)
    md.fit_all(batched=True)
    assert fused_fits == [True, True]
    assert md.obs_fit_status.all() and np.all(np.isfinite(md.obs_x))
    for hybrid in (False, True):
        idx = [i for i, (_, c, _) in enumerate(obs) if (c is not None) == hybrid]
        res = orig(BatchedRaggedFitter(tau, device="cpu", **FUSED), [obs[i][1:] for i in idx])
        for k, i in enumerate(idx):
            left, right = res.tau_indices[k]
            np.testing.assert_array_equal(md.obs_x[i, left:right], res.x[k][:right - left])
