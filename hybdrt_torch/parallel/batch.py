"""Batched self-tuning QPHB fits of many EIS spectra on one frequency grid,
or of many hybrid (chrono + EIS) observations on one measurement protocol.

Counterpart of ``hybdrt_tpu/parallel/batch.py::BatchedEISFitter`` and
``BatchedHybridFitter``. The problem matrices are assembled once on the host
(``models/drt.py``) and uploaded to ``device``; the weight-initialization QP
and the outer loop run batched on the device, and ``collect`` brings the
coefficients back.
"""
from dataclasses import fields, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import preprocessing as pp
from ..models.drt import build_eis_problem, build_hybrid_problem
from ..ops import basis as basis_mod
from ..ops import mat1d, phasance
from ..solver import fitcore, qphb as qphb_mod
from ..utils.device import resolve_device


class BatchFitResult(NamedTuple):
    """Physical-units results for a batch of spectra (leading axis = batch).
    With collect="lazy", ``weights`` and ``s_vectors`` stay device tensors."""
    x: np.ndarray              # (B, n_tau) DRT coefficients
    r_inf: np.ndarray          # (B,)
    inductance: np.ndarray     # (B,)
    c_inv: np.ndarray          # (B,)
    x_dop: Optional[np.ndarray]  # (B, n_nu) with fit_dop, else None
    scale: np.ndarray          # (B,) coefficient scale per spectrum
    weights: object            # (B, 2*n_f) final data weights (scaled space)
    rho: np.ndarray            # (B, 3)
    s_vectors: object          # (B, 3, N)
    n_iter: np.ndarray         # (B,)
    converged: np.ndarray      # (B,)
    x_raw: np.ndarray          # (B, N) full scaled parameter vector
    dop_rho: Optional[np.ndarray] = None
    xmx_norms: Optional[np.ndarray] = None
    dop_xmx_norms: Optional[np.ndarray] = None


def _numpy(t):
    return t.detach().cpu().numpy()


# The state fields that collect="lazy" leaves on the device
_LAZY = ("weights", "s_vectors")


class BatchedEISFitter:
    """Self-tuning QPHB fits of many EIS spectra on a shared frequency grid.

    Usage:
        fitter = BatchedEISFitter(frequencies, dtype=torch.float32)
        result = fitter.fit(z_batch)           # z_batch: (B, n_freq) complex

    The fitter runs on the CUDA card unless ``device="cpu"`` is given, and
    raises ``RuntimeError`` where no card is present. ``qp_fused=True`` runs
    every warm-started QP as ``qp_max_iter_warm`` (default 8) fixed Mehrotra
    steps in one fused kernel call, after a cold iteration 0 (none in a frame
    fitted ``warm_from`` a previous one).

    With ``tau_supergrid`` the basis is the slice of that grid covering the
    data, and ``tau_indices`` is its (left, right) on the supergrid (the
    window a map stores the coefficients in, ``hybdrt_tpu/mapping/drtmd.py:735``).

    ``fit_dop=True`` adds the distribution of phasances (the default nu
    basis of 50 functions, ``result.x_dop``), ``fit_capacitance=True`` the
    inverse capacitance (``result.c_inv``), as in the JAX fitter.
    """

    def __init__(self, frequencies, basis_tau=None, tau_supergrid=None, fit_ohmic=True,
                 fit_inductance=True, fit_capacitance=False, fit_dop=False, nonneg=True,
                 dtype=torch.float64, device=None, max_iter=50, xtol=1e-2, qp_max_iter=60,
                 qp_max_iter_warm=None, iw_l1_lambda_0=1e-4, iw_l2_lambda_0=1e-4,
                 mesh=None, pred_stop=False, pred_rtol=1e-2, qp_fused=False, **hyper_kw):
        problem = build_eis_problem(frequencies, basis_tau=basis_tau,
                                    tau_supergrid=tau_supergrid, fit_ohmic=fit_ohmic,
                                    fit_inductance=fit_inductance, nonneg=nonneg,
                                    iw_l1_lambda_0=iw_l1_lambda_0,
                                    iw_l2_lambda_0=iw_l2_lambda_0,
                                    fit_capacitance=fit_capacitance, fit_dop=fit_dop,
                                    **hyper_kw)
        self._setup(problem, dtype=dtype, device=device, max_iter=max_iter, xtol=xtol,
                    qp_max_iter=qp_max_iter, qp_max_iter_warm=qp_max_iter_warm, mesh=mesh,
                    pred_stop=pred_stop, pred_rtol=pred_rtol, qp_fused=qp_fused)

    @classmethod
    def from_arrays(cls, problem, device=None, dtype=torch.float64, **fit_kw):
        """Fitter over a problem given as arrays: a dict with the keys that
        ``build_eis_problem`` returns (``frequencies``, ``rzm``, ``vmm``,
        ``m_stack``, ``l1v``, ``lb``, ``hypers``, ``iw_hypers``, ``cfg``,
        ``special_qp_params``, ``basis_tau``, ``tau_epsilon``,
        ``inductance_scale``; a capacitance fit's ``capacitance_scale``, a
        DOP fit's ``dop_gmat``, ``dop_scale_vector``, ``basis_nu``,
        ``nu_basis_type`` and ``nu_epsilon``, as a JAX fitter and its
        template hold them; the loop's dop_rho0 is ``hypers["dop_rho_0"]``).
        ``cfg`` may be a QPHBConfig or a dict of its fields. ``fit_kw`` are
        the constructor's loop options (max_iter, qp_max_iter, pred_stop,
        ...)."""
        self = cls.__new__(cls)
        problem = dict(problem)
        if not isinstance(problem["cfg"], qphb_mod.QPHBConfig):
            problem["cfg"] = qphb_mod.QPHBConfig(**dict(problem["cfg"]))
        self._setup(problem, dtype=dtype, device=device, **fit_kw)
        return self

    def _setup(self, problem, dtype=torch.float64, device=None, max_iter=50, xtol=1e-2,
               qp_max_iter=60, qp_max_iter_warm=None, mesh=None, pred_stop=False,
               pred_rtol=1e-2, qp_fused=False):
        if mesh is not None:
            raise NotImplementedError("mesh: multi-GPU sharding is not ported yet "
                                      "(ROADMAP Queue 1 item 10)")
        if qp_fused and qp_max_iter_warm is None:
            # The fused path runs the warm cap as its fixed step count
            # (hybdrt_tpu/parallel/batch.py:252-256)
            qp_max_iter_warm = 8
        self.device = resolve_device(device)
        self.dtype = dtype
        self.frequencies = np.asarray(problem["frequencies"], dtype=float)
        self.hypers = problem["hypers"]
        self.rp_scale = self.hypers.get("rp_scale", 14.0)
        self.cfg = problem["cfg"]
        if self.cfg.has_outlier:
            raise NotImplementedError("the outlier model is not ported yet "
                                      "(ROADMAP Queue 1 item 9)")
        self.num_special = self.cfg.num_special
        self.basis_tau = np.asarray(problem["basis_tau"], dtype=float)
        self.tau_epsilon = float(problem["tau_epsilon"])
        self.special_qp_params = problem["special_qp_params"]
        self.inductance_scale = problem["inductance_scale"]
        self._set_special_scales(problem)
        self.tau_supergrid = problem.get("tau_supergrid")
        self.tau_indices = None
        if self.tau_supergrid is not None:
            self.tau_indices = (pp.nearest_index(self.tau_supergrid, self.basis_tau[0]),
                                pp.nearest_index(self.tau_supergrid, self.basis_tau[-1]) + 1)
        # float64 host copies for the posterior (P, q) rebuild and param_cov's
        # refinement, which run in float64 whatever the fit's dtype
        # (hybdrt_tpu/mapping/drtmd.py:1036, hybdrt_tpu/parallel/batch.py:883-904)
        self.host_arrays = {k: np.array(problem[k], dtype=float)
                            for k in ("rzm", "m_stack", "l1v", "vmm", "lb")}

        cast = lambda a: torch.as_tensor(np.array(a, dtype=float), dtype=dtype,
                                         device=self.device)
        self.rzm = cast(problem["rzm"])
        self.vmm = cast(problem["vmm"])
        self.m_stack = cast(problem["m_stack"])
        self.l1v = cast(problem["l1v"])
        self.lb = cast(problem["lb"])
        self.hyp = qphb_mod.hypers_to_tensors(self.hypers, self.device, dtype)
        self.iw_hyp = qphb_mod.hypers_to_tensors(problem["iw_hypers"], self.device, dtype)
        # The DOP's order-0 smoothing matrices (hybdrt_tpu/parallel/batch.py:225-232)
        self.dop_gmat = None if problem.get("dop_gmat") is None \
            else cast(np.stack([np.asarray(g) for g in problem["dop_gmat"]]))
        self.fcfg = fitcore.FitConfig(cfg=self.cfg, max_iter=max_iter, x_rtol=xtol,
                                      qp_max_iter=qp_max_iter,
                                      qp_max_iter_warm=qp_max_iter_warm,
                                      pred_stop=bool(pred_stop), pred_rtol=float(pred_rtol),
                                      qp_fused=bool(qp_fused))

    def _set_special_scales(self, problem):
        """The capacitance's and the DOP's column scales and nu basis (None
        where not fitted)."""
        self.capacitance_scale = problem.get("capacitance_scale")
        dsv = problem.get("dop_scale_vector")
        self.dop_scale_vector = None if dsv is None else np.asarray(dsv, dtype=float)
        self.basis_nu = None if problem.get("basis_nu") is None \
            else np.asarray(problem["basis_nu"], dtype=float)
        self.nu_basis_type = problem.get("nu_basis_type", "gaussian")
        self.nu_epsilon = problem.get("nu_epsilon")

    def _dop_kw(self):
        """The loop's DOP keyword: the smoothing matrices of a DOP fit."""
        return {} if self.dop_gmat is None else {"dop_gmat": self.dop_gmat}

    # ------------------------------------------------------------------
    def _loop_inputs(self, rzv):
        """Weight initialization + initial per-lane state inputs for
        fitcore.qphb_fit_loop (hybdrt_tpu/parallel/batch.py:118)."""
        cfg = self.cfg
        b, n = rzv.shape[0], self.rzm.shape[1]
        rho0 = self.hyp["rho_0"]
        dop_rho0 = self.hyp.get("dop_rho_0")
        if dop_rho0 is None:
            dop_rho0 = torch.ones(cfg.k_range, dtype=self.dtype, device=self.device)
        s0 = torch.stack([torch.full((n,), float(self.hypers["s_0"][i]), dtype=self.dtype,
                                     device=self.device) for i in range(cfg.k_range)])
        est, init_w, _, out_t = qphb_mod.initialize_weights(
            self.iw_hyp, self.m_stack, rho0, s0, rzv, self.rzm, self.vmm, self.lb, cfg,
            dop_rho_vector=dop_rho0)
        x0 = torch.full((b, n), 1e-6, dtype=self.dtype, device=self.device)
        lanes = lambda t: t.expand(b, *t.shape).clone()
        return dict(x0=x0, s0=lanes(s0), rho0=lanes(rho0), dop_rho0=lanes(dop_rho0),
                    init_weights=init_w, est_weights=est, outlier_t0=out_t)

    def _loop_args(self, rzv):
        """The positional arguments of fitcore.qphb_fit_loop and qphb_fit_scan."""
        inp = self._loop_inputs(rzv)
        return (self.rzm, rzv, self.vmm, self.m_stack, self.l1v, self.lb, self.hyp, inp["x0"],
                inp["s0"], inp["rho0"], inp["dop_rho0"], inp["init_weights"],
                inp["est_weights"], inp["outlier_t0"], self.fcfg)

    def _fit_plain(self, rzv):
        """Every lane in one loop; the loop steps only the lanes still live."""
        return fitcore.qphb_fit_loop(*self._loop_args(rzv), **self._dop_kw())

    def _fit_history(self, rzv):
        """(final states, history) of fitcore.qphb_fit_scan
        (``_fit_single_history``, hybdrt_tpu/parallel/batch.py:274)."""
        return fitcore.qphb_fit_scan(*self._loop_args(rzv), **self._dop_kw())

    # ------------------------------------------------------------------
    # Frame-to-frame warm starts (fit(warm_from=...), hybdrt_tpu/parallel/
    # batch.py:343-400): operando and time-series maps fit the same lanes
    # every frame, drifting slowly. Each lane's solver state (x, the penalty
    # scales s and rho, the penalty norms) is seeded from the previous
    # frame's fit and the loop runs in continuation mode; the data weights
    # are estimated afresh from this frame's data.
    def _warm_fcfg(self):
        return replace(self.fcfg, continue_mode=True)

    def _fit_warm(self, rzv, warm):
        """Every lane seeded from ``warm`` (``_warm_arrays``), in one loop that
        steps only the lanes still live (``_fit_single_warm``, :356-382).
        No iteration is peeled off cold: with qp_fused every QP of the loop,
        iteration 0 included, runs the fused steps from the seed iterate and
        zero duals; without it iteration 0's QP starts cold, as in a fresh
        fit."""
        fcfg = self._warm_fcfg()
        inp = self._loop_inputs(rzv)
        x0, s0, rho0, dop_rho0, xmx0, dop_xmx0 = warm
        b = rzv.shape[0]
        state0 = qphb_mod.QPHBState(
            x=x0, s_vectors=s0, rho_vector=rho0, dop_rho_vector=dop_rho0,
            weights=inp["init_weights"], outlier_t=inp["outlier_t0"], xmx_norms=xmx0,
            dop_xmx_norms=dop_xmx0, it=torch.zeros(b, dtype=torch.int32, device=self.device),
            converged=torch.zeros(b, dtype=torch.bool, device=self.device),
            qp_dual=torch.zeros_like(x0))
        return fitcore.qphb_fit_loop_from_state(
            state0, self.rzm, rzv, self.vmm, self.m_stack, self.l1v, self.lb, self.hyp,
            inp["est_weights"], fcfg, seed_pred_history=fcfg.pred_stop, **self._dop_kw())

    def _warm_arrays(self, warm_from, b, scale):
        """Per-lane seed tensors from a previous frame's BatchFitResult (this
        package's, lazy or full, or the JAX package's), on this fitter's
        device in its dtype: [x, s_vectors, rho, dop_rho, xmx_norms,
        dop_xmx_norms] (:384-400). x is rescaled from the old frame's lane
        scales to the new ones, over the whole vector, special columns
        included: the loop's x is the physical solution divided by the lane
        scale. The cast to this fitter's dtype here is the only one: a
        float64 seed's norms, held fixed by continuation mode, enter a
        float32 fit rounded once."""
        prev_x = np.asarray(warm_from.x_raw)
        if prev_x.shape[0] != b:
            raise ValueError(f"warm_from has {prev_x.shape[0]} lanes; this batch has {b} "
                             f"(warm seeding is lane-aligned: fit the same observations in "
                             f"the same order each frame)")
        ratio = np.asarray(warm_from.scale) / np.asarray(scale)

        def on_device(a):
            # a lazy seed's s_vectors is a tensor already: no host round trip
            if isinstance(a, torch.Tensor):
                return a.to(device=self.device, dtype=self.dtype)
            return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

        return [on_device(a) for a in (prev_x * ratio[:, None], warm_from.s_vectors,
                                        warm_from.rho, warm_from.dop_rho, warm_from.xmx_norms,
                                        warm_from.dop_xmx_norms)]

    # ------------------------------------------------------------------
    def scale_batch(self, z_batch):
        """Per-spectrum Rp estimate and scaling (hybdrt_tpu/parallel/batch.py:612)."""
        z_batch = np.asarray(z_batch)
        rp_est = np.max(z_batch.real, axis=1) - np.min(z_batch.real, axis=1)
        scale = rp_est / self.rp_scale
        z_scaled = z_batch / scale[:, None]
        rzv = np.concatenate([z_scaled.real, z_scaled.imag], axis=1)
        return rzv, scale

    def fit(self, z_batch, return_states=False, adaptive=False, phase_budgets=None,
            return_history=False, warm_from=None, collect="full"):
        """Fit a (B, n_freq) batch of complex spectra; returns BatchFitResult.

        adaptive=False, True and "staged" all run every lane in one loop that
        steps only the lanes still live, so no lane waits on another, and
        their results are bitwise the same. The JAX package's compaction
        schedules (host-driven for True, one dispatch for "staged") existed
        because a vmapped while_loop runs every lane to the slowest one;
        this loop needs none, so ``phase_budgets``, which budgets those
        schedules, raises ValueError. collect="lazy" leaves result.weights
        and result.s_vectors as device tensors, each its own allocation.

        return_history=True also records every iteration's state
        (``fitcore.qphb_fit_scan``, the batched qphb_history) and returns
        (result, history), or (result, states, history) with
        return_states: a dict of numpy arrays of shape (B, max_iter, ...)
        whose entries after a lane stops repeat its final state (mask with
        history['it']). Without qp_fused it runs the same loop as a plain
        fit, so the result is bitwise that fit's; with qp_fused its QPs run
        unfused, as the JAX package's history scan runs them. It combines
        with neither adaptive, collect="lazy" nor warm_from.

        warm_from=<the previous frame's BatchFitResult> seeds each lane's
        solver state from that frame's fit and runs the loop in continuation
        mode (penalty norms held at the seed's, at least ``min_iter``
        iterations); the lanes must be the same observations in the same
        order. Results agree with a cold fit to the solver's tolerance, not
        bitwise. It combines with neither ``adaptive`` nor
        ``return_history``: a frame is ``fit(z, warm_from=prev,
        collect="lazy")``."""
        self._check_options(adaptive, collect)
        if warm_from is not None and (adaptive or return_history):
            raise ValueError("warm_from seeds a plain whole-batch fit; it cannot be combined "
                             "with adaptive scheduling or return_history")
        if phase_budgets is not None:
            raise ValueError("phase_budgets: this fitter has no compaction schedule to budget; "
                             "every adaptive mode runs the live-lane loop")
        if return_history and adaptive:
            raise ValueError("return_history records a whole-batch fit; use it without "
                             "adaptive scheduling")
        if collect == "lazy" and (return_states or return_history):
            raise ValueError("collect='lazy' cannot be combined with return_states or "
                             "return_history: they return every field in full")
        rzv, scale = self.scale_batch(self._check_batch(z_batch))
        warm = None if warm_from is None else self._warm_arrays(warm_from, len(scale), scale)
        rzv = torch.as_tensor(rzv, dtype=self.dtype, device=self.device)
        if return_history:
            states, history = self._fit_history(rzv)
            out = self.collect(states, scale, return_states=return_states)
            return (*out, history) if return_states else (out, history)
        states = self._fit_plain(rzv) if warm is None else self._fit_warm(rzv, warm)
        return self.collect(states, scale, return_states=return_states,
                            lazy=(collect == "lazy"))

    @staticmethod
    def _check_options(adaptive, collect):
        if collect not in ("full", "lazy"):
            raise ValueError(f"collect={collect!r}: expected 'full' or 'lazy'")
        if not (adaptive is False or adaptive is True
                or (isinstance(adaptive, str) and adaptive == "staged")):
            raise ValueError(f"adaptive={adaptive!r}: expected False, True or 'staged'")

    def _check_batch(self, z_batch):
        z_batch = np.asarray(z_batch)
        if z_batch.ndim != 2 or z_batch.shape[1] != len(self.frequencies):
            raise ValueError(f"z_batch shape {z_batch.shape}: expected (B, "
                             f"{len(self.frequencies)})")
        return z_batch

    # ------------------------------------------------------------------
    # Streams of batches (hybdrt_tpu/parallel/batch.py:749-804): an operando
    # or mapping user fits batch after batch. The fit loop drives the card
    # from the host, one sync per pass, so what a second CUDA stream can take
    # off the loop's way is the copies: batch k+1's upload and batch k-1's
    # readback run on a side stream, through pinned host memory, while batch
    # k's loop runs on the caller's stream.
    def fit_stream(self, z_batches, adaptive="staged", collect="lazy"):
        """A generator over an iterable of (B, n_freq) complex batches that
        yields one BatchFitResult per batch, in input order, each bitwise
        what ``fit(z, adaptive=adaptive, collect=collect)`` returns for that
        batch. Batches may differ in size.

        On a CUDA device, batch k+1 is scaled on the host and uploaded from
        pinned memory on a side stream, and batch k-1's fields are read back
        into pinned memory on the side stream, both while batch k's loop
        runs on the caller's current stream; a result is yielded once the
        next batch's loop has run (the last one at the end).

        With collect="lazy" (the default) each result keeps its weights
        (B, 2 n_freq) and s_vectors (B, 3, N) on the device, each its own
        allocation, (2 n_freq + 3 N) B itemsize bytes (13.8 MB at B = 8192,
        71 frequencies, N = 93, float32), until the caller drops it; the
        generator keeps nothing of a batch once it has yielded its result.
        A consumer that stops early (``break``, ``close()``) leaves no copy
        in flight. A batch that fails its shape check, or an input iterable
        that raises, raises out of the generator once the results of the
        batches before it are yielded. adaptive may be False or "staged"
        (the same loop); adaptive=True raises ValueError, as in the JAX
        package."""
        self._check_options(adaptive, collect)
        if adaptive is True:
            raise ValueError("adaptive=True: fit_stream takes False or 'staged' (the same loop)")
        return self._stream(iter(z_batches), collect == "lazy")

    def _stream(self, batches, lazy):
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        err = None
        try:
            nxt = self._stream_upload(next(batches, None), side)
            # the one batch fitted and not yet yielded: [(states, scale)]; no
            # name of this frame holds a batch once its result is yielded
            prev = []
            while nxt is not None:
                rzv, scale, ready = nxt
                fetch = [self._stream_fetch(*prev.pop(), lazy, side)] if prev else []
                if ready is not None:
                    torch.cuda.current_stream(self.device).wait_event(ready)
                try:
                    nxt = self._stream_upload(next(batches, None), side)
                except Exception as e:  # raised once the batches before it are yielded
                    nxt, err = None, e
                prev.append((self._fit_plain(rzv), scale))
                del rzv, ready
                if fetch:
                    yield self._stream_result(*fetch.pop(), lazy)
            if prev:
                yield self._stream_result(*self._stream_fetch(*prev.pop(), lazy, side), lazy)
            if err is not None:
                raise err
        finally:
            if side is not None:
                side.synchronize()

    def _stream_upload(self, z_batch, side):
        """(rzv on the device, scale, event the upload completes, or None)."""
        if z_batch is None:
            return None
        rzv, scale = self.scale_batch(self._check_batch(z_batch))
        host = torch.from_numpy(rzv).to(self.dtype)
        if side is None:
            return host.to(self.device), scale, None
        host = host.pin_memory()
        with torch.cuda.stream(side):
            rzv = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            rzv.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        # allocated on the side stream, read on the caller's
        rzv.record_stream(torch.cuda.current_stream(self.device))
        return rzv, scale, ready

    def _stream_fetch(self, states, scale, lazy, side):
        """Start the readback of every state field (but the lazy ones with
        ``lazy``) into pinned host memory on the side stream, behind the
        caller's stream; returns (states, scale, {field: pinned tensor},
        event the copies complete). ``states`` stays referenced until the
        event: the copies read its tensors."""
        if side is None:
            return states, scale, {}, None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        side.wait_event(done)
        host = {}
        with torch.cuda.stream(side):
            for f in fields(states):
                t = getattr(states, f.name)
                if t is not None and not (lazy and f.name in _LAZY):
                    host[f.name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host[f.name].copy_(t, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return states, scale, host, copied

    def _stream_result(self, states, scale, host, copied, lazy):
        """collect() of a fetched batch: the lazy fields from the device, the
        others from their host copies, moved out of pinned memory."""
        if copied is not None:
            copied.synchronize()
            states = replace(states, **{f: t.clone() for f, t in host.items()})
        return self.collect(states, scale, lazy=lazy)

    def collect(self, states, scale, return_states=False, lazy=False):
        """Per-lane states -> BatchFitResult in physical units."""
        x_full = _numpy(states.x)
        scale = np.asarray(scale)
        ns = self.num_special
        sp = self.special_qp_params

        def special(name, col_scale=1.0):
            if name in sp:
                return x_full[:, sp[name]["index"]] * scale * col_scale
            return np.zeros(len(scale))

        x_dop = None
        if self.cfg.fit_dop:
            ds_, de_ = self.cfg.dop_start, self.cfg.dop_start + self.cfg.dop_size
            x_dop = x_full[:, ds_:de_] * self.dop_scale_vector[None, :] * scale[:, None]
        result = BatchFitResult(
            x=x_full[:, ns:] * scale[:, None],
            r_inf=special("R_inf"),
            inductance=special("inductance", self.inductance_scale or 1.0),
            c_inv=special("C_inv", self.capacitance_scale or 1.0),
            x_dop=x_dop,
            scale=scale,
            weights=states.weights if lazy else _numpy(states.weights),
            rho=_numpy(states.rho_vector),
            s_vectors=states.s_vectors if lazy else _numpy(states.s_vectors),
            n_iter=_numpy(states.it),
            converged=_numpy(states.converged),
            x_raw=x_full,
            dop_rho=_numpy(states.dop_rho_vector),
            xmx_norms=_numpy(states.xmx_norms),
            dop_xmx_norms=_numpy(states.dop_xmx_norms),
        )
        if return_states:
            return result, states
        return result

    # ------------------------------------------------------------------
    def param_cov(self, result, z_batch, scaled=False, refine_iters=0):
        """Laplace parameter covariance per spectrum
        (hybdrt_tpu/parallel/batch.py:858-969): the inverse of the posterior
        precision P, rebuilt in float64 from each lane's final (rho, s,
        weights) by ``calculate_pq``. Runs on the fitter's device in float64
        whatever the fit's dtype; ``result`` may be this package's (lazy or
        full) or the JAX package's BatchFitResult, and ``z_batch`` the
        spectra it was fitted to.

        ``refine_iters > 0`` first continues each lane in float64 for exactly
        that many outer iterations from its final state (continuation mode,
        ``max_iter = min_iter = 1 + refine_iters``, no ``pred_stop``, the
        state at ``it = 1`` with zero duals, the lane's own weights as the
        weight estimate), washing float32 drift out of the state P is built
        from. Its QPs run ``qp_max_iter`` unfused Mehrotra steps from the
        lane's x on every fitter: a qp_fused fitter runs them warm without
        a step count to fuse (``qp_max_iter_warm=None``), as in the JAX
        package, which makes them the same QPs as a plain fitter's.

        Returns a float64 numpy array (B, N, N), in physical units unless
        ``scaled=True``: each row and column times the lane's scale, the
        inductance's, capacitance's and DOP's also times their column
        scales, as ``DRT.estimate_param_cov``."""
        p, _, scale = self._posterior(result, z_batch, refine_iters)
        cov = torch.linalg.inv(p)
        if not scaled:
            dev, f64 = self.device, torch.float64
            col = torch.ones(cov.shape[-1], dtype=f64, device=dev)
            sp = self.special_qp_params
            if "inductance" in sp:
                col[sp["inductance"]["index"]] = self.inductance_scale
            if "C_inv" in sp:
                col[sp["C_inv"]["index"]] = self.capacitance_scale
            if "x_dop" in sp:
                i0 = sp["x_dop"]["index"]
                col[i0:i0 + sp["x_dop"]["size"]] = torch.as_tensor(self.dop_scale_vector,
                                                                  dtype=f64, device=dev)
            sv = torch.as_tensor(scale, dtype=f64, device=dev)[:, None] * col[None, :]
            cov = cov * sv[:, :, None] * sv[:, None, :]
        return cov.cpu().numpy()

    def _host_tensors(self):
        """``host_arrays`` on the fitter's device in float64."""
        return {k: torch.as_tensor(v, dtype=torch.float64, device=self.device)
                for k, v in self.host_arrays.items()}

    def _posterior(self, result, z_batch, refine_iters=0):
        """(P (B, N, N), q (B, N), scale): each lane's weighted QP at its
        final state, float64 on the fitter's device (``posterior_pq``) for
        the spectra ``z_batch`` it was fitted to. P is the scaled-space
        posterior precision that param_cov inverts."""
        rzv, scale = self.scale_batch(self._check_batch(z_batch))
        p, q = self.posterior_pq(rzv, result, refine_iters)
        return p, q, scale

    def _final_design(self, h, result):
        """The design of each lane's last QP: the shared one."""
        return h["rzm"]

    def posterior_pq(self, rzv, result, refine_iters=0):
        """(P (B, N, N), q (B, N)): each lane's weighted QP at its final
        state, float64 on the fitter's device, built from the scaled data
        ``rzv`` (B, M) and the result's rho, s_vectors and weights (device
        tensors with collect="lazy"; any object with these fields) or from
        their refinement's (drtmd.py:1036, :1238)."""
        dev, f64 = self.device, torch.float64
        hyp = qphb_mod.hypers_to_tensors(self.hypers, dev, f64)
        h = self._host_tensors()

        def t(a):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=f64)
            return torch.as_tensor(np.array(a, dtype=float), dtype=f64, device=dev)

        rzv = t(rzv)
        b, k_range = rzv.shape[0], self.cfg.k_range
        opt = lambda a: torch.ones(b, k_range, dtype=f64, device=dev) if a is None else t(a)
        rho, s, w = t(result.rho), t(result.s_vectors), t(result.weights)
        dop_rho = opt(getattr(result, "dop_rho", None))
        if refine_iters > 0:
            # the JAX refinement runs without the DOP smoothing matrices
            # (hybdrt_tpu/parallel/batch.py:919-925)
            x = t(result.x_raw)
            state = qphb_mod.QPHBState(
                x=x, s_vectors=s, rho_vector=rho, dop_rho_vector=dop_rho,
                weights=w, outlier_t=torch.ones_like(rzv), xmx_norms=opt(result.xmx_norms),
                dop_xmx_norms=opt(result.dop_xmx_norms),
                it=torch.ones(b, dtype=torch.int32, device=dev),
                converged=torch.zeros(b, dtype=torch.bool, device=dev),
                qp_dual=torch.zeros_like(x))
            fcfg = replace(self.fcfg, max_iter=1 + refine_iters, continue_mode=True,
                           min_iter=1 + refine_iters, pred_stop=False, qp_max_iter_warm=None)
            st = fitcore.qphb_fit_loop_from_state(
                state, h["rzm"], rzv, h["vmm"], h["m_stack"], h["l1v"], h["lb"], hyp, w, fcfg)
            rho, s, w, dop_rho = st.rho_vector, st.s_vectors, st.weights, st.dop_rho_vector
        else:
            h["rzm"] = self._final_design(h, result)
        return qphb_mod.calculate_pq(h["rzm"], rzv, h["m_stack"], hyp, h["l1v"], rho, s, w,
                                     self.cfg, dop_rho_vector=dop_rho)

    def predict_r_p(self, result: BatchFitResult):
        area = basis_mod.get_basis_func_area("gaussian", self.tau_epsilon)
        return np.sum(np.abs(np.asarray(result.x)), axis=1) * area

    def predict_z(self, result: BatchFitResult, frequencies=None):
        """Batched impedance prediction from fitted parameters (host numpy)."""
        if frequencies is None:
            frequencies = self.frequencies
        frequencies = np.asarray(frequencies, dtype=float)
        zm = mat1d.construct_impedance_matrix(frequencies, "real", self.basis_tau,
                                              epsilon=self.tau_epsilon) \
            + 1j * mat1d.construct_impedance_matrix(frequencies, "imag", self.basis_tau,
                                                    epsilon=self.tau_epsilon)
        z = np.asarray(result.x) @ zm.T
        z = z + result.r_inf[:, None]
        z = z + result.inductance[:, None] * 2j * np.pi * frequencies[None, :]
        if self.cfg.fit_dop and result.x_dop is not None:
            zm_dop = phasance.construct_phasor_z_matrix(frequencies, self.basis_nu,
                                                        self.nu_basis_type, self.nu_epsilon)
            z = z + np.asarray(result.x_dop) @ zm_dop.T
        return z


class BatchedHybridFitter:
    """Self-tuning QPHB fits of many hybrid (chrono + EIS) observations that
    share one measurement protocol: one time grid, one input signal (so one
    step sequence) and one frequency grid, the DRT mapping acquisition
    pattern (``hybdrt_tpu/parallel/batch.py:1005``).

    Usage:
        fitter = BatchedHybridFitter(times, i_signal, freq, dtype=torch.float32)
        result = fitter.fit(v_batch, z_batch)  # (B, n_times), (B, n_freq)

    The design, penalty, variance and vz-offset structures are built once
    (``build_hybrid_problem``), with the vz-offset column zero; the weight
    initialization and the loop, with its per-pass vz-offset column rewrite,
    run batched on the device. Galvanostatic mode and ideal steps. The
    fitter runs on the CUDA card unless ``device="cpu"`` is given.
    ``qp_fused=True`` runs every warm-started QP as ``qp_max_iter_warm``
    (default 8) fixed Mehrotra steps in one fused kernel call, after a cold
    iteration 0. Results are ``BatchFitResult``s: ``x``, ``r_inf`` and
    ``inductance`` in physical units; the baseline and vz-offset columns are
    in ``x_raw``.
    """

    def __init__(self, times, i_signal, frequencies, step_times=None, step_sizes=None,
                 basis_tau=None, tau_supergrid=None, fit_ohmic=True, fit_inductance=True,
                 nonneg=True, vz_offset=True, dtype=torch.float64, device=None, max_iter=50,
                 xtol=1e-2, qp_max_iter=60, qp_max_iter_warm=None, mesh=None, pred_stop=False,
                 pred_rtol=1e-2, qp_fused=False, **hyper_kw):
        if "batch_bucket" in hyper_kw:
            raise TypeError("batch_bucket is not taken: it padded the batch only so that XLA "
                            "would not recompile, and nothing here compiles per shape")
        problem = build_hybrid_problem(times, i_signal, frequencies, step_times=step_times,
                                       step_sizes=step_sizes, basis_tau=basis_tau,
                                       tau_supergrid=tau_supergrid, fit_ohmic=fit_ohmic,
                                       fit_inductance=fit_inductance, nonneg=nonneg,
                                       vz_offset=vz_offset, **hyper_kw)
        self._setup(problem, dtype=dtype, device=device, max_iter=max_iter, xtol=xtol,
                    qp_max_iter=qp_max_iter, qp_max_iter_warm=qp_max_iter_warm, mesh=mesh,
                    pred_stop=pred_stop, pred_rtol=pred_rtol, qp_fused=qp_fused)

    @classmethod
    def from_arrays(cls, problem, device=None, dtype=torch.float64, **fit_kw):
        """Fitter over a problem given as arrays: a dict with the keys that
        ``build_hybrid_problem`` returns, as numpy arrays (a JAX
        ``BatchedHybridFitter``'s arrays and its template's metadata carry
        over as they are). ``cfg`` may be a QPHBConfig or a dict of its
        fields. ``fit_kw`` are the constructor's loop options."""
        self = cls.__new__(cls)
        problem = dict(problem)
        if not isinstance(problem["cfg"], qphb_mod.QPHBConfig):
            problem["cfg"] = qphb_mod.QPHBConfig(**dict(problem["cfg"]))
        self._setup(problem, dtype=dtype, device=device, **fit_kw)
        return self

    def _setup(self, problem, dtype=torch.float64, device=None, max_iter=50, xtol=1e-2,
               qp_max_iter=60, qp_max_iter_warm=None, mesh=None, pred_stop=False,
               pred_rtol=1e-2, qp_fused=False):
        if mesh is not None:
            raise NotImplementedError("mesh: multi-GPU sharding is not ported yet "
                                      "(ROADMAP Queue 1 item 10)")
        if qp_fused and qp_max_iter_warm is None:
            qp_max_iter_warm = 8
        self.device = resolve_device(device)
        self.dtype = dtype
        self.times = np.asarray(problem["times"], dtype=float)
        self.i_signal = np.asarray(problem["i_signal"], dtype=float)
        self.frequencies = np.asarray(problem["frequencies"], dtype=float)
        self.step_times = np.atleast_1d(np.asarray(problem["step_times"], dtype=float))
        self.step_sizes = np.atleast_1d(np.asarray(problem["step_sizes"], dtype=float))
        self.hypers = problem["hypers"]
        self.rp_scale = problem["rp_scale"]
        self.cfg = problem["cfg"]
        if self.cfg.fit_dop or "C_inv" in problem["special_qp_params"]:
            raise ValueError("BatchedHybridFitter fits neither DOP nor capacitance, as in the "
                             "JAX package, whose DRTMD routes such hybrid fits to the ragged "
                             "fitter (BatchedRaggedFitter)")
        if self.cfg.has_outlier:
            raise NotImplementedError("the outlier model is not ported yet "
                                      "(ROADMAP Queue 1 item 9)")
        self.num_special = self.cfg.num_special
        self.num_chrono = int(problem["num_chrono"])
        self.vz_index = int(problem["vz_index"])
        self.vz_offset = self.vz_index >= 0
        self.basis_tau = np.asarray(problem["basis_tau"], dtype=float)
        self.tau_epsilon = float(problem["tau_epsilon"])
        self.special_qp_params = problem["special_qp_params"]
        self.inductance_scale = problem["inductance_scale"]
        self._set_special_scales(problem)
        self.dop_gmat = None
        self.input_signal_scale = float(problem["input_signal_scale"])
        self.v_baseline_scale = problem.get("v_baseline_scale")

        cast = lambda a: torch.as_tensor(np.array(a, dtype=float), dtype=dtype,
                                         device=self.device)
        self.rzm = cast(problem["rzm"])
        self.vmm = cast(problem["vmm"])
        self.m_stack = cast(problem["m_stack"])
        self.l1v = cast(problem["l1v"])
        self.lb = cast(problem["lb"])
        self.hyp = qphb_mod.hypers_to_tensors(self.hypers, self.device, dtype)
        self.iw_hyp = qphb_mod.hypers_to_tensors(problem["iw_hypers"], self.device, dtype)
        # The vz-offset column's sources (hybdrt_tpu/solver/fitcore.py:166-175);
        # the loop signs it by the chrono/EIS split of fcfg.num_chrono
        self.hybrid = {}
        if self.vz_offset:
            self.hybrid = dict(rzm_vz=cast(problem["rzm_vz"]),
                               vz_strength=cast(problem["vz_strength_vec"]))
        # float64 host copies for the posterior (P, q) rebuild
        self.host_arrays = {k: np.array(problem[k], dtype=float)
                            for k in ("rzm", "m_stack", "l1v", "vmm", "lb", "rzm_vz",
                                      "vz_strength_vec")}
        self.fcfg = fitcore.FitConfig(cfg=self.cfg, data_type="hybrid",
                                      num_chrono=self.num_chrono, vz_offset=self.vz_offset,
                                      vz_index=self.vz_index, max_iter=max_iter, x_rtol=xtol,
                                      qp_max_iter=qp_max_iter,
                                      qp_max_iter_warm=qp_max_iter_warm,
                                      pred_stop=bool(pred_stop), pred_rtol=float(pred_rtol),
                                      qp_fused=bool(qp_fused))

    # The EIS fitter's weight initialization, physical-units extraction, Rp
    # and seed arrays serve hybrid lanes unchanged (as in the JAX package,
    # hybdrt_tpu/parallel/batch.py:1234-1255); the chrono/EIS weight factors
    # are 1 here, so the loop multiplies by none
    _loop_inputs = BatchedEISFitter._loop_inputs
    _set_special_scales = BatchedEISFitter._set_special_scales
    _warm_arrays = BatchedEISFitter._warm_arrays
    _check_options = staticmethod(BatchedEISFitter._check_options)
    collect = BatchedEISFitter.collect
    predict_r_p = BatchedEISFitter.predict_r_p
    _host_tensors = BatchedEISFitter._host_tensors

    def _final_design(self, h, result):
        """The design of each lane's last QP (B, M, N): the vz-offset column
        rewritten from the lane's final iterate ``result.x_raw``
        (``fitcore.with_vz_column``), as the loop left it
        (hybdrt_tpu/mapping/drtmd.py:777-790)."""
        if not self.vz_offset:
            return h["rzm"]
        x = torch.as_tensor(np.asarray(result.x_raw, dtype=float), dtype=torch.float64,
                            device=self.device)
        sign = fitcore.chrono_eis_sign(self.num_chrono, h["rzm"].shape[0], x)
        col = qphb_mod._mv(h["rzm_vz"], x) * sign * h["vz_strength_vec"]
        return fitcore.with_vz_column(h["rzm"], col, self.vz_index)

    def posterior_pq(self, rzv, result):
        """(P (B, N, N), q (B, N)): each lane's weighted QP at its final
        state, float64 on the fitter's device, from the scaled data ``rzv``
        (B, M) and the result's x_raw, rho, s_vectors and weights, each
        lane's final vz-offset column in its design (``_final_design``)."""
        return BatchedEISFitter.posterior_pq(self, rzv, result)

    def _posterior(self, result, v_batch, z_batch):
        """(P, q, scale) for the data (v_batch, z_batch) ``result`` was
        fitted to (``posterior_pq``)."""
        rzv, scale = self.scale_batch(v_batch, z_batch)
        p, q = self.posterior_pq(rzv, result)
        return p, q, scale

    def response_offsets(self, v_batch, scale):
        """Each observation's scaled response offset: minus the median of its
        scaled response before the first step, or 0 with no sample before it
        (:1137), which ``scale_batch`` adds."""
        v_s = np.asarray(v_batch, dtype=float) / (self.input_signal_scale * scale)[:, None]
        pre = self.times < self.step_times[0]
        if not pre.any():
            return np.zeros(len(v_s))
        return -np.median(v_s[:, pre], axis=1)

    def _loop_args(self, rzv):
        inp = self._loop_inputs(rzv)
        return (self.rzm, rzv, self.vmm, self.m_stack, self.l1v, self.lb, self.hyp, inp["x0"],
                inp["s0"], inp["rho0"], inp["dop_rho0"], inp["init_weights"],
                inp["est_weights"], inp["outlier_t0"], self.fcfg)

    def _fit_plain(self, rzv):
        return fitcore.qphb_fit_loop(*self._loop_args(rzv), **self.hybrid)

    def _fit_history(self, rzv):
        """(final states, history) of fitcore.qphb_fit_scan
        (``_fit_single_history``, hybdrt_tpu/parallel/batch.py:1148)."""
        return fitcore.qphb_fit_scan(*self._loop_args(rzv), **self.hybrid)

    def _fit_warm(self, rzv, warm):
        """Every lane seeded from ``warm`` in continuation mode, the vz-offset
        column rebuilt from the seed iterate (``_fit_single_warm``,
        hybdrt_tpu/parallel/batch.py:356-382); see BatchedEISFitter._fit_warm."""
        fcfg = replace(self.fcfg, continue_mode=True)
        inp = self._loop_inputs(rzv)
        x0, s0, rho0, dop_rho0, xmx0, dop_xmx0 = warm
        b = rzv.shape[0]
        state0 = qphb_mod.QPHBState(
            x=x0, s_vectors=s0, rho_vector=rho0, dop_rho_vector=dop_rho0,
            weights=inp["init_weights"], outlier_t=inp["outlier_t0"], xmx_norms=xmx0,
            dop_xmx_norms=dop_xmx0, it=torch.zeros(b, dtype=torch.int32, device=self.device),
            converged=torch.zeros(b, dtype=torch.bool, device=self.device),
            qp_dual=torch.zeros_like(x0))
        return fitcore.qphb_fit_loop_from_state(
            state0, self.rzm, rzv, self.vmm, self.m_stack, self.l1v, self.lb, self.hyp,
            inp["est_weights"], fcfg, seed_pred_history=fcfg.pred_stop,
            rebuild_vz=self.vz_offset, **self.hybrid)

    def scale_batch(self, v_batch, z_batch):
        """Per-observation Rp scaling and baseline offsets
        (hybdrt_tpu/parallel/batch.py:1123): the stacked scaled data (B, T +
        2F) and the coefficient scales (B,). The Rp estimates are
        ``estimate_rp_batch``'s, row for row ``estimate_rp``'s."""
        v_batch, z_batch = self._check_batch(v_batch, z_batch)
        scale = pp.estimate_rp_batch(self.times, self.step_times, self.step_sizes, v_batch,
                                     "ideal", z_batch) / self.rp_scale
        v_s = v_batch / (self.input_signal_scale * scale)[:, None] \
            + self.response_offsets(v_batch, scale)[:, None]
        z_s = z_batch / scale[:, None]
        return np.concatenate([v_s, z_s.real, z_s.imag], axis=1), scale

    def _check_batch(self, v_batch, z_batch):
        v_batch = np.asarray(v_batch, dtype=float)
        z_batch = np.asarray(z_batch)
        if v_batch.ndim != 2 or v_batch.shape[1] != len(self.times):
            raise ValueError(f"v_batch shape {v_batch.shape}: expected (B, {len(self.times)})")
        if z_batch.shape != (v_batch.shape[0], len(self.frequencies)):
            raise ValueError(f"z_batch shape {z_batch.shape}: expected ({v_batch.shape[0]}, "
                             f"{len(self.frequencies)})")
        return v_batch, z_batch

    def fit(self, v_batch, z_batch, return_states=False, return_history=False, adaptive=False,
            phase_budgets=None, staged_capacities=None, staged_buckets=None, warm_from=None,
            collect="full"):
        """Fit (B, n_times) responses and (B, n_freq) spectra; returns
        BatchFitResult (with ``return_states``, also the final states).

        adaptive=False, True and "staged" all run every lane in the live-lane
        loop, bitwise the same (see BatchedEISFitter.fit), so
        ``phase_budgets``, ``staged_capacities`` and ``staged_buckets``
        raise ValueError. collect="lazy" leaves result.weights and
        result.s_vectors as device tensors. warm_from=<the previous frame's
        BatchFitResult> seeds each lane from that frame's fit, with the
        vz-offset column rebuilt from the seed iterate; it combines with
        neither ``adaptive`` nor ``return_history``. ``return_history`` also
        returns every pass's state (``fitcore.qphb_fit_scan``), a dict of (B,
        max_iter, ...) arrays after the result (and the states), as the JAX
        fitter does (``hybdrt_tpu/parallel/batch.py:1206-1217``)."""
        self._check_options(adaptive, collect)
        if warm_from is not None and (adaptive or return_history):
            raise ValueError("warm_from seeds a plain whole-batch fit; it cannot be combined "
                             "with adaptive scheduling or return_history")
        for name, v in (("phase_budgets", phase_budgets),
                        ("staged_capacities", staged_capacities),
                        ("staged_buckets", staged_buckets)):
            if v is not None:
                raise ValueError(f"{name}: this fitter has no compaction schedule to budget; "
                                 f"every adaptive mode runs the live-lane loop")
        if return_history and adaptive:
            raise ValueError("return_history records a whole-batch fit; use it without "
                             "adaptive scheduling")
        if collect == "lazy" and (return_states or return_history):
            raise ValueError("collect='lazy' cannot be combined with return_states or "
                             "return_history: they return every field in full")
        rzv, scale = self.scale_batch(v_batch, z_batch)
        warm = None if warm_from is None else self._warm_arrays(warm_from, len(scale), scale)
        rzv = torch.as_tensor(rzv, dtype=self.dtype, device=self.device)
        if return_history:
            states, history = self._fit_history(rzv)
            out = self.collect(states, scale, return_states=return_states)
            return (*out, history) if return_states else (out, history)
        states = self._fit_plain(rzv) if warm is None else self._fit_warm(rzv, warm)
        return self.collect(states, scale, return_states=return_states,
                            lazy=(collect == "lazy"))

    def final_design_matrices(self, result):
        """The per-lane design matrices (B, M, N) as the loop left them: the
        vz-offset column rewritten from each lane's final iterate (host
        float64)."""
        rzm = np.broadcast_to(np.asarray(self.rzm.cpu(), dtype=float),
                              (len(result.scale), *self.rzm.shape)).copy()
        if self.vz_offset:
            h = {k: np.asarray(v.cpu(), dtype=float) for k, v in self.hybrid.items()}
            sign = fitcore.chrono_eis_sign(self.num_chrono, rzm.shape[1], torch.zeros(1)).numpy()
            rzm[:, :, self.vz_index] = (np.asarray(result.x_raw) @ h["rzm_vz"].T) * sign \
                * h["vz_strength"]
        return rzm
