"""QPHB outer fit loop over a batch of EIS spectra or hybrid observations.

Counterpart of ``hybdrt_tpu/solver/fitcore.py``. The JAX package
vmapped a ``lax.while_loop`` over the batch; here the loop runs on the host,
one iteration per pass, over the lanes whose own loop condition
``it < max_iter and not converged`` still holds. Those lanes are gathered,
stepped and scattered back, so every lane stops at the iteration it stops at
in JAX and a finished lane is never touched (one host sync per iteration).

The problem arrays are shared by all lanes, or each lane has its own
(``LaneSystem``, the ragged fitter's), gathered with the live lanes' state.

Hybrid (chrono + EIS) fits add two steps to each pass
(``hybdrt_tpu/solver/fitcore.py:78-88``, ``:166-175``): the QP sees the
weights times the chrono/EIS row factors, and after the pass the design's
vz-offset column is rewritten from the new iterate. That column differs per
lane; it is a pure function of x, so the loop carries it (B, M) beside the
state and puts it into the (shared or per-lane) design for each pass.
"""
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from . import qphb
from .qphb import QPHBConfig, QPHBState


@dataclass(frozen=True)
class FitConfig:
    """Static fit-loop configuration (no DOP, outlier or background
    blocks)."""
    cfg: QPHBConfig
    data_type: str = "eis"          # 'eis' | 'chrono' | 'hybrid'
    num_chrono: int = 0
    # Hybrid fits: rewrite design column vz_index from the iterate each pass
    vz_offset: bool = False
    vz_index: int = -1
    max_iter: int = 50
    x_rtol: float = 1e-2
    qp_max_iter: int = 60
    # Cap on Mehrotra steps for warm-started (it > 0) QP solves
    qp_max_iter_warm: Optional[int] = None
    # Opt-in data-space stop: also accept "prediction settled", the weighted
    # RMS change between this iteration's prediction and the one two
    # iterations back falling below pred_rtol
    pred_stop: bool = False
    pred_rtol: float = 1e-2
    # Fused warm QP path: every QP of the loop is statically warm-started
    # and runs qp_max_iter_warm fixed Mehrotra steps in one ip_steps_lane
    # call; a fresh fit peels iteration 0 off as one cold pass over every
    # lane, a fit seeded from another frame (continuation) does not
    qp_fused: bool = False
    # Continuation mode (frame-to-frame warm starts,
    # hybdrt_tpu/solver/fitcore.py:41-42): the seed's xmx_norms are held
    # fixed, and convergence stops a lane no earlier than min_iter
    # iterations. pred_stop settles a lane no earlier than max(min_iter, 3)
    # in either mode
    continue_mode: bool = False
    min_iter: int = 2


@dataclass
class FitCarry:
    state: QPHBState
    # Prediction history for pred_stop (None when disabled)
    y_prev: Optional[torch.Tensor] = None
    y_prev2: Optional[torch.Tensor] = None
    # Each lane's vz-offset design column (B, M) (None without vz_offset)
    vz_col: Optional[torch.Tensor] = None

    def take(self, idx):
        pick = lambda v: None if v is None else v[idx]
        return FitCarry(self.state.map(lambda v: v[idx]), pick(self.y_prev),
                        pick(self.y_prev2), pick(self.vz_col))

    def put(self, idx, part):
        def put(full, sub):
            if full is None:
                return None
            out = full.clone()
            out[idx] = sub
            return out
        return FitCarry(self.state.map(put, part.state), put(self.y_prev, part.y_prev),
                        put(self.y_prev2, part.y_prev2), put(self.vz_col, part.vz_col))


@dataclass
class LaneSystem:
    """The problem arrays of the fit loop. Per-lane (``rzm`` 3-D): rzm, vmm,
    l1v, lb and the masks have the lane dimension first, and m_stack too
    where it is 4-D; ``col_mask`` (B, N) is 1 on a lane's real columns,
    ``row_mask`` (B, M) on its real rows, and ``var_floor`` (B,) its unpadded
    data variance times 1e-7 (``hybdrt_tpu/parallel/ragged.py:431-518``).
    Shared: the masks are None.

    Hybrid systems add ``row_factors``, the chrono/EIS weight factor of each
    row, and the vz-offset column's sources: ``rzm_vz`` (the design with its
    baseline columns zeroed), ``vz_strength`` and ``vz_sign`` (+1 on chrono
    rows, -1 on EIS rows). Each is shared (rzm_vz (M, N), the others (M,))
    or per lane (a leading lane dimension), whatever the design is."""
    rzm: torch.Tensor
    vmm: torch.Tensor
    m_stack: torch.Tensor
    l1v: torch.Tensor
    lb: torch.Tensor
    col_mask: Optional[torch.Tensor] = None
    row_mask: Optional[torch.Tensor] = None
    var_floor: Optional[torch.Tensor] = None
    row_factors: Optional[torch.Tensor] = None
    rzm_vz: Optional[torch.Tensor] = None
    vz_strength: Optional[torch.Tensor] = None
    vz_sign: Optional[torch.Tensor] = None

    @property
    def per_lane(self):
        return self.rzm.dim() == 3

    def take(self, idx):
        """The system of lanes ``idx``: the per-lane arrays gathered, the
        shared ones as they are."""
        def pick(a, lane_dims):
            return a[idx] if a is not None and a.dim() == lane_dims else a
        hybrid = dict(row_factors=pick(self.row_factors, 2), rzm_vz=pick(self.rzm_vz, 3),
                      vz_strength=pick(self.vz_strength, 2), vz_sign=pick(self.vz_sign, 2))
        if not self.per_lane:
            return replace(self, **hybrid)
        return LaneSystem(self.rzm[idx], self.vmm[idx],
                          self.m_stack[idx] if self.m_stack.dim() == 4 else self.m_stack,
                          self.l1v[idx], self.lb[idx], pick(self.col_mask, 2),
                          pick(self.row_mask, 2), pick(self.var_floor, 1), **hybrid)

    def vz_column(self, x):
        """The vz-offset design column of iterate x (B, N): (rzm_vz @ x) *
        vz_sign * vz_strength, per lane (B, M)."""
        return qphb._mv(self.rzm_vz, x) * self.vz_sign * self.vz_strength


def chrono_eis_sign(num_chrono, rows, like):
    """The vz offset's sign on each row of one chrono/EIS split: +1 on the
    first num_chrono (chrono) rows, -1 on the rest, in ``like``'s dtype and
    device (``hybdrt_tpu/solver/fitcore.py:172``)."""
    r = torch.arange(rows, device=like.device)
    return torch.where(r < num_chrono, 1.0, -1.0).to(like.dtype)


def with_vz_column(rzm, vz_col, vz_index):
    """The per-lane design (B, M, N): ``rzm`` (shared (M, N) or per lane)
    with column vz_index set to each lane's ``vz_col`` (B, M)."""
    n = rzm.shape[-1]
    sel = torch.arange(n, device=rzm.device) == vz_index
    return torch.where(sel, vz_col[:, :, None], rzm)


def _loop_body(carry: FitCarry, sys_: LaneSystem, rzv, est_weights, hyp, fcfg: FitConfig,
               warm_mode="auto"):
    # The JAX package scales the weights by a global weight factor, from
    # iteration 1 in a fresh fit and from iteration 0 in continuation mode;
    # the port's fits take a factor of 1 (hybdrt_tpu/parallel/batch.py:380;
    # models/drt.py and parallel/ragged.py raise for another), so there is
    # nothing to scale here
    st = carry.state
    rzm, m_stack = sys_.rzm, sys_.m_stack
    if carry.vz_col is not None:
        rzm = with_vz_column(rzm, carry.vz_col, fcfg.vz_index)
    st_in = st
    if sys_.row_factors is not None:
        # Hybrid: the QP sees the weights times the chrono/EIS factors; the
        # state keeps them unfactored (hybdrt_tpu/solver/fitcore.py:78-88)
        st_in = replace(st, weights=st.weights * sys_.row_factors)
    fused = fcfg.qp_max_iter_warm if fcfg.qp_fused and warm_mode == "warm" else None
    st_new, _ = qphb.iterate_qphb(st_in, rzv, rzm, sys_.vmm, m_stack, m_stack[..., 1, :, :],
                                  sys_.l1v, sys_.lb, est_weights, hyp, fcfg.cfg,
                                  x_rtol=fcfg.x_rtol, qp_max_iter=fcfg.qp_max_iter,
                                  qp_max_iter_warm=fcfg.qp_max_iter_warm,
                                  warm_mode=warm_mode, qp_fused_steps=fused,
                                  col_mask=sys_.col_mask, var_floor=sys_.var_floor)

    if fcfg.continue_mode:
        # The seed's norms stay fixed, and convergence cannot stop a lane
        # before min_iter iterations (hybdrt_tpu/solver/fitcore.py:126-130)
        st_new.converged = st_new.converged & (st_new.it >= fcfg.min_iter)
    else:
        # Normalize the rho update scale to the iteration-0 ridge solution,
        # on the lanes that just ran their iteration 0
        ns = fcfg.cfg.num_special
        x_drt = st_new.x[:, ns:]
        xmx = torch.stack([qphb._xmx(x_drt, m_stack[..., k, ns:, ns:])
                           for k in range(fcfg.cfg.k_range)], dim=1)
        st_new.xmx_norms = torch.where((st.it == 0)[:, None], xmx, st_new.xmx_norms)

    y_prev, y_prev2 = carry.y_prev, carry.y_prev2
    if fcfg.pred_stop:
        y_new = qphb._mv(rzm, st_new.x)
        delta = (y_new - y_prev2) * st_new.weights
        if sys_.row_mask is None:
            ms = torch.mean(delta ** 2, dim=-1)
        else:
            # padded rows would dilute a plain mean: average over real rows
            # only (hybdrt_tpu/solver/fitcore.py:151-159)
            rm_ = sys_.row_mask
            ms = torch.sum((delta * rm_) ** 2, dim=-1) / torch.clamp(torch.sum(rm_, dim=-1),
                                                                     min=1.0)
        settled = (st_new.it >= max(fcfg.min_iter, 3)) & (torch.sqrt(ms) < fcfg.pred_rtol)
        st_new.converged = st_new.converged | settled
        y_prev2 = y_prev
        y_prev = y_new

    vz_col = carry.vz_col
    if vz_col is not None:
        # The vz-offset column rewritten from the new iterate, after the
        # prediction above used this pass's design (:166-175)
        vz_col = sys_.vz_column(st_new.x)
    return FitCarry(state=st_new, y_prev=y_prev, y_prev2=y_prev2, vz_col=vz_col)


def _check_config(fcfg: FitConfig):
    if fcfg.cfg.penalty_type != "integral":
        raise NotImplementedError(f"penalty_type={fcfg.cfg.penalty_type!r}: only the "
                                  f"integral penalty is implemented")


def initial_state(x0, s0, rho0, dop_rho0, init_weights, outlier_t0, k_range):
    """Fresh per-lane state (iteration 0, unit penalty norms, zero duals)."""
    b = x0.shape[0]
    ones = torch.ones(b, k_range, dtype=x0.dtype, device=x0.device)
    return QPHBState(
        x=x0, s_vectors=s0, rho_vector=rho0, dop_rho_vector=dop_rho0,
        weights=init_weights, outlier_t=outlier_t0, xmx_norms=ones, dop_xmx_norms=ones,
        it=torch.zeros(b, dtype=torch.int32, device=x0.device),
        converged=torch.zeros(b, dtype=torch.bool, device=x0.device),
        qp_dual=torch.zeros_like(x0))


def qphb_fit_loop(rzm, rzv, vmm, m_stack, l1v, lb, hyp, x0, s0, rho0, dop_rho0,
                  init_weights, est_weights, outlier_t0, fcfg: FitConfig,
                  return_pred_history=False, col_mask=None, row_mask=None, var_floor=None,
                  **hybrid):
    """Run the full QPHB outer loop over a batch; returns the final state.

    Per-lane inputs have the lane dimension first: rzv (B, M), x0 (B, N),
    s0 (B, K, N), rho0/dop_rho0 (B, K), weights (B, M). With
    return_pred_history (requires pred_stop) also returns (y_prev, y_prev2),
    so that qphb_fit_loop_from_state can resume the exact trajectory. With
    fcfg.qp_fused, iteration 0 is peeled off (peel_cold_start). A 3-D
    ``rzm`` is a per-lane system, with its masks and floor (``LaneSystem``).
    ``hybrid`` are the hybrid keywords of qphb_fit_loop_from_state."""
    state0 = initial_state(x0, s0, rho0, dop_rho0, init_weights, outlier_t0,
                           fcfg.cfg.k_range)
    return qphb_fit_loop_from_state(state0, rzm, rzv, vmm, m_stack, l1v, lb, hyp,
                                    est_weights, fcfg, peel_cold_start=fcfg.qp_fused,
                                    return_pred_history=return_pred_history,
                                    col_mask=col_mask, row_mask=row_mask, var_floor=var_floor,
                                    **hybrid)


def qphb_fit_loop_from_state(state0, rzm, rzv, vmm, m_stack, l1v, lb, hyp, est_weights,
                             fcfg: FitConfig, y_prev0=None, y_prev2_0=None,
                             peel_cold_start=False, seed_pred_history=False,
                             return_pred_history=False, on_pass=None, col_mask=None,
                             row_mask=None, var_floor=None, row_factors=None, rzm_vz=None,
                             vz_strength=None, vz_sign=None, rebuild_vz=False):
    """Run (or resume) the QPHB outer loop from an explicit per-lane state.

    The loop body is Markovian in the state, so resuming a loop that stopped
    at max_iter=k with a larger max_iter continues the exact trajectory of
    one uninterrupted run. With pred_stop the prediction history is part of
    that state: pass y_prev0/y_prev2_0 from a run with
    return_pred_history=True (without them the history starts at zero, as in
    a fresh fit). Where no history was kept, as for a state seeded from
    another frame's fit, seed_pred_history seeds both slots with the
    prediction of state0.x (``hybdrt_tpu/solver/fitcore.py:275-276``): a
    lane may then settle one iteration earlier or later than with a carried
    history.

    With fcfg.qp_fused the loop's QPs are statically warm-started and fused
    (``warm_mode="warm"``). peel_cold_start first runs one cold pass
    (``warm_mode="cold"``: the damped unconstrained start and up to
    qp_max_iter steps) over every lane, as a fresh fused fit does for its
    iteration 0 (``hybdrt_tpu/solver/fitcore.py:280-282``); a resumed fused
    fit leaves it False and continues warm.

    ``on_pass(state)``, if given, is called with the whole batch's state
    after every pass of the loop (the peeled cold pass included).

    A 3-D ``rzm`` (B, M, N) is a per-lane system (``LaneSystem``), whose
    arrays each pass gathers for the live lanes with their state.

    Hybrid fits pass ``row_factors`` (the chrono/EIS weight factors; None
    means 1) and, with ``fcfg.vz_offset``, ``rzm_vz`` and ``vz_strength``
    (``LaneSystem``), and ``vz_sign`` where the chrono/EIS split differs per
    lane (ragged batches; else +1 on the first ``fcfg.num_chrono`` rows and
    -1 on the rest). The loop starts from the design's own vz column, zero
    in a fresh fit; ``rebuild_vz`` rebuilds it from state0.x first, as a fit
    seeded from another frame's iterate does
    (``hybdrt_tpu/parallel/batch.py:374-377``)."""
    _check_config(fcfg)
    fit_vz = fcfg.data_type == "hybrid" and fcfg.vz_offset
    if fit_vz and vz_sign is None:
        vz_sign = chrono_eis_sign(fcfg.num_chrono, rzv.shape[-1], rzv)
    sys_ = LaneSystem(rzm, vmm, m_stack, l1v, lb, col_mask, row_mask, var_floor, row_factors,
                      rzm_vz, vz_strength, vz_sign)
    if not sys_.per_lane and not (col_mask is None and row_mask is None and var_floor is None):
        raise ValueError("col_mask, row_mask and var_floor belong to per-lane systems "
                         "(a 3-D rzm)")
    if return_pred_history and not fcfg.pred_stop:
        raise ValueError("return_pred_history requires fcfg.pred_stop")
    vz_col = None
    if fit_vz:
        if rzm_vz is None or vz_strength is None:
            raise ValueError("a hybrid fit with fcfg.vz_offset needs rzm_vz and vz_strength")
        if rebuild_vz:
            vz_col = sys_.vz_column(state0.x)
        else:
            vz_col = rzm[..., fcfg.vz_index].expand(rzv.shape[0], -1).clone()
        rzm0 = with_vz_column(rzm, vz_col, fcfg.vz_index)
    else:
        rzm0 = rzm
    if not fcfg.pred_stop:
        y0 = y02 = None
    elif y_prev0 is not None:
        y0 = y_prev0
        y02 = y_prev2_0 if y_prev2_0 is not None else y_prev0
    elif seed_pred_history:
        y0 = y02 = qphb._mv(rzm0, state0.x)
    else:
        y0 = y02 = torch.zeros_like(rzv)
    carry = FitCarry(state=state0, y_prev=y0, y_prev2=y02, vz_col=vz_col)
    if peel_cold_start:
        carry = _loop_body(carry, sys_, rzv, est_weights, hyp, fcfg, warm_mode="cold")
        if on_pass is not None:
            on_pass(carry.state)
    loop_mode = "warm" if fcfg.qp_fused else "auto"
    bsz = rzv.shape[0]
    while True:
        st = carry.state
        live = (st.it < fcfg.max_iter) & ~st.converged
        idx = torch.nonzero(live).squeeze(1)
        n_live = idx.numel()
        if n_live == 0:
            break
        if n_live == bsz:
            carry = _loop_body(carry, sys_, rzv, est_weights, hyp, fcfg, warm_mode=loop_mode)
        else:
            part = _loop_body(carry.take(idx), sys_.take(idx), rzv[idx], est_weights[idx], hyp,
                              fcfg, warm_mode=loop_mode)
            carry = carry.put(idx, part)
        if on_pass is not None:
            on_pass(carry.state)
    if return_pred_history:
        return carry.state, carry.y_prev, carry.y_prev2
    return carry.state


# The fields of the per-iteration history (hybdrt_tpu/solver/fitcore.py:328-332)
HISTORY_FIELDS = ("x", "s_vectors", "rho_vector", "dop_rho_vector", "weights", "outlier_t",
                  "it", "converged")


class History:
    """Per-iteration record of a batch's state, entry t the state after
    pass t. The buffers are allocated once, iteration-major (T, B, ...) so
    that each pass writes one contiguous slice. For a state on a CUDA device
    they are pinned host memory that each pass's slice is copied into
    without a sync, which beat buffers on the card with one transfer per
    field at the end (PERF.md §5, ``torch_fit_walls.py --history``);
    otherwise they lie on the state's device."""

    def __init__(self, state, max_iter):
        self.pinned = pinned = state.x.is_cuda
        self.t = 0
        self.bufs = {}
        for f in HISTORY_FIELDS:
            v = getattr(state, f)
            kw = dict(pin_memory=True) if pinned else dict(device=v.device)
            self.bufs[f] = torch.empty((max_iter, *v.shape), dtype=v.dtype, **kw)

    def record(self, state):
        for f, buf in self.bufs.items():
            buf[self.t].copy_(getattr(state, f), non_blocking=self.pinned)
        self.t += 1

    def finish(self, state):
        """{field: (B, max_iter, ...) numpy array}, the entries after the
        last pass filled with the final state (the last one recorded) on the
        host. The arrays are views of the (T, B, ...) buffers."""
        if self.t == 0:
            self.record(state)
        if self.pinned:
            torch.cuda.current_stream(state.x.device).synchronize()
        out = {}
        for f, buf in self.bufs.items():
            a = buf.cpu().numpy()
            a[self.t:] = a[self.t - 1]
            out[f] = np.swapaxes(a, 0, 1)
        return out


def qphb_fit_scan(rzm, rzv, vmm, m_stack, l1v, lb, hyp, x0, s0, rho0, dop_rho0, init_weights,
                  est_weights, outlier_t0, fcfg: FitConfig, **hybrid):
    """The fit loop that records every iteration's state: the batched
    counterpart of ``hybdrt_tpu/solver/fitcore.py::qphb_fit_scan``. Returns
    (final_state, history), history a dict of numpy arrays of shape (B,
    fcfg.max_iter, ...) with the keys ``HISTORY_FIELDS``; entry t is the
    state after iteration t, and the entries after a lane stops repeat its
    final state (mask with history['it']).

    Every live lane has ``it == p`` at pass p of a fresh fit, so the whole
    batch's state after pass p is entry p. The JAX scan runs its loop body
    with ``warm_mode="auto"`` and peels no cold pass, so with ``qp_fused``
    every QP here runs the unfused solver (the warm ones capped at
    qp_max_iter_warm), as there; without it this is ``qphb_fit_loop``'s
    loop exactly. ``hybrid`` are the hybrid keywords of
    qphb_fit_loop_from_state."""
    fcfg = replace(fcfg, qp_fused=False)
    state0 = initial_state(x0, s0, rho0, dop_rho0, init_weights, outlier_t0, fcfg.cfg.k_range)
    hist = History(state0, fcfg.max_iter)
    final = qphb_fit_loop_from_state(state0, rzm, rzv, vmm, m_stack, l1v, lb, hyp, est_weights,
                                     fcfg, on_pass=hist.record, **hybrid)
    return final, hist.finish(final)
