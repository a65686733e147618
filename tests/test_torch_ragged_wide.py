"""Port parity: ragged fits whose padded QPs exceed the lane kernels' tile
rule (ROADMAP Queue 3 item 24), against the JAX ``BatchedRaggedFitter``,
float64 on the CPU.

Six of the het map's EIS spectra (``utils/probe.py::make_het_eis``, on its
three grids) on a supergrid of 25 points a decade: the padded n lies above
the float64 tile rule (188) and above #5's (152). The JAX fitter refuses no
size; the port's QPs take the library route there (``ops/qp.py::
library_route``), chosen by n before anything runs and counted in
``chol_lane.QP_ROUTES``, and with ``qp_fused`` every warm QP runs the plain
Mehrotra steps (``qp.fused_route`` "fused_plain"), as the JAX package's
non-TPU fused route (``_ip_steps_single`` vmapped) does. Held at the parity
contract's tolerances, as tests/test_torch_ragged_fused.py holds the fused
ragged fits: the same n_iter and converged flags, coefficients within 1e-6
of each observation's max, the specials and weights within rtol 1e-6, atol
1e-10.
"""
import numpy as np
import pytest
import torch

from hybdrt_tpu.parallel.ragged import BatchedRaggedFitter as JaxRagged
from hybdrt_torch import BatchedRaggedFitter
from hybdrt_torch.ops import chol_lane, ip_lane, qp as qp_mod
from hybdrt_torch.utils import probe

from test_torch_ragged_fused import _hold

torch.set_num_threads(1)

TAU_WIDE = np.logspace(-8, 3, 276)
KW = dict(qp_max_iter=20, qp_max_iter_warm=4, max_iter=20)


@pytest.fixture(scope="module")
def obs():
    return probe.make_het_eis(6, 2)[0]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_wide_ragged_fit_matches_jax(obs, fused):
    ref = JaxRagged(TAU_WIDE, batch_bucket=False, qp_fused=fused, **KW).fit(obs)
    fitter = BatchedRaggedFitter(TAU_WIDE, device="cpu", qp_fused=fused, **KW)
    chol_lane.reset_launch_counts()
    res = fitter.fit(obs)
    n = res.x_raw.shape[1]
    assert n > 188 and not chol_lane.admitted(n, torch.float64)
    assert not ip_lane.admitted(n, torch.float64)
    _hold(res, ref)
    routes = dict(chol_lane.QP_ROUTES)
    # every QP factors through the library; the fused fit's warm QPs (every
    # pass after the cold iteration 0) run the plain steps
    assert routes["lane"] == 0 and routes["library"] > 0
    assert routes["fused_plain"] == (routes["library"] - 2 if fused else 0)


def test_routes_are_chosen_by_size():
    """The routes of a QP: the lane kernels and #5 at and below their rules,
    the library and the plain steps above them, in both precisions."""
    for dtype, lane_max, fused_max in ((torch.float32, 268, 216), (torch.float64, 188, 152)):
        assert not qp_mod.library_route(lane_max, dtype) and qp_mod.library_route(lane_max + 1,
                                                                                  dtype)
        assert qp_mod.fused_route(fused_max, dtype) == "fused"
        assert qp_mod.fused_route(fused_max + 1, dtype) == "fused_plain"
