"""Port parity: the serial map fit's options against the JAX ``DRTMD`` on
the CPU, float64 (split from tests/test_torch_drtmd_serial.py, whose module
fixtures fit the test maps): ``fit_all(ignore_errors=True)`` with the JAX
package's failure record, ``store_attr_categories`` (each category's
attribute names equal, "detail" among them), and the refusal of nonlinear
configurations (ROADMAP Queue 1 item 9).
"""
import numpy as np
import pytest
import torch

from hybdrt_tpu.mapping.drtmd import DRTMD as JaxDRTMD
from hybdrt_torch.mapping.drtmd import DRTMD
from hybdrt_torch.solver.qphb import QPHBConfig

from test_torch_drtmd_serial import FREQ, TAU_SUPER, _observations, _ten_spectra

torch.set_num_threads(1)


def test_ignore_errors():
    """tests/test_mapping.py:97-104 through the port, with the JAX
    package's failure record."""
    outs = []
    for cls, kw in ((JaxDRTMD, {}), (DRTMD, {"device": "cpu"})):
        md = cls(TAU_SUPER, psi_dim_names=["T"], warn=False, print_progress=False, **kw)
        md.add_observation([0.0], None, (FREQ, _ten_spectra()[0]))
        md.add_observation([1.0], None, (FREQ[:5], np.full(5, np.nan + 0j)))
        md.fit_all(ignore_errors=True)
        assert md.obs_fit_status[0] and not md.obs_fit_status[1]
        assert md.obs_ignore_flag[1]
        outs.append(md)
    mj, mt = outs
    sj, st = mj.fit_convergence_summary(), mt.fit_convergence_summary()
    for k in ("converged", "n_iter"):
        np.testing.assert_array_equal(st[k], sj[k])
    for k in ("num_fitted", "num_failed", "num_converged"):
        assert st[k] == sj[k]
    assert st["errors"][0] is None and st["errors"][1] is not None
    assert mt.predict_param_cov([0, 1])[1] is None
    assert np.isnan(mt.predict_x_cov([1])).all() and np.isnan(mt.predict_drt_var([1])).all()
    with pytest.raises(ValueError):
        mt.get_fit(1)


@pytest.mark.parametrize("cats", [["config"], ["fit_core"], ["config", "fit_core"],
                                  ["config", "detail"]])
def test_store_attr_categories(cats):
    tau, obs = _observations("eis")
    keys = []
    for cls, kw in ((JaxDRTMD, {}), (DRTMD, {"device": "cpu"})):
        md = cls(tau, store_attr_categories=cats, warn=False, print_progress=False, **kw)
        md.add_observation(*obs[0], fit=True)
        keys.append(set(md.obs_fit_attr[0]))
    assert keys[0] == keys[1]


def test_nonlinear_configuration_refused():
    """A nonlinear configuration, the port's or the JAX package's read from
    a pickle or a ragged system, raises (ROADMAP Queue 1 item 9)."""
    from hybdrt_tpu.solver.qphb import QPHBConfig as JaxQPHBConfig
    from hybdrt_torch.mapping.drtmd import _JaxQPHBConfig
    from hybdrt_torch.parallel.ragged import _port_system
    jcfg = JaxQPHBConfig(num_special=2, nonlin=True, half_size=3)
    for make in (lambda: QPHBConfig(num_special=2, nonlin=True),
                 lambda: QPHBConfig(num_special=2, half_size=3),
                 lambda: _JaxQPHBConfig(*jcfg),
                 lambda: _port_system({"data_type": "eis", "cfg": jcfg}),
                 lambda: _port_system({"data_type": "eis", "cfg": jcfg._asdict()})):
        with pytest.raises(NotImplementedError, match=r"item 9(?!\d)"):
            make()
    assert _port_system({"data_type": "eis", "cfg": jcfg._replace(
        nonlin=False, half_size=0)})["cfg"] == QPHBConfig(num_special=2)
