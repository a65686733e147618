"""Input validation of the EIS, chrono and hybrid fits (copy of
``hybdrt_tpu/utils/validation.py:5-55``).

The original is numpy-only, but importing it runs ``hybdrt_tpu/__init__.py``,
which imports JAX; the port keeps its own copy so it runs where JAX is absent.
"""
import numpy as np

basis_options = ["gaussian", "Cole-Cole", "zga", "delta", "step", "pwl", "beta",
                 "Zic", "ramp", "bounded_ramp", "pwl_transformed", "beta-rbf"]
step_model_options = ["ideal", "expdecay"]
ctrl_mode_options = ["galv", "pot"]
error_structure_options = [None, "uniform"]


def check_option(value, options, name):
    if value not in options:
        raise ValueError(f"Invalid {name} {value!r}. Options: {options}")


def check_basis_type(basis_type):
    check_option(basis_type, basis_options, "basis_type")


def check_step_model(step_model):
    check_option(step_model, step_model_options, "step_model")


def check_ctrl_mode(op_mode):
    check_option(op_mode, ctrl_mode_options, "op_mode")


def check_error_structure(error_structure):
    check_option(error_structure, error_structure_options, "error_structure")


def check_eis_data(frequencies, z):
    if (frequencies is None) != (z is None):
        raise ValueError("frequencies and z must both be provided or both be None")
    if frequencies is not None:
        frequencies = np.asarray(frequencies)
        z = np.asarray(z)
        if len(frequencies) != len(z):
            raise ValueError("frequencies and z must have the same length")


def check_chrono_data(times, i_signal, v_signal):
    provided = [a is not None for a in (times, i_signal, v_signal)]
    if any(provided) and not all(provided):
        raise ValueError("times, i_signal, and v_signal must all be provided or all be None")
    if times is not None:
        n = len(np.asarray(times))
        if len(np.asarray(i_signal)) != n or len(np.asarray(v_signal)) != n:
            raise ValueError("times, i_signal, and v_signal must have the same length")
