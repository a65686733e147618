"""Input validation of the EIS fit (copy of the EIS part of
``hybdrt_tpu/utils/validation.py:17-45``).

The original is numpy-only, but importing it runs ``hybdrt_tpu/__init__.py``,
which imports JAX; the port keeps its own copy so it runs where JAX is absent.
"""
import numpy as np

basis_options = ["gaussian", "Cole-Cole", "zga", "delta", "step", "pwl", "beta",
                 "Zic", "ramp", "bounded_ramp", "pwl_transformed", "beta-rbf"]
error_structure_options = [None, "uniform"]


def check_option(value, options, name):
    if value not in options:
        raise ValueError(f"Invalid {name} {value!r}. Options: {options}")


def check_basis_type(basis_type):
    check_option(basis_type, basis_options, "basis_type")


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
