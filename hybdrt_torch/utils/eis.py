"""Complex impedance vector helpers (copy of ``hybdrt_tpu/utils/eis.py:5-17``,
kept here so that the port runs where JAX is absent)."""
import numpy as np


def complex_vector_to_concat(z, axis=-1):
    """[Re(z); Im(z)] concatenation."""
    z = np.asarray(z)
    return np.concatenate([z.real, z.imag], axis=axis)


def concat_vector_to_complex(v):
    v = np.asarray(v)
    if len(v) % 2 == 1:
        raise ValueError("v must be of even length")
    n = len(v) // 2
    return v[:n] + 1j * v[n:]
