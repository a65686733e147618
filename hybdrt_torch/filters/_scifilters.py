"""Centre-excluded ("empty") gaussian filters and the 1-D gaussian Laplacian.

Copy of ``hybdrt_tpu/filters/_scifilters.py:1-79`` (numpy/scipy). The empty
filter estimates each pixel from its neighbourhood *excluding* the pixel
itself, which drives outlier-downweighting in the iterative filters; it is
built directly with ``correlate1d`` over explicit kernels.
"""
import numpy as np
from scipy import ndimage


def _gaussian_kernel1d(sigma, order, radius, empty=False):
    x = np.arange(-radius, radius + 1, dtype=float)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    if empty:
        phi[radius] = 0.0
    phi = phi / phi.sum()
    if order == 0:
        return phi
    if order == 1:
        return phi * (-x / sigma ** 2)
    if order == 2:
        return phi * ((x ** 2 / sigma ** 2 - 1) / sigma ** 2)
    raise ValueError(f"order {order} not supported")


def empty_gaussian_filter1d(input, sigma, axis=-1, order=0, output=None, mode="reflect",
                            cval=0.0, truncate=4.0):
    """Gaussian filter along one axis with the center pixel excluded."""
    input = np.asarray(input, dtype=float)
    radius = int(float(sigma) * truncate + 0.5)
    kernel = _gaussian_kernel1d(sigma, order, radius, empty=True)[::-1]
    return ndimage.correlate1d(input, kernel, axis=axis, output=output, mode=mode,
                               cval=cval)


def empty_gaussian_filter(input, sigma, order=0, output=None, mode="reflect", cval=0.0,
                          truncate=4.0):
    """N-D center-excluded gaussian as a SEQUENCE of 1-D empty filters
    (reference _scifilters.py): each axis pass excludes its own center tap,
    so the composed kernel zeroes the axis-aligned cross through the center.
    Separable, so cost scales with sum (not product) of kernel sizes."""
    input = np.asarray(input, dtype=float)
    if np.isscalar(sigma):
        sigma = [sigma] * input.ndim
    if np.isscalar(order):
        order = [order] * input.ndim
    out = input
    applied = False
    for axis, (s, o) in enumerate(zip(sigma, order)):
        if s > 1e-15:
            out = empty_gaussian_filter1d(out, s, axis=axis, order=o,
                                          mode=mode, cval=cval,
                                          truncate=truncate)
            applied = True
    if not applied:
        out = input.copy()
    if output is not None:
        output[...] = out
        return output
    return out


def generic_laplace1d(input, derivative2, axis=-1, output=None, mode="reflect",
                      cval=0.0, **kwargs):
    return derivative2(input, axis, output, mode, cval, **kwargs)


def laplace1d(input, axis=-1, output=None, mode="reflect", cval=0.0):
    return ndimage.correlate1d(np.asarray(input, dtype=float), np.array([1.0, -2.0, 1.0]),
                               axis=axis, output=output, mode=mode, cval=cval)


def gaussian_laplace1d(input, sigma, axis=-1, output=None, mode="reflect", cval=0.0,
                       **kwargs):
    """Second derivative of a gaussian-smoothed array along one axis."""
    return ndimage.gaussian_filter1d(np.asarray(input, dtype=float), sigma, axis=axis,
                                     order=2, output=output, mode=mode, cval=cval,
                                     **kwargs)
