"""The chrono voltage baseline (``get_baseline_matrix`` of
``hybdrt_tpu/models/background.py:13-25``): a polynomial in time, and
optionally sqrt(t), that enters the QP design matrix as the ``v_baseline``
columns. The GP background of that module is not ported (ROADMAP Queue 1
item 11)."""
import numpy as np


def get_baseline_matrix(times, deg, normalize=False, sqrt=False):
    """(T, deg + 1 [+ 1]) design matrix of the voltage baseline: columns
    (t - t0)^n, n = 0..deg, and (t - t0)^0.5 with ``sqrt``. With
    ``normalize`` each column is divided by its largest value (1 where that
    is 0) and (matrix, scales) is returned."""
    times = np.asarray(times)
    vb_mat = np.zeros((len(times), deg + 1 + int(sqrt)))
    for n in range(deg + 1):
        vb_mat[:, n] = (times - times[0]) ** n
    if sqrt:
        vb_mat[:, -1] = (times - times[0]) ** 0.5
    if normalize:
        scales = np.max(vb_mat, axis=0)
        scales[scales == 0] = 1.0
        return vb_mat / scales[None, :], scales
    return vb_mat
