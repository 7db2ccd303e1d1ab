"""Natural cubic splines on equispaced grids.

The precompute runs on the host (NumPy, the same code as the JAX package);
evaluation is batched torch used by the per-cell thermo functions.  Mirrors
MathTools::SetSpline / GetSpline (reference: Common/src/Tools/spline.cpp),
including the equispaced-grid bin lookup, so table evaluations agree to
rounding.  The CUDA kernels carry the same lookup as one ``__device__``
evaluator (csrc/common.cuh).
"""

from __future__ import annotations

import numpy as np
import torch


def spline_second_derivatives(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Natural-BC second-derivative coefficients (SetSpline with yp1,ypn>1e30).

    Supports batched y of shape (..., n); x is the shared (n,) grid.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    assert y.shape[-1] == n
    y2 = np.zeros_like(y)
    u = np.zeros_like(y)
    # decomposition loop of the tridiagonal algorithm (natural BC: y2[0]=0)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[..., i - 1] + 2.0
        y2[..., i] = (sig - 1.0) / p
        du = (y[..., i + 1] - y[..., i]) / (x[i + 1] - x[i]) \
            - (y[..., i] - y[..., i - 1]) / (x[i] - x[i - 1])
        u[..., i] = (6.0 * du / (x[i + 1] - x[i - 1]) - sig * u[..., i - 1]) / p
    y2[..., n - 1] = 0.0
    for k in range(n - 2, -1, -1):
        y2[..., k] = y2[..., k] * y2[..., k + 1] + u[..., k]
    return y2


def spline_eval(x0: float, h: float, n: int, y: torch.Tensor,
                y2: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Evaluate species splines at temperatures ``t``.

    y, y2: (S, n) per-species tables on the shared grid x0 + k*h.
    t: any shape (...).  Returns (..., S).  t is clamped into the table
    domain; klo = clamp(int((t - x0)/h) + 1, 1, n - 1) as in GetSpline.
    """
    tc = torch.clamp(t, x0, x0 + (n - 1) * h)
    klo = torch.clamp(((tc - x0) / h).to(torch.int64) + 1, 1, n - 1)
    xk = x0 + klo.to(y.dtype) * h
    a = ((xk - tc) / h)[..., None]
    b = ((tc - (xk - h)) / h)[..., None]
    yl = y[:, klo - 1].movedim(0, -1)
    yh = y[:, klo].movedim(0, -1)
    y2l = y2[:, klo - 1].movedim(0, -1)
    y2h = y2[:, klo].movedim(0, -1)
    return a * yl + b * yh + ((a**3 - a) * y2l + (b**3 - b) * y2h) * (h * h) / 6.0
