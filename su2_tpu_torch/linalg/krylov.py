"""Flexible GMRES (torch), CSysSolve::FGMRES_LinSolver
(linear_solvers_structure.cpp:309): one cycle of a fixed number of Krylov
vectors with right preconditioning; converged iterations are frozen by
masks, so the solve never synchronises with the host."""

from __future__ import annotations

import torch


def _dot(a, b):
    return (a * b).sum()


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _pow2_scale(b):
    """Power-of-two magnitude of b: dividing by it is an exact exponent
    shift, which keeps ||b||^2 inside the f32 range (omega ~ 1/d^2 makes
    SST residual entries ~1e21)."""
    absmax = torch.abs(b).max()
    ex = torch.floor(torch.log2(torch.clamp(absmax, min=1e-300)))
    s = torch.exp2(torch.clamp(ex, -120.0, 120.0)).to(b.dtype)
    return torch.where(absmax > 0, s, torch.ones_like(s))


def fgmres(matvec, precond, b, max_iter: int = 5, tol: float = 1e-6,
           precond_matvec=None):
    """Returns (x, final relative residual, iterations used).
    precond_matvec, when given, computes (z, A z) = (precond(v),
    matvec(precond(v))) in one call (the stencil sweep kernels)."""
    s = _pow2_scale(b)
    b = b / s
    x = torch.zeros_like(b)
    r = b
    beta = _norm(r)
    norm0 = torch.clamp(_norm(b), min=1e-300)
    m = max_iter
    vs = [r / torch.clamp(beta, min=1e-300)]
    zs, cols, cs, sn = [], [], [], []
    g = [beta]
    active = beta / norm0 >= tol
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    res_hist = beta
    one = torch.ones_like(beta)
    zero = torch.zeros_like(beta)
    for j in range(m):
        if precond_matvec is not None:
            z, w = precond_matvec(vs[j])
        else:
            z = precond(vs[j])
            w = matvec(z)
        zs.append(z)
        col = []
        for i in range(j + 1):
            hij = _dot(vs[i], w)
            hij = torch.where(active, hij, one * (i == j))
            col.append(hij)
            w = w - torch.where(active, hij, 0.0) * vs[i]
        hj1 = torch.where(active, _norm(w), 0.0)
        vs.append(torch.where(active, w / torch.clamp(hj1, min=1e-300),
                              vs[j]))
        iters = iters + active.to(torch.int32)
        rc = list(col) + [hj1]
        for i in range(j):
            t = cs[i] * rc[i] + sn[i] * rc[i + 1]
            rc[i + 1] = -sn[i] * rc[i] + cs[i] * rc[i + 1]
            rc[i] = t
        denom = torch.sqrt(rc[j] * rc[j] + rc[j + 1] * rc[j + 1])
        safe = torch.clamp(denom, min=1e-300)
        cj = torch.where(denom == 0.0, one, rc[j] / safe)
        sj = torch.where(denom == 0.0, zero, rc[j + 1] / safe)
        cs.append(cj)
        sn.append(sj)
        gj1 = -sj * g[j]
        g[j] = cj * g[j]
        g.append(gj1)
        cur = torch.abs(gj1)
        res_hist = torch.where(active, cur, res_hist)
        active = active & (cur / norm0 >= tol)
        cols.append(rc[:j] + [cj * rc[j] + sj * rc[j + 1]])
    y = [zero] * m
    for j in range(m - 1, -1, -1):
        acc = g[j]
        for i in range(j + 1, m):
            acc = acc - cols[i][j] * y[i]
        rjj = cols[j][j]
        y[j] = torch.where(rjj == 0.0, zero,
                           acc / torch.where(rjj == 0.0, 1.0, rjj))
    dx = y[0] * zs[0]
    for j in range(1, m):
        dx = dx + y[j] * zs[j]
    return (x + dx) * s, res_hist / norm0, iters
