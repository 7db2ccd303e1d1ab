"""Krylov solvers (torch): flexible GMRES, CSysSolve::FGMRES_LinSolver
(linear_solvers_structure.cpp:309), one cycle of a fixed number of Krylov
vectors with right preconditioning, and BiCGSTAB (:465) for a fixed
number of iterations; converged iterations are frozen by masks, so a
solve never synchronises with the host (and stays capturable in a CUDA
graph)."""

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


def bcgstab(matvec, precond, b, max_iter: int = 5, tol: float = 1e-6):
    """Preconditioned BiCGSTAB (CSysSolve::BCGSTAB_LinSolver) from x = 0:
    max_iter iterations, each updating x and r until the relative
    residual falls below tol and keeping them from then on (the scalars
    and the directions run on), so the solve never synchronises with the
    host.  Returns (x, final relative residual, max_iter) as
    krylov.fgmres."""
    s = _pow2_scale(b)
    b = b / s
    x = torch.zeros_like(b)
    r = b - matvec(x)
    r0 = r
    norm0 = torch.clamp(_norm(b), min=1e-300)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    nz = lambda d: torch.where(d == 0, 1.0, d)
    for _ in range(max_iter):
        rho_new = _dot(r0, r)
        beta = (rho_new / nz(rho)) * (alpha / nz(omega))
        p = r + beta * (p - omega * v)
        ph = precond(p)
        v = matvec(ph)
        alpha = rho_new / nz(_dot(r0, v))
        s_ = r - alpha * v
        sh = precond(s_)
        t = matvec(sh)
        omega = _dot(t, s_) / nz(_dot(t, t))
        x_new = x + alpha * ph + omega * sh
        r_new = s_ - omega * t
        conv = _norm(r_new) / norm0 < tol
        x = torch.where(done, x, x_new)
        r = torch.where(done, r, r_new)
        rho = rho_new
        done = done | conv
    return x * s, _norm(r) / norm0, torch.full((), max_iter,
                                                dtype=torch.int32,
                                                device=b.device)


def solve(kind: str, ops, rhs, max_iter: int, tol: float):
    """The linear solve of an implicit system, LINEAR_SOLVER= kind, with
    ops = (matvec, precond, precond_matvec | None, solve | None) of
    blockcsr.make_solver_ops: BCGSTAB, or (every other value, as the
    reference runs it) FGMRES, as one launch where ops has one.  Returns
    the solution."""
    mv, pc, pm, one = ops
    if kind == "BCGSTAB":
        return bcgstab(mv, pc, rhs, max_iter=max_iter, tol=tol)[0]
    if one is not None:
        return one(rhs, max_iter, tol)[0]
    return fgmres(mv, pc, rhs, max_iter=max_iter, tol=tol,
                  precond_matvec=pm)[0]
