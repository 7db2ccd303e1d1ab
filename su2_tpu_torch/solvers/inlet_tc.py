"""TOTAL_CONDITIONS inlet temperature solve (torch).

Port of su2_tpu/pallas/inlet_tc.py.  The subsonic-inlet total-conditions
branch (BC_Inlet, reference solver_direct_reactive.cpp:3226-3489; the JAX
package's euler.inlet_state) roots f(T) = h_mix(T) + 0.5 vb(T)^2 - h_tot
per marker vertex with a secant from T_tot (15 steps) and a bisection
fallback on [T_min, T_tot] (100 steps, tol 1e-6).  The marker's mass
fractions are constants, so h_mix is one combined spline table
y = sum_s (Y_s / M_s) h_s, precombined on the host in float64 at setup.

The port computes the JAX package's KERNEL arithmetic on every device: the
secant converges when |dT| < max(1e-9, 4 eps |T_new|).  su2_tpu runs that
kernel on its chip; its XLA chain (solvers/euler.py:283-322) has no eps
floor, which agrees in float64 (4 eps T ~ 1e-12 < 1e-9) but not in
float32, where 1e-9 K is below the rounding of T.

On CUDA tensors the solve is kernel K9 (csrc/inlet_tc.cu), one thread per
vertex with its own exit; on CPU tensors ``solve_plain``, whose masked
lanes freeze once converged, so each vertex gets the same result.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class TotalConditions:
    """Constants of one marker's solve (host floats and the combined
    table in the run's dtype, on the run's device)."""
    y: torch.Tensor           # (nT,) combined enthalpy knots [J/kg]
    y2: torch.Tensor          # (nT,) their second derivatives
    t0: float
    dt: float
    nt: int
    rgas: float               # marker mixture gas constant
    htot: float               # h_mix(T_tot)
    ttot: float
    tmin: float = 300.0
    sec_iters: int = 15
    sec_tol: float = 1.0e-9
    bis_iters: int = 100
    bis_tol: float = 1.0e-6


def _mix_table(lib, ys):
    """Host float64 combined table (y, y2) of the composition ys."""
    w = np.asarray(ys, np.float64) / lib.mm.double().cpu().numpy()
    y = (w[:, None] * lib.h_y.double().cpu().numpy()).sum(0)
    y2 = (w[:, None] * lib.h_y2.double().cpu().numpy()).sum(0)
    return y, y2


def _mix_eval_np(lib, y, y2, t: float) -> float:
    """Host combined-spline evaluation (GetSpline arithmetic)."""
    t0, h, n = float(lib.t0), float(lib.dt), int(lib.nt)
    tc = min(max(t, t0), t0 + (n - 1) * h)
    klo = min(max(int((tc - t0) / h) + 1, 1), n - 1)
    xk = t0 + klo * h
    a = (xk - tc) / h
    b = (tc - (xk - h)) / h
    return float(a * y[klo - 1] + b * y[klo]
                 + ((a ** 3 - a) * y2[klo - 1] + (b ** 3 - b) * y2[klo])
                 * h * h / 6.0)


def total_conditions_t(lib, ys, ttot: float, tmin: float = 300.0):
    """Setup of one marker's solve from the library (any device) and the
    marker composition ys (S,) (host work, once per marker)."""
    y, y2 = _mix_table(lib, ys)
    rgas = float((np.asarray(ys, np.float64)
                  * lib.ri.double().cpu().numpy()).sum())
    kw = dict(dtype=lib.dtype, device=lib.device)
    return TotalConditions(
        y=torch.as_tensor(y).to(**kw), y2=torch.as_tensor(y2).to(**kw),
        t0=float(lib.t0), dt=float(lib.dt), nt=int(lib.nt), rgas=rgas,
        htot=_mix_eval_np(lib, y, y2, float(ttot)), ttot=float(ttot),
        tmin=float(tmin))


def _h_mix(tc: TotalConditions, t):
    """Combined-table spline at t (the kernels' GetSpline arithmetic)."""
    tcl = torch.clamp(t, tc.t0, tc.t0 + (tc.nt - 1) * tc.dt)
    klo = torch.clamp(((tcl - tc.t0) / tc.dt).to(torch.int64) + 1,
                      1, tc.nt - 1)
    xk = tc.t0 + klo.to(t.dtype) * tc.dt
    a = (xk - tcl) / tc.dt
    b = (tcl - (xk - tc.dt)) / tc.dt
    return a * tc.y[klo - 1] + b * tc.y[klo] \
        + ((a * a * a - a) * tc.y2[klo - 1] + (b * b * b - b) * tc.y2[klo]) \
        * (tc.dt * tc.dt) / 6.0


def solve_plain(tc: TotalConditions, riemann, gamma, alpha):
    """Plain version of kernel K9: the inlet temperature (nV,)."""
    dtype = riemann.dtype
    eps4 = 4.0 * torch.finfo(dtype).eps
    gm1 = gamma - 1.0
    sec_tol = torch.tensor(tc.sec_tol, dtype=dtype, device=riemann.device)

    def f_of(t):
        cb = torch.sqrt(gamma * tc.rgas * t)
        vb = (riemann - 2.0 * cb / gm1) / alpha
        return _h_mix(tc, t) + 0.5 * vb * vb - tc.htot

    t = torch.full_like(riemann, tc.ttot)
    t_old = t + 1.0
    f_old = f_of(t_old)
    done = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(tc.sec_iters):
        if bool(done.all()):
            break
        fv = f_of(t)
        df = fv - f_old
        safe = torch.where(df == 0.0, torch.ones_like(df), df)
        t_new = t - fv * (t - t_old) / safe
        conv = torch.abs(t_new - t) < torch.maximum(sec_tol,
                                                    eps4 * torch.abs(t_new))
        t, t_old, f_old = (torch.where(done | conv, t, t_new),
                           torch.where(done, t_old, t),
                           torch.where(done, f_old, fv))
        done = done | conv
    if bool(done.all()):
        return t
    ta = torch.full_like(t, tc.tmin)
    tb = torch.full_like(t, tc.ttot)
    tm = 0.5 * (ta + tb)
    bdone = torch.zeros_like(done)
    for _ in range(tc.bis_iters):
        if bool(bdone.all()):
            break
        tmid = 0.5 * (ta + tb)
        fv = f_of(tmid)
        conv = torch.abs(fv) < tc.bis_tol
        hi = fv > 0.0
        keep = bdone | conv
        ta, tb = (torch.where(keep, ta, torch.where(hi, tmid, ta)),
                  torch.where(keep, tb, torch.where(hi, tb, tmid)))
        tm = torch.where(bdone, tm, tmid)
        bdone = keep
    return torch.where(done, t, tm)


def solve(tc: TotalConditions, riemann, gamma, alpha):
    """The inlet temperature (nV,): kernel K9 on CUDA tensors, the plain
    version on CPU tensors."""
    if riemann.is_cuda:
        from su2_tpu_torch import kernels
        return kernels.inlet_tc(tc, riemann, gamma, alpha)
    return solve_plain(tc, riemann, gamma, alpha)
