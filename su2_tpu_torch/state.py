"""Flow state: conserved/primitive layouts and conversions (torch).

Port of the JAX package's state module (CReactiveEulerVariable /
CReactiveNSVariable state handling, variable_direct_reactive.cpp):

  U = [rho, rho*u, rho*v, (rho*w), rho*E, rho_1, ..., rho_Ns]   nVar = Ns+nDim+2
  V = [T, u, v, (w), P, rho, h_tot, a, Y_1, ..., Y_Ns]          nPrim = Ns+nDim+5

The temperature comes from a secant on the enthalpy spline seeded by the
previous temperature, with a bisection fallback (secant 7 its tol 1e-6 +
bisection 32 its tol 1e-4, variable_direct_reactive.cpp:385-390).

``node_state`` / ``node_state_lite`` run the whole per-node preprocessing
pass; on CUDA tensors they launch kernel T2 (csrc/node_state.cu), on CPU
tensors the plain chain below.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.chemistry.library import ChemLib

EPS = 1e-16


@dataclass(frozen=True)
class Layout:
    """Static index layout for a given (ndim, nspecies)."""
    ndim: int
    ns: int

    RHO = 0
    RHOVX = 1
    T = 0
    VX = 1

    @property
    def RHOE(self):
        return 1 + self.ndim

    @property
    def RHOS(self):
        return 2 + self.ndim

    @property
    def nvar(self):
        return self.ns + self.ndim + 2

    @property
    def P(self):
        return self.ndim + 1

    @property
    def PRHO(self):
        return self.ndim + 2

    @property
    def H(self):
        return self.ndim + 3

    @property
    def A(self):
        return self.ndim + 4

    @property
    def YS(self):
        return self.ndim + 5

    @property
    def nprim(self):
        return self.ns + self.ndim + 5


@dataclass(frozen=True)
class TSolveParams:
    tmin: float = 200.0
    tmax: float = 6000.0
    clip_temp: bool = False       # CLIPPING_TEMPRATURE cfg flag
    secant_iters: int = 7
    secant_tol: float = 1.0e-6
    bisect_iters: int = 32
    bisect_tol: float = 1.0e-4


def solve_temperature(lib: ChemLib, c1, c2, ys, t_init, p: TSolveParams):
    """Solve T - C1 - C2*h(T,Y) = 0 per cell (Cons2PrimVar secant +
    bisection, variable_direct_reactive.cpp:398-502), branchless per cell.
    Plain torch throughout: this is the reference of kernel T2.
    Returns (T, converged_by_secant mask)."""
    h_mix = cl.mixture_enthalpy_plain
    eps4 = 4.0 * float(torch.finfo(t_init.dtype).eps)
    t = t_init
    t_old = t_init + 1.0
    h_old = h_mix(lib, t_old, ys)
    done = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(p.secant_iters):
        f = t - c1 - c2 * h_mix(lib, t, ys)
        f_old = t_old - c1 - c2 * h_old
        df = f - f_old
        safe_df = torch.where(df == 0.0, 1.0, df)
        t_new = t - f * (t - t_old) / safe_df
        t_new = torch.where(df == 0.0, t, t_new)
        t_new = torch.clamp(t_new, -1.0e8, 1.0e8)
        converged = torch.abs(t_new - t) \
            < torch.clamp(eps4 * torch.abs(t_new), min=p.secant_tol)
        h_next = torch.where(done, h_old, (t - c1 - f) / c2)
        t_old = torch.where(done, t_old, t)
        t = torch.where(done | converged, t, t_new)
        h_old = h_next
        done = done | converged
    # bisection fallback on [Tmin, Tmax] (per cell: its value is used only
    # where the secant failed)
    ta = torch.full_like(t, p.tmin)
    tb = torch.full_like(t, p.tmax)
    tbis = 0.5 * (ta + tb)
    bis_done = torch.zeros_like(done)
    for _ in range(p.bisect_iters):
        tm = 0.5 * (ta + tb)
        f = tm - c1 - c2 * h_mix(lib, tm, ys)
        converged = (torch.abs(f) < p.bisect_tol) \
            | ((tb - ta) < eps4 * torch.abs(tm))
        go_low = f > 0.0
        hold = bis_done | converged
        ta_n = torch.where(hold, ta, torch.where(go_low, tm, ta))
        tb_n = torch.where(hold, tb, torch.where(go_low, tb, tm))
        tbis = torch.where(bis_done, tbis, tm)
        ta, tb = ta_n, tb_n
        bis_done = hold
    return torch.where(done, t, tbis), done


def cons2prim(lib: ChemLib, lay: Layout, u, t_guess, p: TSolveParams,
              turb_ke=None, first_iter: bool = False):
    """Batched Cons2PrimVar (variable_direct_reactive.cpp:325-561).
    Returns (u_clipped, v, nonphys_mask)."""
    n = u.shape[0]
    rho_s = u[:, lay.RHOS:lay.RHOS + lay.ns]
    nonphys = (rho_s < 0.0).any(dim=1)
    rho_s = torch.where(rho_s < 0.0, 1.0e-30, rho_s)

    rho = u[:, lay.RHO]
    nonphys = nonphys | (rho < EPS)
    rho = torch.clamp(rho, min=EPS)

    ys = rho_s / rho[:, None]
    nonphys = nonphys | (torch.abs(ys.sum(1) - 1.0) > 0.1)

    vel = u[:, lay.RHOVX:lay.RHOVX + lay.ndim] / rho[:, None]
    sqvel = (vel * vel).sum(1)

    rho_e = u[:, lay.RHOE]
    if turb_ke is not None:
        rho_e = rho_e - rho * turb_ke

    rgas = cl.mixture_rgas(lib, ys)
    c1 = (-rho_e + 0.5 * rho * sqvel) / (rho * rgas)
    c2 = 1.0 / rgas

    t, _ = solve_temperature(lib, c1, c2, ys, t_guess, p)
    if p.clip_temp and not first_iter:
        t = torch.clamp(t, 0.95 * t_guess, 1.05 * t_guess)

    nonphys = nonphys | (t < p.tmin) | (t > p.tmax)
    t = torch.clamp(t, p.tmin, p.tmax)

    press = rho * rgas * t
    nonphys = nonphys | (press < EPS)
    press = torch.clamp(press, min=EPS)

    gamma, _ = cl.frozen_gamma_sound(lib, t, ys)
    sound = torch.sqrt(gamma * press / rho)
    nonphys = nonphys | (sound < EPS)
    sound = torch.clamp(sound, min=EPS)

    htot = (u[:, lay.RHOE] + press) / rho
    v = torch.cat([t[:, None], vel, press[:, None], rho[:, None],
                   htot[:, None], sound[:, None], ys], dim=1)
    u_clipped = torch.cat([rho[:, None], u[:, lay.RHOVX:lay.RHOS], rho_s],
                          dim=1)
    return u_clipped, v, nonphys


@dataclass(frozen=True)
class NodeState:
    """All per-node derived state of one preprocessing pass
    (SetPrimitive_Variables + CalcdTdU/CalcdPdU + transport)."""
    u: torch.Tensor        # clipped conserved (N, nVar)
    v: torch.Tensor        # primitives (N, nPrim)
    nonphys: torch.Tensor  # (N,) bool
    dtdu: torch.Tensor     # (N, nVar)
    dpdu: torch.Tensor     # (N, nVar)
    mu: torch.Tensor       # (N,) laminar viscosity
    kappa: torch.Tensor    # (N,) conductivity
    xs: torch.Tensor       # (N, S) mole fractions


@dataclass(frozen=True)
class NodeStateLite:
    """Reduced bundle for the turbulence phase: v, X_s, mu and
    dP/dU[RHOE] = gamma - 1."""
    u: torch.Tensor
    v: torch.Tensor
    nonphys: torch.Tensor
    gm1: torch.Tensor      # (N,)
    mu: torch.Tensor
    xs: torch.Tensor


def node_state_plain(lib, lay, u, t_guess, p: TSolveParams, turb_ke=None):
    """Plain chain of kernel T2 (full variant)."""
    uc, v, nonphys = cons2prim(lib, lay, u, t_guess, p, turb_ke=turb_ke)
    t = v[:, lay.T]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    return NodeState(
        uc, v, nonphys, dtdu(lib, lay, v), dpdu(lib, lay, v),
        cl.mixture_viscosity(lib, t, ys), cl.mixture_conductivity(lib, t, ys),
        cl.molar_from_mass(lib, ys))


def node_state_lite_plain(lib, lay, u, t_guess, p: TSolveParams,
                          turb_ke=None):
    """Plain chain of kernel T2 (lite variant)."""
    uc, v, nonphys = cons2prim(lib, lay, u, t_guess, p, turb_ke=turb_ke)
    t = v[:, lay.T]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    gamma, _ = cl.frozen_gamma_sound(lib, t, ys)
    return NodeStateLite(uc, v, nonphys, gamma - 1.0,
                         cl.mixture_viscosity(lib, t, ys),
                         cl.molar_from_mass(lib, ys))


def _check_tsolve(p: TSolveParams):
    if p.clip_temp:
        raise NotImplementedError(
            "CLIPPING_TEMPRATURE= YES: not ported; su2_tpu.state.cons2prim "
            "has it")


def node_state(lib: ChemLib, lay: Layout, u, t_guess, p: TSolveParams,
               turb_ke=None) -> NodeState:
    """One preprocessing pass: Cons2Prim + dT/dU + dP/dU + Wilke transport +
    mole fractions.  CUDA tensors go through kernel T2."""
    _check_tsolve(p)
    if u.is_cuda:
        from su2_tpu_torch import kernels
        return NodeState(*kernels.node_state(lib, lay, p, u, t_guess,
                                             turb_ke, lite=False))
    return node_state_plain(lib, lay, u, t_guess, p, turb_ke)


def node_state_lite(lib: ChemLib, lay: Layout, u, t_guess, p: TSolveParams,
                    turb_ke=None) -> NodeStateLite:
    """Reduced preprocessing pass for the turbulence phase (kernel T2 with
    its lite flag on CUDA tensors)."""
    _check_tsolve(p)
    if u.is_cuda:
        from su2_tpu_torch import kernels
        return NodeStateLite(*kernels.node_state(lib, lay, p, u, t_guess,
                                                 turb_ke, lite=True))
    return node_state_lite_plain(lib, lay, u, t_guess, p, turb_ke)


def dtdu(lib: ChemLib, lay: Layout, v) -> torch.Tensor:
    """dT/dU (CalcdTdU, variable_direct_reactive.cpp:786-816). (N, nVar)."""
    t = v[:, lay.T]
    rho = v[:, lay.PRHO]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    cp = cl.mixture_cp(lib, t, ys)
    cv = cp - cl.mixture_rgas(lib, ys)
    rho_cv = rho * cv
    sqvel = (vel * vel).sum(1)
    e_s = cl.species_energy(lib, t)
    return torch.cat([(0.5 * sqvel / rho_cv)[:, None], -vel / rho_cv[:, None],
                      (1.0 / rho_cv)[:, None], -e_s / rho_cv[:, None]], dim=1)


def dpdu(lib: ChemLib, lay: Layout, v) -> torch.Tensor:
    """dP/dU (CalcdPdU, variable_direct_reactive.cpp:822-849). (N, nVar)."""
    t = v[:, lay.T]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    gamma, _ = cl.frozen_gamma_sound(lib, t, ys)
    sqvel = (vel * vel).sum(1)
    e_s = cl.species_energy(lib, t)
    return torch.cat([((gamma - 1.0) * 0.5 * sqvel)[:, None],
                      (1.0 - gamma)[:, None] * vel, (gamma - 1.0)[:, None],
                      lib.ri * t[:, None] - (gamma - 1.0)[:, None] * e_s],
                     dim=1)
