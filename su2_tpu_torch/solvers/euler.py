"""Reactive Euler layer, explicit subset (torch): weak boundary states,
the chemistry source and the explicit update.

Port of the parts of the JAX package's solvers/euler.py that the explicit
REACTIVE_RANS step runs (CReactiveEulerSolver,
solver_direct_reactive.cpp:24-4129).  Sign convention as the reference:
the residual R(U) accumulates edge fluxes (+ at edge node i, - at j), weak
BC fluxes and sources; the explicit update is U <- clip(U - R dt/Vol).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.chemistry.library import ChemLib
from su2_tpu_torch.config import Config
from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.ops import gradients
from su2_tpu_torch.state import Layout, TSolveParams

EPS = 1e-16


@dataclass(frozen=True)
class BCMarker:
    kind: str                 # isothermal_wall | heatflux_wall | euler_wall
    #                           | inlet | outlet
    tag: str
    inlet_mode: str           # TEMPERATURE_IMPOSE | MASS_FLOW
    nodes: torch.Tensor       # (nV,) int64
    normal: torch.Tensor      # (nV, d) stored (inward) vertex normals
    params: dict              # kind-specific floats / tensors
    nn: torch.Tensor | None = None  # (nV,) normal-neighbour node ids


def build_bc_markers(cfg: Config, lib: ChemLib, mesh: MeshArrays,
                     lay: Layout) -> tuple[BCMarker, ...]:
    """Boundary markers of the cfg (the kinds the explicit REACTIVE_RANS
    path supports; the others raise)."""
    dtype, device = mesh.coords.dtype, mesh.coords.device
    out = []

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype)

    def geom(tag):
        nodes, normal = mesh.markers[tag]
        return dict(nodes=nodes, normal=normal, nn=mesh.marker_nn[tag])

    unported = {"MARKER_SUPERSONIC_INLET": cfg.marker_supersonic_inlet,
                "MARKER_SUPERSONIC_OUTLET": cfg.marker_supersonic_outlet,
                "MARKER_RIEMANN": cfg.marker_riemann,
                "MARKER_FAR": cfg.marker_far,
                "MARKER_ENGINE_EXHAUST": cfg.marker_engine_exhaust,
                "MARKER_ENGINE_INFLOW": cfg.marker_engine_inflow}
    for key, val in unported.items():
        if val:
            raise NotImplementedError(
                f"{key}: not ported; su2_tpu.solvers.euler has it")
    for tag in list(cfg.marker_euler) + list(cfg.marker_sym):
        out.append(BCMarker("euler_wall", tag, "", params={}, **geom(tag)))
    for tag, temp in cfg.marker_isothermal.items():
        out.append(BCMarker("isothermal_wall", tag, "",
                            params={"twall": float(temp)}, **geom(tag)))
    for tag, flux in cfg.marker_heatflux.items():
        out.append(BCMarker("heatflux_wall", tag, "",
                            params={"qwall": float(flux)}, **geom(tag)))
    for tag, (v1, v2, fdir) in cfg.marker_inlet.items():
        if cfg.inlet_type not in ("TEMPERATURE_IMPOSE", "MASS_FLOW"):
            raise NotImplementedError(
                f"INLET_TYPE= {cfg.inlet_type}: not ported; "
                "su2_tpu.solvers.euler.inlet_state has it")
        ys = cfg.inlet_mass_frac.get(tag, cfg.freestream_mass_frac)
        out.append(BCMarker(
            "inlet", tag, cfg.inlet_type,
            params={"v1": float(v1), "v2": float(v2),
                    "flow_dir": f(fdir[:lay.ndim]), "ys": f(ys)},
            **geom(tag)))
    for tag, pback in cfg.marker_outlet.items():
        out.append(BCMarker("outlet", tag, "",
                            params={"p_exit": float(pback)}, **geom(tag)))
    return tuple(out)


def _prim_row(t, vel, p, rho, h, a, ys):
    """Assemble (nV, nPrim) primitive rows."""
    return torch.cat([t[:, None], vel, p[:, None], rho[:, None], h[:, None],
                      a[:, None], ys], dim=1)


def euler_wall_residual(lib, lay, nodes, normal, v, turb_ke=None):
    """Weak slip wall: pressure (+ 2/3 rho k) flux on momentum
    (BC_Euler_Wall, solver_direct_reactive.cpp:2881-2995)."""
    area = torch.linalg.norm(normal, dim=1)
    unit = -normal / area[:, None]
    vn = v[nodes]
    tke = turb_ke[nodes] if turb_ke is not None else 0.0
    coeff = (vn[:, lay.P] + 2.0 / 3.0 * vn[:, lay.PRHO] * tke) * area
    res = torch.zeros((nodes.shape[0], lay.nvar), dtype=v.dtype,
                      device=v.device)
    res[:, lay.RHOVX:lay.RHOVX + lay.ndim] = coeff[:, None] * unit
    return res


def inlet_state(lib, lay, bc: BCMarker, v, dpdu_e, tke_inf):
    """V_inlet ghost state (BC_Inlet, solver_direct_reactive.cpp:3226-3580)
    for TEMPERATURE_IMPOSE and MASS_FLOW."""
    nodes = bc.nodes
    nv = nodes.shape[0]
    vd = v[nodes]
    ys = bc.params["ys"].expand(nv, lay.ns)
    fdir_r = bc.params["flow_dir"].expand(nv, lay.ndim)
    full = lambda x: torch.full((nv,), x, dtype=v.dtype, device=v.device)
    vel_mag = full(bc.params["v2"])
    velb = vel_mag[:, None] * fdir_r
    p = vd[:, lay.P]
    rgas = cl.mixture_rgas(lib, ys)
    if bc.inlet_mode == "TEMPERATURE_IMPOSE":
        temp = full(bc.params["v1"])
        rho = p / (rgas * temp)
    else:                                   # MASS_FLOW (:3490-3560)
        rho = full(bc.params["v1"])
        temp = p / (rgas * rho)
    h = cl.mixture_enthalpy(lib, temp, ys) + tke_inf + 0.5 * vel_mag ** 2
    gamma, a = cl.frozen_gamma_sound(lib, temp, ys)
    return _prim_row(temp, velb, p, rho, h, a, ys), gamma, vel_mag ** 2


def outlet_state(lib, lay, bc: BCMarker, v, dpdu_e, tke_inf):
    """V_outlet ghost state (BC_Outlet, solver_direct_reactive.cpp
    :3808-3935): supersonic exit copies the domain state; subsonic imposes
    the back pressure via entropy + Riemann invariant extrapolation."""
    nodes = bc.nodes
    nd = lay.ndim
    area = torch.linalg.norm(bc.normal, dim=1)
    unit = -bc.normal / area[:, None]
    vd = v[nodes]
    rho_d = vd[:, lay.PRHO]
    p_d = vd[:, lay.P]
    vel_d = vd[:, lay.VX:lay.VX + nd]
    vel2_d = (vel_d * vel_d).sum(1)
    gamma = dpdu_e[nodes] + 1.0
    a_d = torch.sqrt(gamma * p_d / rho_d)
    mach = torch.sqrt(vel2_d) / a_d
    supersonic = mach >= 1.0

    gm1 = gamma - 1.0
    entropy = p_d * (1.0 / rho_d) ** gamma
    vn = (vel_d * unit).sum(1)
    riemann = vn + 2.0 * a_d / gm1
    p_exit = bc.params["p_exit"]
    rho_b = (p_exit / entropy) ** (1.0 / gamma)
    a_b = torch.sqrt(gamma * p_exit / rho_b)
    vn_exit = riemann - 2.0 * a_b / gm1
    vel_b = vel_d + (vn_exit - vn)[:, None] * unit
    vel2_b = (vel_b * vel_b).sum(1)
    ys = vd[:, lay.YS:lay.YS + lay.ns]
    rgas = cl.mixture_rgas(lib, ys)
    t_b = p_exit / (rho_b * rgas)
    h_b = cl.mixture_enthalpy(lib, t_b, ys) + tke_inf + 0.5 * vel2_b
    p_full = torch.full_like(p_d, p_exit)
    v_sub = _prim_row(t_b, vel_b, p_full, rho_b, h_b, a_b, ys)
    v_out = torch.where(supersonic[:, None], vd, v_sub)
    return v_out, gamma, torch.where(supersonic, vel2_d, vel2_b), supersonic


@dataclass(frozen=True)
class FluxBCBatch:
    """Ghost states of all weak flux-BC markers, concatenated in marker
    order (the flow phase hands them to the turbulence BCs, the reference's
    CharacPrimVar handoff)."""
    nodes: torch.Tensor
    nn: torch.Tensor
    normal: torch.Tensor
    v_ghost: torch.Tensor
    gamma: torch.Tensor
    vel2: torch.Tensor


def flux_bc_batch(lib, lay, bcs, v, dpdu_full, tke_inf):
    """One concatenated batch over every weak flux-BC marker, or None."""
    dpdu_e = dpdu_full[:, lay.RHOE]
    parts = []
    for bc in bcs:
        if bc.kind == "inlet":
            v_ghost, gamma, vel2 = inlet_state(lib, lay, bc, v, dpdu_e,
                                               tke_inf)
        elif bc.kind == "outlet":
            v_ghost, gamma, vel2, _ = outlet_state(lib, lay, bc, v, dpdu_e,
                                                   tke_inf)
        else:
            continue
        parts.append((bc.nodes, bc.nn, bc.normal, v_ghost, gamma, vel2))
    if not parts:
        return None
    return FluxBCBatch(*(torch.cat(list(x), dim=0) for x in zip(*parts)))


@dataclass(frozen=True)
class EulerParams:
    lay: Layout
    tparams: TSolveParams
    m_infty: float
    cfl: float
    max_dt: float
    grad_method: str           # GREEN_GAUSS | WEIGHTED_LEAST_SQUARES
    reactive_sources: bool
    pasr: bool
    pasr_lb: float
    c_mu: float = 0.09
    tke_inf: float = 0.0


def compute_gradients(mesh, prm: EulerParams, q):
    """GG/WLS gradients (nP, nG, d) of the variable set q (nP, nG)."""
    if gradients.GRAD_METHOD_MODE.get(prm.grad_method, "WLS") == "GG":
        return gradients.green_gauss(mesh, q)
    return gradients.weighted_least_squares(mesh, q)


def chemistry_source_plain(lib, prm, t, rho, ys, omega_turb=None):
    """Species production omega_s (N, S): Arrhenius rates, Keq, PaSR
    (reference reacting_model_library.cpp:99-227, :835-920) — the plain
    version of kernel T4."""
    rf, rb, _ = cl.reaction_rates(lib, t, rho, ys)
    om = cl.omega_tensor(lib, rf, rb)
    if prm.pasr and omega_turb is not None:
        dfr = cl.dfr_drho(lib, rf, rb, rho, ys)
        k = cl.pasr_constants(lib, dfr, omega_turb, prm.c_mu, prm.pasr_lb)
        return cl.mass_production(lib, om, k)
    return cl.mass_production(lib, om)


def chemistry_source_residual(lib, lay, mesh, prm, v, omega_turb=None):
    """CSourceReactive::ComputeChemistry residual part
    (numerics_direct_reactive.cpp:1728-1824): R_s = -omega_s * Vol.
    CUDA tensors go through kernel T4."""
    t = v[:, lay.T]
    rho = v[:, lay.PRHO]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    omt = omega_turb if prm.pasr else None
    if v.is_cuda:
        from su2_tpu_torch import kernels
        omega = kernels.chem_source(lib, prm, t, rho, ys, omt)
    else:
        omega = chemistry_source_plain(lib, prm, t, rho, ys, omt)
    zero = torch.zeros((v.shape[0], lay.RHOS), dtype=v.dtype, device=v.device)
    return torch.cat([zero, -omega * mesh.volume[:, None]], dim=1)


def clip_limits(lay: Layout, dtype, device="cpu"):
    """Per-variable solution bounds (solver_direct_reactive.cpp:298-302)."""
    lower = np.zeros(lay.nvar)
    lower[lay.RHOVX:lay.RHOVX + lay.ndim] = -1.0 / EPS
    lower[lay.RHOE] = -1.0 / EPS
    upper = np.full(lay.nvar, 1.0 / EPS)
    t = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    return t(lower), t(upper)


def explicit_euler_update(lay, mesh, u, res, dt, lower, upper, alpha=1.0):
    """U <- clip(U - alpha R dt/Vol) (ExplicitEuler_Iteration, :2414-2449);
    returns (U_new, RMS residual, max residual) per variable."""
    delta = torch.where(mesh.volume > EPS, dt / mesh.volume, 0.0)
    u_new = u - alpha * res * delta[:, None]
    u_new = torch.minimum(torch.maximum(u_new, lower), upper)
    rms = torch.sqrt((res * res).mean(0))
    rmax = torch.abs(res).amax(0)
    return u_new, rms, rmax
