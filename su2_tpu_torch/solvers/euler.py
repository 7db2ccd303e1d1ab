"""Reactive Euler layer (torch): weak boundary states and their dP/dU,
the slip-wall Jacobian, the chemistry source and its Jacobian, and the
explicit update.

Port of the parts of the JAX package's solvers/euler.py that the coupled
REACTIVE_RANS step runs, explicit and implicit flow (CReactiveEulerSolver,
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
from su2_tpu_torch.solvers import inlet_tc
from su2_tpu_torch.state import Layout, TSolveParams

EPS = 1e-16


@dataclass(frozen=True)
class BCMarker:
    kind: str                 # isothermal_wall | heatflux_wall | euler_wall
    #                           | inlet | outlet
    tag: str
    inlet_mode: str           # TEMPERATURE_IMPOSE | MASS_FLOW
    #                           | TOTAL_CONDITIONS
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
        if cfg.inlet_type not in ("TEMPERATURE_IMPOSE", "MASS_FLOW",
                                  "TOTAL_CONDITIONS"):
            raise NotImplementedError(
                f"INLET_TYPE= {cfg.inlet_type}: not ported; "
                "su2_tpu.solvers.euler.inlet_state has it")
        ys = cfg.inlet_mass_frac.get(tag, cfg.freestream_mass_frac)
        params = {"v1": float(v1), "v2": float(v2),
                  "flow_dir": f(fdir[:lay.ndim]), "ys": f(ys)}
        if cfg.inlet_type == "TOTAL_CONDITIONS":
            # v1 = T_tot, v2 = P_tot: the solve's host-side constants
            params["tc"] = inlet_tc.total_conditions_t(lib, ys, float(v1))
        out.append(BCMarker("inlet", tag, cfg.inlet_type, params=params,
                            **geom(tag)))
    for tag, pback in cfg.marker_outlet.items():
        out.append(BCMarker("outlet", tag, "",
                            params={"p_exit": float(pback)}, **geom(tag)))
    for bc in out:
        # add_rows scatters marker by marker: no node twice in one marker
        if bc.nodes.unique().numel() != bc.nodes.numel():
            raise ValueError(f"marker {bc.tag} lists a node twice")
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
    for the three subsonic inlet modes."""
    nodes = bc.nodes
    nv = nodes.shape[0]
    vd = v[nodes]
    ys = bc.params["ys"].expand(nv, lay.ns)
    fdir_r = bc.params["flow_dir"].expand(nv, lay.ndim)
    full = lambda x: torch.full((nv,), x, dtype=v.dtype, device=v.device)
    if bc.inlet_mode == "TOTAL_CONDITIONS":
        return _total_conditions_state(lib, lay, bc, v, vd, ys, full,
                                       dpdu_e, tke_inf)
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


def _total_conditions_state(lib, lay, bc, v, vd, ys, full, dpdu_e,
                            tke_inf):
    """TOTAL_CONDITIONS branch (:3226-3489): the Riemann invariant of the
    domain state with the mean of the domain and total-state gammas, the
    inlet temperature by the secant/bisection of solvers/inlet_tc.py
    (kernel K9 on the card), then the isentropic static state."""
    ttot, ptot = bc.params["v1"], bc.params["v2"]
    fdir = bc.params["flow_dir"]
    area = torch.linalg.norm(bc.normal, dim=1)
    unit = -bc.normal / area[:, None]                     # outward
    vn = (vd[:, lay.VX:lay.VX + lay.ndim] * unit).sum(1)
    gamma_node = dpdu_e[bc.nodes] + 1.0
    gamma_tot = cl.frozen_gamma_sound(lib, full(ttot), ys)[0]
    gamma = 2.0 / (1.0 / gamma_node + 1.0 / gamma_tot)
    gm1 = gamma - 1.0
    riemann = vn + 2.0 * vd[:, lay.A] / gm1
    tot_enthalpy = cl.mixture_enthalpy(lib, full(ttot), ys)
    alpha = (unit * fdir).sum(1)
    rgas = cl.mixture_rgas(lib, ys)
    t_b = inlet_tc.solve(bc.params["tc"], riemann, gamma, alpha)
    htot = tot_enthalpy + tke_inf
    rho_tot = ptot / (rgas * ttot)
    rho = rho_tot * (t_b / ttot) ** (1.0 / gm1)
    p = rho * rgas * t_b
    a = torch.sqrt(t_b * gamma * rgas)
    vel_mag = torch.abs((riemann - 2.0 * a / gm1) / alpha)
    velb = vel_mag[:, None] * fdir
    return _prim_row(t_b, velb, p, rho, htot, a, ys), gamma, vel_mag ** 2


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
    CharacPrimVar handoff).  seg: each marker's vertex count."""
    nodes: torch.Tensor
    nn: torch.Tensor
    normal: torch.Tensor
    v_ghost: torch.Tensor
    gamma: torch.Tensor
    vel2: torch.Tensor
    seg: tuple


def add_rows(x, nodes, vals, seg=None):
    """x[nodes] += vals with the batch's rows added in order, as the JAX
    package's .at[].add does on the CPU, and without atomics: one gather,
    add and index_put per marker (seg: the markers' row counts; None for
    one marker), each marker's nodes being distinct (build_bc_markers).
    A node that two markers share gets (x + a) + b."""
    pos = 0
    for m in (nodes.shape[0],) if seg is None else seg:
        idx = nodes[pos:pos + m]
        x = x.index_put((idx,), x[idx] + vals[pos:pos + m])
        pos += m
    return x


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
    return FluxBCBatch(*(torch.cat(list(x), dim=0) for x in zip(*parts)),
                       seg=tuple(int(x[0].shape[0]) for x in parts))


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
    # MUSCL reconstruction of the implicit flow's face states
    muscl: bool = False
    use_limiter: bool = False
    limiter_kind: str = "VENKATAKRISHNAN"   # | BARTH_JESPERSEN
    limiter_coeff: float = 0.5
    ref_elem_length: float = 0.1


def gradient_vars(lay: Layout, v):
    """[T, u, v, (w), P]: the Euler gradient and limiter variable set."""
    return torch.cat([v[:, lay.T:lay.T + 1], v[:, lay.VX:lay.VX + lay.ndim],
                      v[:, lay.P:lay.P + 1]], dim=1)


def ghost_dpdu(lib, lay, v_ghost, gamma, vel2):
    """dP/dU of a state with known gamma (the BC 'Secondary'), (nV, nVar)."""
    t = v_ghost[:, lay.T]
    e_s = cl.species_energy(lib, t)
    gm1 = gamma - 1.0
    return torch.cat([
        (gm1 * 0.5 * vel2)[:, None],
        (1.0 - gamma)[:, None] * v_ghost[:, lay.VX:lay.VX + lay.ndim],
        gm1[:, None], lib.ri * t[:, None] - gm1[:, None] * e_s], dim=1)


def row_gamma_vel2(lay, vrow):
    """gamma = a^2 rho / P and |v|^2 of primitive rows (nV, nPrim)."""
    gamma = vrow[:, lay.A] ** 2 * vrow[:, lay.PRHO] / vrow[:, lay.P]
    vel = vrow[:, lay.VX:lay.VX + lay.ndim]
    return gamma, (vel * vel).sum(1)


def euler_wall_jacobian(lay, normal, dpdu_rows):
    """d(pressure wall flux)/dU (BC_Euler_Wall implicit part, :2950-2974):
    the momentum rows (-normal) (x) dP/dU of the wall nodes; normal
    (nV, d), dpdu_rows (nV, nVar) -> (nV, nVar, nVar)."""
    area = torch.linalg.norm(normal, dim=1)
    unit = -normal / area[:, None]
    contrib = (unit * area[:, None])[:, :, None] * dpdu_rows[:, None, :]
    nv = normal.shape[0]
    z = lambda m: torch.zeros((nv, m, lay.nvar), dtype=normal.dtype,
                              device=normal.device)
    return torch.cat([z(lay.RHOVX), contrib,
                      z(lay.nvar - lay.RHOVX - lay.ndim)], dim=1)


def compute_gradients(mesh, prm: EulerParams, q):
    """GG/WLS gradients (nP, nG, d) of the variable set q (nP, nG); in the
    >= TILED_MIN_NODES tier the node-major view of the rows sweep, as the
    JAX package routes every sweep there through its tiled kernel."""
    if gradients.use_tiled(mesh):
        return gradients.rows_to_grad(compute_gradient_rows(mesh, prm, q),
                                      q.shape[1], mesh.ndim)
    if gradients.GRAD_METHOD_MODE.get(prm.grad_method, "WLS") == "GG":
        return gradients.green_gauss(mesh, q)
    return gradients.weighted_least_squares(mesh, q)


def compute_gradient_rows(mesh, prm: EulerParams, q):
    """Feature-major (nG*d, nP) gradient rows (ops/gradients_tiled.py;
    kernel K7 on the card)."""
    return gradients.gradient_rows(mesh, q, prm.grad_method)


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


def chemistry_source_system(lib, lay, mesh, prm, v, dtdu_full,
                            omega_turb=None):
    """Source residual and its diagonal Jacobian (CSourceReactive::
    ComputeChemistry implicit part, numerics_direct_reactive.cpp:1826-1878)
    in plain torch ops, as the JAX package computes it: species rows only,
    J[s, :] = -(d omega_s/dT) dT/dU Vol, minus d omega_s/d rho_k Vol on the
    species columns."""
    t = v[:, lay.T]
    rho = v[:, lay.PRHO]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    rf, rb, kc = cl.reaction_rates(lib, t, rho, ys)
    om = cl.omega_tensor(lib, rf, rb)
    k = None
    if prm.pasr and omega_turb is not None:
        dfr = cl.dfr_drho(lib, rf, rb, rho, ys)
        k = cl.pasr_constants(lib, dfr, omega_turb, prm.c_mu, prm.pasr_lb)
    omega = cl.mass_production(lib, om, k)
    sjac = cl.source_jacobian(lib, t, rho, ys, rf, rb, kc, k)
    vol = mesh.volume
    n = v.shape[0]
    res = torch.cat([torch.zeros((n, lay.RHOS), dtype=v.dtype,
                                 device=v.device),
                     -omega * vol[:, None]], dim=1)
    rows = -(sjac[:, :, 0][:, :, None] * dtdu_full[:, None, :]) \
        * vol[:, None, None]                                   # (n, S, nVar)
    spec = rows[:, :, lay.RHOS:] + (-sjac[:, :, 1:] * vol[:, None, None])
    rows = torch.cat([rows[:, :, :lay.RHOS], spec], dim=2)
    diag = torch.cat([torch.zeros((n, lay.RHOS, lay.nvar), dtype=v.dtype,
                                  device=v.device), rows], dim=1)
    return res, diag


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
