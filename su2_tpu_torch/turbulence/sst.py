"""Menter SST k-omega turbulence model on stencil meshes (torch).

Port of the unfused stencil path of the JAX package's sst_step
(CTurbSSTSolver / CTurbSSTVariable and the SST numerics, reference
solver_direct_turbulent.cpp:2700-3454, numerics_direct_turbulent.cpp
:865-1006 and :1183-1257, variable_direct_turbulent.cpp:178-204) with the
MANGOTURB coupling conventions.  State q = (k, omega) primitive per node;
the update is conservative, k_new = (rho_old k_old + d(rho k))/rho_new.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.linalg import blockcsr, krylov
from su2_tpu_torch.state import Layout

EPS = 1e-16

SIGMA_K1 = 0.85
SIGMA_K2 = 1.0
SIGMA_OM1 = 0.5
SIGMA_OM2 = 0.856
BETA_1 = 0.075
BETA_2 = 0.0828
BETA_STAR = 0.09
A1 = 0.31
ALFA_1 = float(BETA_1 / BETA_STAR - SIGMA_OM1 * 0.41 ** 2
               / np.sqrt(BETA_STAR))
ALFA_2 = float(BETA_2 / BETA_STAR - SIGMA_OM2 * 0.41 ** 2
               / np.sqrt(BETA_STAR))

LOWER = (1.0e-10, 1.0e-4)
UPPER = (1.0e10, 1.0e15)


def freestream(cfg, rho_inf, vel_inf, mu_inf):
    """kine/omega/muT freestream (:2751-2755)."""
    vel_mag2 = float(np.dot(vel_inf, vel_inf))
    intensity = cfg.freestream_turbulenceintensity
    visc_ratio = cfg.freestream_turb2lamviscratio
    kine = 1.5 * vel_mag2 * intensity ** 2
    omega = rho_inf * kine / (mu_inf * visc_ratio)
    mu_t = rho_inf * kine / omega
    return kine, omega, mu_t


def strain_and_vorticity(lay: Layout, grad: torch.Tensor):
    """StrainMag and vorticity from the velocity rows of the NS gradient
    set (SetStrainMag/SetVorticity, variable_direct_reactive.cpp
    :1038-1095)."""
    return strain_and_vorticity_g(grad[:, 1:1 + lay.ndim, :])


def strain_and_vorticity_g(g: torch.Tensor):
    nd = g.shape[1]
    div = g[:, 0, 0]
    for d in range(1, nd):
        div = div + g[:, d, d]
    diag = sum((g[:, d, d] - div / 3.0) ** 2 for d in range(nd))
    off = sum(2.0 * (0.5 * (g[:, a, b] + g[:, b, a])) ** 2
              for a in range(nd) for b in range(a + 1, nd))
    strain = torch.sqrt(torch.clamp(2.0 * (diag + off), min=1e-60))
    if nd == 2:
        vort = torch.abs(g[:, 1, 0] - g[:, 0, 1])
    else:
        wx = g[:, 2, 1] - g[:, 1, 2]
        wy = g[:, 0, 2] - g[:, 2, 0]
        wz = g[:, 1, 0] - g[:, 0, 1]
        vort = torch.sqrt(wx * wx + wy * wy + wz * wz)
    return strain, vort


def blending(k, w, grad_k, grad_w, mu, rho, dist):
    """F1, F2, CDkw (SetBlendingFunc, variable_direct_turbulent.cpp
    :178-204)."""
    cdkw = 2.0 * rho * SIGMA_OM2 / w * (grad_k * grad_w).sum(1)
    cdkw = torch.clamp(cdkw, min=1e-20)
    arg2a = torch.sqrt(torch.clamp(k, min=1e-30)) \
        / (BETA_STAR * w * dist + EPS * EPS)
    arg2b = 500.0 * mu / (rho * dist * dist * w + EPS * EPS)
    arg2 = torch.maximum(arg2a, arg2b)
    arg1 = torch.minimum(arg2, 4.0 * rho * SIGMA_OM2 * k
                         / (cdkw * dist * dist + EPS * EPS))
    f1 = torch.tanh(torch.clamp(arg1, max=2.2) ** 4)
    f2 = torch.tanh(torch.clamp(torch.maximum(2.0 * arg2a, arg2b),
                                max=4.5) ** 2)
    return f1, f2, cdkw


def eddy_viscosity(rho, k, w, strain_mag, f2):
    """muT (Postprocessing, solver_direct_turbulent.cpp:2994-3000), clipped
    to [0, 1] like the fork."""
    zeta = torch.minimum(1.0 / w, A1 / (strain_mag * f2 + EPS))
    return torch.clamp(rho * k * zeta, 0.0, 1.0)


@dataclass(frozen=True)
class SSTConfig:
    grad_method: str
    cfl_red: float = 1.0
    relax: float = 1.0
    linear_solver: str = "FGMRES"
    linear_iter: int = 5
    linear_tol: float = 1e-6
    linear_prec: str = "JACOBI"


def _weak_bc_batch(lay, bcs, q, vel, rho, kine_inf, omega_inf, flow_fb):
    """Weak-BC face batch (bn, bflux (nb, 2), a0b (nb,)) or None: upwind
    flux between the domain state and the flow phase's ghost state (the
    reference's CharacPrimVar handoff, solver_direct_turbulent.cpp
    :3293,3381); inlets impose (kine_inf, omega_inf) on the incoming
    characteristic, outlets extrapolate."""
    if flow_fb is None:
        return None
    pos = 0
    bn_l, bnorm_l, velg_l, rhog_l, imp_l = [], [], [], [], []
    for bc in bcs:
        if bc.kind not in ("inlet", "outlet"):
            continue
        nv = bc.nodes.shape[0]
        v_ghost = flow_fb.v_ghost[pos:pos + nv]
        pos += nv
        bn_l.append(bc.nodes)
        bnorm_l.append(bc.normal)
        velg_l.append(v_ghost[:, lay.VX:lay.VX + lay.ndim])
        rhog_l.append(v_ghost[:, lay.PRHO])
        imp_l.append(torch.full((nv,), bc.kind == "inlet",
                                device=q.device))
    if not bn_l:
        return None
    bn = torch.cat(bn_l)
    area_n = -torch.cat(bnorm_l, dim=0)
    vel_g = torch.cat(velg_l, dim=0)
    rho_g = torch.cat(rhog_l)
    imposed = torch.cat(imp_l)
    qb = 0.5 * ((vel[bn] + vel_g) * area_n).sum(1)
    a0b = 0.5 * (qb + torch.abs(qb))
    a1b = 0.5 * (qb - torch.abs(qb))
    q_inf = torch.stack([torch.full_like(qb, kine_inf),
                         torch.full_like(qb, omega_inf)], dim=1)
    qin = torch.where(imposed[:, None], q_inf, q[bn])
    bflux = a0b[:, None] * rho[bn][:, None] * q[bn] \
        + a1b[:, None] * rho_g[:, None] * qin
    return bn, bflux, a0b


def sst_step(lay: Layout, mesh: MeshArrays, scfg: SSTConfig, bcs, q, v,
             mu, mu_t_node, strain_mag, dist, rho_old, dt, kine_inf,
             omega_inf, gq, gvel, flow_fb=None, gq_prev=None):
    """One implicit Euler iteration of the SST system on a stencil mesh.

    gq: this step's (k, omega) gradients (N, 2, d); gvel: velocity
    gradient block (N, nd, nd); gq_prev: the previous step's gradients,
    whose blending (the reference's stored F1/F2/CDkw) enters the assembly.
    Returns (q_new, rms, outs) with outs["gq"] = next step's gq_prev."""
    n = q.shape[0]
    dtype = q.dtype
    rho = v[:, lay.PRHO]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    grad_k, grad_w = gq[:, 0, :], gq[:, 1, :]
    bk, bw = (gq_prev[:, 0, :], gq_prev[:, 1, :]) if gq_prev is not None \
        else (grad_k, grad_w)
    f1, f2, cdkw = blending(q[:, 0], q[:, 1], bk, bw, mu, rho, dist)
    sigma_k_blend = f1 * SIGMA_K1 + (1.0 - f1) * SIGMA_K2
    sigma_w_blend = f1 * SIGMA_OM1 + (1.0 - f1) * SIGMA_OM2

    # convective + corrected viscous edge sides, enumerated per offset
    diff_k = mu + sigma_k_blend * mu_t_node
    diff_w = mu + sigma_w_blend * mu_t_node
    eye2 = torch.eye(2, dtype=dtype, device=q.device)
    rhoq = rho[:, None] * q
    dkw = torch.stack([diff_k, diff_w], dim=1)
    res = diag_c = None
    offs = []
    for k, o in enumerate(mesh.stencil_offsets):
        nsk = mesh.gg_snormal[k]
        pv = mesh.stencil_pvec[k]
        qt = 0.5 * ((vel + torch.roll(vel, -o, dims=0)) * nsk).sum(1)
        a0p = 0.5 * (qt + torch.abs(qt))
        a1p = 0.5 * (qt - torch.abs(qt))
        conv = a0p[:, None] * rhoq + a1p[:, None] \
            * torch.roll(rhoq, -o, dims=0)
        dm = 0.5 * (dkw + torch.roll(dkw, -o, dims=0))
        gmean = 0.5 * (gq + torch.roll(gq, -o, dims=0))
        evec = torch.roll(mesh.coords, -o, dims=0) - mesh.coords
        gm_e = (gmean * evec[:, None, :]).sum(2)
        dq = torch.roll(q, -o, dims=0) - q
        vflux = dm * ((gmean * nsk[:, None, :]).sum(2)
                      + pv[:, None] * (dq - gm_e))
        dvp = dm * (pv / rho)[:, None]
        dvn = dm * (pv / torch.roll(rho, -o))[:, None]
        part = conv - vflux
        res = part if res is None else res + part
        dpart = a0p[:, None] + dvp
        diag_c = dpart if diag_c is None else diag_c + dpart
        offs.append(a1p[:, None] - dvn)
    fam_off = torch.stack(offs)                                 # (K, nP, 2)
    diag = diag_c[:, :, None] * eye2

    # source (CSourcePieceWise_TurbSST)
    diverg = gvel[:, 0, 0]
    for d in range(1, lay.ndim):
        diverg = diverg + gvel[:, d, d]
    k_, w_ = q[:, 0], q[:, 1]
    alfa_b = f1 * ALFA_1 + (1.0 - f1) * ALFA_2
    beta_b = f1 * BETA_1 + (1.0 - f1) * BETA_2
    pk = mu_t_node * strain_mag ** 2 - 2.0 / 3.0 * rho * k_ * diverg
    pk = torch.minimum(torch.clamp(pk, min=0.0),
                       20.0 * BETA_STAR * rho * w_ * k_)
    zeta = torch.maximum(w_, strain_mag * f2 / A1)
    pw = torch.clamp(strain_mag ** 2 - 2.0 / 3.0 * zeta * diverg, min=0.0)
    active = dist > 1e-10
    src_k = torch.where(active, pk - BETA_STAR * rho * w_ * k_, 0.0)
    src_w = torch.where(active, alfa_b * rho * pw - beta_b * rho * w_ * w_
                        + (1.0 - f1) * cdkw, 0.0)
    vol = mesh.volume
    res = res - torch.stack([src_k * vol, src_w * vol], dim=1)
    sj00 = torch.where(active, -BETA_STAR * w_ * vol, 0.0)
    sj11 = torch.where(active, -2.0 * beta_b * w_ * vol, 0.0)
    diag = diag + torch.stack([torch.stack([-sj00, torch.zeros_like(sj00)], 1),
                               torch.stack([torch.zeros_like(sj11), -sj11], 1)],
                              dim=1)

    # strong walls: k = 0, omega = 60 mu/(rho beta1 d^2) at the nearest
    # interior neighbour
    wall_mask = torch.zeros(n, dtype=torch.bool, device=q.device)
    w_wall_full = torch.zeros(n, dtype=dtype, device=q.device)
    for bc in bcs:
        if bc.kind in ("isothermal_wall", "heatflux_wall"):
            nodes = bc.nodes
            dnn = torch.linalg.norm(mesh.coords[bc.nn] - mesh.coords[nodes],
                                    dim=1)
            w_wall = 60.0 * mu[bc.nn] / (rho[bc.nn] * BETA_1 * dnn * dnn)
            wall_mask[nodes] = True
            w_wall_full[nodes] = w_wall
    q_wall = torch.stack([torch.zeros_like(w_wall_full), w_wall_full], dim=1)
    wk = _weak_bc_batch(lay, bcs, q, vel, rho, kine_inf, omega_inf, flow_fb)
    if wk is not None:
        bn, bflux, a0b = wk
        res = res.index_add(0, bn, bflux)
        diag = diag.index_add(0, bn, a0b[:, None, None] * eye2)

    res = torch.where(wall_mask[:, None], 0.0, res)
    diag = torch.where(wall_mask[:, None, None], eye2[None], diag)
    fam_off = torch.where(wall_mask[None, :, None], 0.0, fam_off)

    # implicit solve
    ok = dt > EPS
    delta = torch.where(ok, vol / (scfg.cfl_red * torch.where(ok, dt, 1.0)),
                        0.0)
    diag = diag + delta[:, None, None] * eye2
    rhs = -res
    zrow = torch.zeros_like(fam_off[0, :, 0])[None]
    sel_rows = []
    for k in range(fam_off.shape[0]):
        sel_rows += [fam_off[k, :, 0][None], zrow, zrow,
                     fam_off[k, :, 1][None]]
    jac = blockcsr.StencilJacobianT(diag=diag, sel_t=torch.cat(sel_rows))
    if scfg.linear_solver != "FGMRES":
        raise NotImplementedError(
            f"LINEAR_SOLVER= {scfg.linear_solver}: not ported; "
            "su2_tpu.linalg.krylov has it")
    mv, pc = blockcsr.make_solver_ops_stencil_t(mesh, jac.diag, jac.sel_t,
                                                scfg.linear_prec)
    sol, _, _ = krylov.fgmres(mv, pc, rhs, max_iter=scfg.linear_iter,
                              tol=scfg.linear_tol)

    lower = torch.tensor(LOWER, dtype=dtype, device=q.device)
    upper = torch.tensor(UPPER, dtype=dtype, device=q.device)
    q_new = (rho_old[:, None] * q + scfg.relax * sol) / rho[:, None]
    q_new = torch.minimum(torch.maximum(q_new, lower), upper)
    q_wall_c = torch.minimum(torch.maximum(
        q_wall * (rho_old / rho)[:, None], lower), upper)
    q_new = torch.where(wall_mask[:, None], q_wall_c, q_new)
    rms = torch.sqrt((rhs * rhs).mean(0))

    f1n, f2n, cdkwn = blending(q_new[:, 0], q_new[:, 1], grad_k, grad_w,
                               mu, rho, dist)
    mu_t_new = eddy_viscosity(rho, q_new[:, 0], q_new[:, 1], strain_mag, f2n)
    outs = dict(mu_t=mu_t_new,
                sigma_k=f1n * SIGMA_K1 + (1.0 - f1n) * SIGMA_K2, gq=gq)
    return q_new, rms, outs


def wall_distance(coords: np.ndarray, wall_points: np.ndarray,
                  chunk: int = 4096) -> np.ndarray:
    """Distance of every node to the nearest no-slip wall vertex (chunked
    point-based ComputeWall_Distance; the GEMM form from 200k nodes up,
    as in the JAX package)."""
    if wall_points.shape[0] == 0:
        return np.full(coords.shape[0], 1e10)
    out = np.empty(coords.shape[0])
    if coords.shape[0] >= 200_000:
        w2 = (wall_points ** 2).sum(-1)
        for s in range(0, coords.shape[0], chunk):
            blk = coords[s:s + chunk]
            d2 = ((blk ** 2).sum(-1)[:, None] + w2[None, :]
                  - 2.0 * blk @ wall_points.T)
            out[s:s + chunk] = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
        return out
    for s in range(0, coords.shape[0], chunk):
        blk = coords[s:s + chunk]
        d2 = ((blk[:, None, :] - wall_points[None, :, :]) ** 2).sum(-1)
        out[s:s + chunk] = np.sqrt(d2.min(axis=1))
    return out
