"""Menter SST k-omega turbulence model (torch).

Port of the JAX package's sst_step (CTurbSSTSolver /
CTurbSSTVariable and the SST numerics, reference
solver_direct_turbulent.cpp:2700-3454, numerics_direct_turbulent.cpp
:865-1006 and :1183-1257, variable_direct_turbulent.cpp:178-204) with the
MANGOTURB coupling conventions: the unfused assembly in torch ops (per
stencil offset on stencil meshes, over the edge list elsewhere), and the
fused one on stencil meshes (set_assemble_mode("fused");
turbulence/sst_assemble.py, K12).
State q = (k, omega) primitive per node; the update is conservative,
k_new = (rho_old k_old + d(rho k))/rho_new.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.linalg import blockcsr, krylov
from su2_tpu_torch.linalg import stencil_solve as sts
from su2_tpu_torch.solvers import euler as es
from su2_tpu_torch.state import Layout
from su2_tpu_torch.turbulence import sst_assemble as sa

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

# the constants of the fused assembly, before CFL_red
_CONSTS = (SIGMA_K1, SIGMA_K2, SIGMA_OM1, SIGMA_OM2, BETA_1, BETA_2,
           BETA_STAR, A1, ALFA_1, ALFA_2)

# "unfused" (the default) or "fused": the one-launch assembly (K12) feeding
# the lane-layout stencil solve, where sst_step's gate holds.  Process-wide,
# as the reference's; the driver sets it from SU2_TPU_SST_ASSEMBLE.
_ASSEMBLE_MODE = "unfused"


def set_assemble_mode(mode: str) -> None:
    global _ASSEMBLE_MODE
    if mode not in ("unfused", "fused"):
        raise ValueError(f"SST assembly mode {mode!r}: 'unfused' or 'fused'")
    _ASSEMBLE_MODE = mode


def assemble_mode() -> str:
    return _ASSEMBLE_MODE


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
    colors: torch.Tensor | None = None     # (nP,) int8 sweep colors
    ncolor: int = 0


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
    """One implicit Euler iteration of the SST system.

    gq: this step's (k, omega) gradients (N, 2, d); gvel: velocity
    gradient block (N, nd, nd); gq_prev: the previous step's gradients,
    whose blending (the reference's stored F1/F2/CDkw) enters the assembly.
    In the fused mode, with FGMRES, LU_SGS/ILU0 and sweep colors, and on a
    stencil mesh where the reference has a full-field or windowed plan,
    the fused path runs (its gate, su2_tpu/turbulence/sst.py:204-215).
    On a mesh without a static stencil the edge sides are assembled over
    the edge list and the system is a BlockJacobian.
    Returns (q_new, rms, outs) with outs["gq"] = next step's gq_prev."""
    n = q.shape[0]
    dtype = q.dtype
    rho = v[:, lay.PRHO]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    grad_k, grad_w = gq[:, 0, :], gq[:, 1, :]
    bk, bw = (gq_prev[:, 0, :], gq_prev[:, 1, :]) if gq_prev is not None \
        else (grad_k, grad_w)
    f1, f2, cdkw = blending(q[:, 0], q[:, 1], bk, bw, mu, rho, dist)
    if (_ASSEMBLE_MODE == "fused" and scfg.linear_solver == "FGMRES"
            and scfg.linear_prec in ("LU_SGS", "ILU0")
            and scfg.colors is not None
            and mesh.stencil_offsets is not None
            and (sa.supported(n, len(mesh.stencil_offsets), lay.ndim)
                 or sa.tile_plan(n, mesh.stencil_offsets, lay.ndim)
                 is not None)):
        return _sst_step_fused(lay, mesh, scfg, bcs, q, v, mu, mu_t_node,
                               strain_mag, dist, rho_old, dt, kine_inf,
                               omega_inf, gq, gvel, flow_fb, f1, f2, cdkw)
    sigma_k_blend = f1 * SIGMA_K1 + (1.0 - f1) * SIGMA_K2
    sigma_w_blend = f1 * SIGMA_OM1 + (1.0 - f1) * SIGMA_OM2

    # convective + corrected viscous edge sides
    diff_k = mu + sigma_k_blend * mu_t_node
    diff_w = mu + sigma_w_blend * mu_t_node
    eye2 = torch.eye(2, dtype=dtype, device=q.device)
    sides = _stencil_sides if mesh.stencil_offsets is not None \
        else _edge_list_sides
    res, diag, off = sides(mesh, q, vel, rho, gq, diff_k, diff_w, eye2)

    # source (CSourcePieceWise_TurbSST)
    diverg = _divergence(gvel)
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

    wall_mask, q_wall = _wall_rows(mesh, bcs, mu, rho)
    wk = _weak_bc_batch(lay, bcs, q, vel, rho, kine_inf, omega_inf, flow_fb)
    if wk is not None:
        bn, bflux, a0b = wk
        res = es.add_rows(res, bn, bflux, flow_fb.seg)
        diag = es.add_rows(diag, bn, a0b[:, None, None] * eye2, flow_fb.seg)

    res = torch.where(wall_mask[:, None], 0.0, res)
    diag = torch.where(wall_mask[:, None, None], eye2[None], diag)

    # implicit solve
    ok = dt > EPS
    delta = torch.where(ok, vol / (scfg.cfl_red * torch.where(ok, dt, 1.0)),
                        0.0)
    diag = diag + delta[:, None, None] * eye2
    rhs = -res
    if mesh.stencil_offsets is not None:
        fam_off = torch.where(wall_mask[None, :, None], 0.0, off)
        zrow = torch.zeros_like(fam_off[0, :, 0])[None]
        sel_rows = []
        for k in range(fam_off.shape[0]):
            sel_rows += [fam_off[k, :, 0][None], zrow, zrow,
                         fam_off[k, :, 1][None]]
        ops = blockcsr.make_solver_ops_stencil_t(
            mesh, diag, torch.cat(sel_rows), scfg.linear_prec, scfg.colors,
            scfg.ncolor, linear_iter=scfg.linear_iter,
            solver=scfg.linear_solver)
    else:
        # the wall rows of the edge blocks: off_ij belongs to node i's
        # row, off_ji to node j's
        off_ij, off_ji = off
        iw = wall_mask[mesh.edges[:, 0]]
        jw = wall_mask[mesh.edges[:, 1]]
        jac = blockcsr.BlockJacobian(
            diag=diag, off_ij=torch.where(iw[:, None, None], 0.0, off_ij),
            off_ji=torch.where(jw[:, None, None], 0.0, off_ji))
        ops = blockcsr.make_solver_ops(
            mesh, jac, scfg.linear_prec, scfg.colors, scfg.ncolor,
            linear_iter=scfg.linear_iter, solver=scfg.linear_solver)
    # BCGSTAB, or FGMRES (one launch where the tier has it)
    sol = krylov.solve(scfg.linear_solver, ops, rhs, scfg.linear_iter,
                       scfg.linear_tol)
    rms = torch.sqrt((rhs * rhs).mean(0))
    q_new, outs = _update(scfg, q, sol, rho_old, rho, wall_mask, q_wall,
                          grad_k, grad_w, mu, dist, strain_mag, gq)
    return q_new, rms, outs


def _stencil_sides(mesh, q, vel, rho, gq, diff_k, diff_w, eye2):
    """(res, diag, fam_off (K, nP, 2)) of the convective and corrected
    viscous edge sides on a stencil mesh, enumerated per offset: with the
    signed face mass flux qt = 0.5 (u_p + u_{p+o}) . n_signed both sides
    of an edge take the same formulas, and the off-diagonal blocks (2 x 2
    diagonal) come out per offset."""
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
    return res, diag_c[:, :, None] * eye2, torch.stack(offs)


def _edge_list_sides(mesh, q, vel, rho, gq, diff_k, diff_w, eye2):
    """(res, diag, (off_ij, off_ji) (nE, 2, 2)) of the convective (upwind)
    and corrected viscous edge terms over the edge list (CUpwSca_TurbSST +
    CAvgGradCorrected_TurbSST, numerics_direct_turbulent.cpp:1183-1257):
    every node field gathered to both endpoints in one stacked matrix, the
    projected gradient g.n - (g.e) pv + (q_j - q_i) pv with
    pv = (e.n)/|e|^2, one scatter_edges for conv - visc and one
    accumulate_sides for the diagonal blocks."""
    d = mesh.ndim
    n = q.shape[0]
    feats = torch.cat([
        vel,                              # [0:d]
        rho[:, None],                     # [d]
        rho[:, None] * q,                 # [d+1 : d+3]
        gq.reshape(n, 2 * d),             # [d+3 : 3d+3]
        diff_k[:, None], diff_w[:, None],  # [3d+3], [3d+4]
        mesh.coords,                      # [3d+5 : 4d+5]
    ], dim=1)
    fi, fj = feats[mesh.edges[:, 0]], feats[mesh.edges[:, 1]]
    nrm = mesh.edge_normal
    qij = 0.5 * ((fi[:, :d] + fj[:, :d]) * nrm).sum(1)
    a0 = 0.5 * (qij + torch.abs(qij))
    a1c = 0.5 * (qij - torch.abs(qij))
    flux = a0[:, None] * fi[:, d + 1:d + 3] + a1c[:, None] * fj[:, d + 1:d + 3]
    dk = 0.5 * (fi[:, 3 * d + 3] + fj[:, 3 * d + 3])
    dw = 0.5 * (fi[:, 3 * d + 4] + fj[:, 3 * d + 4])
    gmean = 0.5 * (fi[:, d + 3:3 * d + 3]
                   + fj[:, d + 3:3 * d + 3]).reshape(-1, 2, d)
    evec = fj[:, 3 * d + 5:4 * d + 5] - fi[:, 3 * d + 5:4 * d + 5]
    dist2 = (evec * evec).sum(1)
    pvec = (evec * nrm).sum(1) / torch.where(dist2 == 0.0, 1.0, dist2)
    proj = (gmean * nrm[:, None, :]).sum(2)
    gm_e = (gmean * evec[:, None, :]).sum(2)
    dq = fj[:, d + 1:d + 3] / fj[:, d:d + 1] - fi[:, d + 1:d + 3] / fi[:, d:d + 1]
    proj = proj + pvec[:, None] * (dq - gm_e)
    vflux = torch.stack([dk * proj[:, 0], dw * proj[:, 1]], dim=1)
    res = mesh.scatter_edges(flux - vflux)
    dvi = torch.stack([dk * pvec / fi[:, d], dw * pvec / fi[:, d]], dim=1)
    dvj = torch.stack([dk * pvec / fj[:, d], dw * pvec / fj[:, d]], dim=1)
    # viscous Jacobians J_i = -diag(dvi), J_j = +diag(dvj); the residual is
    # subtracted, so node i's diagonal gets +diag(dvi)
    acc = mesh.accumulate_sides(torch.cat([a0[:, None], dvi], dim=1),
                                torch.cat([-a1c[:, None], dvj], dim=1))
    diag = acc[:, 0, None, None] * eye2 + acc[:, 1:, None] * eye2
    off_ij = a1c[:, None, None] * eye2 - dvj[:, :, None] * eye2
    off_ji = -(a0[:, None, None] * eye2) - dvi[:, :, None] * eye2
    return res, diag, (off_ij, off_ji)


def _sst_step_fused(lay, mesh, scfg, bcs, q, v, mu, mu_t_node, strain_mag,
                    dist, rho_old, dt, kine_inf, omega_inf, gq, gvel,
                    flow_fb, f1, f2, cdkw):
    """sst_step on the fused-assembly path (the JAX package's
    _sst_step_fused): one K12 launch builds (res, dd, sel) in the lane
    layout, the weak BCs add outside the wall rows, and the system goes to
    the stencil solve in the reference's fused tier
    (stencil_solve.fused_sst_solve_tier), its diagonal inverted
    elementwise."""
    n = q.shape[0]
    dtype = q.dtype
    rho = v[:, lay.PRHO]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    grad_k, grad_w = gq[:, 0, :], gq[:, 1, :]
    wall_mask, q_wall = _wall_rows(mesh, bcs, mu, rho)
    res_t, dd_t, sel_t = sa.sst_assemble(
        mesh, _CONSTS + (float(scfg.cfl_red),), q, rho, vel, gq, mu,
        mu_t_node, dist, strain_mag, _divergence(gvel), dt, wall_mask, f1, f2,
        cdkw)
    res, dd = res_t.T, dd_t.T
    wk = _weak_bc_batch(lay, bcs, q, vel, rho, kine_inf, omega_inf, flow_fb)
    if wk is not None:
        # wall-corner faces masked out before the adds (the unfused path
        # zeroes the wall rows after them: the same result)
        bn, bflux, a0b = wk
        notwall = 1.0 - wall_mask.to(dtype)[bn]
        res = es.add_rows(res, bn, bflux * notwall[:, None], flow_fb.seg)
        dd = es.add_rows(dd, bn, (a0b * notwall)[:, None].expand(-1, 2),
                         flow_fb.seg)

    # the solve in lane space: diag rows [d00, 0, 0, d11], 1/d elementwise
    rhs = (-res).contiguous()
    zero = torch.zeros_like(dd[:, 0])
    safe = torch.where(dd == 0.0, 1.0, dd)
    diag_t = torch.stack([dd[:, 0], zero, zero, dd[:, 1]])
    dinv_t = torch.stack([1.0 / safe[:, 0], zero, zero, 1.0 / safe[:, 1]])
    m = int(scfg.linear_iter)
    sel_dtype, one = sts.fused_sst_solve_tier(n, mesh.stencil_offsets, dtype,
                                              scfg.ncolor, m)
    ops = sts.StencilSolveOps.from_lanes(mesh.stencil_offsets, sel_t, dinv_t,
                                         diag_t, scfg.colors, scfg.ncolor,
                                         sel_dtype, one_launch=one)
    if one:
        sol, _, _ = ops.fgmres(rhs, m, scfg.linear_tol)
    else:
        sol, _, _ = krylov.fgmres(None, None, rhs, max_iter=m,
                                  tol=scfg.linear_tol,
                                  precond_matvec=ops.precond_matvec)
    rms = torch.sqrt((rhs * rhs).sum(0) / n)
    q_new, outs = _update(scfg, q, sol, rho_old, rho, wall_mask, q_wall,
                          grad_k, grad_w, mu, dist, strain_mag, gq)
    return q_new, rms, outs


def _divergence(gvel):
    """sum_d dv_d/dx_d of the velocity gradient block (N, nd, nd)."""
    div = gvel[:, 0, 0]
    for d in range(1, gvel.shape[1]):
        div = div + gvel[:, d, d]
    return div


def _wall_rows(mesh, bcs, mu, rho):
    """(wall mask (N,), q_wall (N, 2)) of the strong wall rows: k = 0,
    omega = 60 mu/(rho beta1 d^2) at the nearest interior neighbour."""
    n = rho.shape[0]
    wall_mask = torch.zeros(n, dtype=torch.bool, device=rho.device)
    w_wall_full = torch.zeros(n, dtype=rho.dtype, device=rho.device)
    for bc in bcs:
        if bc.kind in ("isothermal_wall", "heatflux_wall"):
            nodes = bc.nodes
            dnn = torch.linalg.norm(mesh.coords[bc.nn] - mesh.coords[nodes],
                                    dim=1)
            w_wall = 60.0 * mu[bc.nn] / (rho[bc.nn] * BETA_1 * dnn * dnn)
            wall_mask.index_fill_(0, nodes, True)
            w_wall_full[nodes] = w_wall
    return wall_mask, torch.stack([torch.zeros_like(w_wall_full),
                                   w_wall_full], dim=1)


# (LOWER, UPPER) as tensors by (dtype, device): made once, so the step
# copies nothing from the host (a captured step may not)
_BOUND_TENSORS = {}


def _bounds(dtype, device):
    key = (dtype, device)
    if key not in _BOUND_TENSORS:
        _BOUND_TENSORS[key] = tuple(torch.tensor(b, dtype=dtype,
                                                 device=device)
                                    for b in (LOWER, UPPER))
    return _BOUND_TENSORS[key]


def _update(scfg, q, sol, rho_old, rho, wall_mask, q_wall, grad_k, grad_w,
            mu, dist, strain_mag, gq):
    """(q_new, outs): the relaxed conservative update, clipped, the wall
    rows rescaled by rho_old/rho and clipped like every other row; the eddy
    viscosity and sigma_k of the new state."""
    lower, upper = _bounds(q.dtype, q.device)
    q_new = (rho_old[:, None] * q + scfg.relax * sol) / rho[:, None]
    q_new = torch.minimum(torch.maximum(q_new, lower), upper)
    q_wall_c = torch.minimum(torch.maximum(
        q_wall * (rho_old / rho)[:, None], lower), upper)
    q_new = torch.where(wall_mask[:, None], q_wall_c, q_new)

    f1n, f2n, _ = blending(q_new[:, 0], q_new[:, 1], grad_k, grad_w, mu, rho,
                           dist)
    mu_t_new = eddy_viscosity(rho, q_new[:, 0], q_new[:, 1], strain_mag, f2n)
    outs = dict(mu_t=mu_t_new,
                sigma_k=f1n * SIGMA_K1 + (1.0 - f1n) * SIGMA_K2, gq=gq)
    return q_new, outs


def wall_distance(coords: np.ndarray, wall_points: np.ndarray,
                  chunk: int = 4096) -> np.ndarray:
    """Distance of every node to the nearest no-slip wall vertex (chunked
    point-based ComputeWall_Distance; the GEMM form from 200k nodes up,
    as in the JAX package)."""
    if wall_points.shape[0] == 0:
        return np.full(coords.shape[0], 1e10)
    out = np.empty(coords.shape[0])
    if coords.shape[0] >= 200_000:
        # |a|^2 + |b|^2 - (2a).b, the product one GEMM a chunk; the sums
        # and the minimum over row blocks that stay in cache
        w2 = (wall_points ** 2).sum(-1)
        rows = max(1, (1 << 18) // wall_points.shape[0])
        for s in range(0, coords.shape[0], chunk):
            blk = coords[s:s + chunk]
            a2 = (blk ** 2).sum(-1)
            g = 2.0 * blk @ wall_points.T
            dmin = np.empty(blk.shape[0])
            for r in range(0, blk.shape[0], rows):
                d2 = np.add(a2[r:r + rows, None], w2[None, :])
                np.subtract(d2, g[r:r + rows], out=d2)
                dmin[r:r + rows] = d2.min(axis=1)
            out[s:s + chunk] = np.sqrt(np.maximum(dmin, 0.0))
        return out
    # the elementwise form, its squares summed over the coordinates in
    # order as .sum(-1) sums them (bit for bit), one coordinate at a time
    # in place, over row blocks whose (rows, nW) buffers stay in cache
    rows = max(1, (1 << 18) // wall_points.shape[0])
    wt = np.ascontiguousarray(wall_points.T)
    for s in range(0, coords.shape[0], rows):
        blk = coords[s:s + rows]
        d2 = np.subtract(blk[:, 0, None], wt[None, 0])
        np.multiply(d2, d2, out=d2)
        dk = np.empty_like(d2)
        for k in range(1, coords.shape[1]):
            np.subtract(blk[:, k, None], wt[None, k], out=dk)
            np.multiply(dk, dk, out=dk)
            np.add(d2, dk, out=d2)
        out[s:s + rows] = np.sqrt(d2.min(axis=1))
    return out
