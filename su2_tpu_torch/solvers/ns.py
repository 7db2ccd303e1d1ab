"""Reactive Navier-Stokes layer (torch): the explicit residual and the
implicit system.

Port of the fused paths of the JAX package's ns_assemble
(CReactiveNSSolver, solver_direct_reactive.cpp:4131-6354): interior edge
terms, weak flux BCs with their viscous part, weak slip walls, the
chemistry source, strong isothermal/heat-flux walls and the viscous
spectral radius.  Explicit: the interior terms by kernel T3 on the card
(K8 on the gradient rows of K7 from TILED_MIN_NODES nodes up) and the
chemistry source by kernel T4; with MUSCL the JAX package's edge-list
branch in torch ops (edge_list_interior: MUSCL faces, h by T1, and the
edge viscous flux).  Implicit: the interior terms and their
edge Jacobians by kernel K10 (ops/edge_implicit.py), with MUSCL and the
limiters, plus the boundary, slip-wall, source and isothermal-wall
Jacobians, the wall momentum rows and the time diagonal, as a
StencilJacobianT.  On a mesh without a static stencil the explicit RANS
interior terms run over the edge list (K13 on the card), and the implicit
system, RANS and laminar, is the JAX package's edge-list branch: the
convective system by kernel K11 (euler.convective_system) and the edge
viscous flux and Jacobians, as a BlockJacobian (_edge_list_system).
Laminar (REACTIVE_NAVIER_STOKES, turb None), as the
JAX package runs it without its fused kernels: explicit, the AUSM+-up and
viscous fluxes over the edge list (mesh.scatter_edges); implicit, on the
family slots, the convective system by kernel K11 (euler.
convective_system_fam) and the viscous flux and Jacobians in plain torch
ops, as a FamilyJacobian.  Boundary rows are added marker by marker in
batch order (euler.add_rows), without atomics.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.chemistry.library import ChemLib
from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.linalg.blockcsr import (BlockJacobian, FamilyJacobian,
                                           StencilJacobianT)
from su2_tpu_torch.ops import (ausm_t, edge_flux, edge_implicit, gradients,
                               limiters, viscous, viscous_t)
from su2_tpu_torch.ops.viscous import TurbFlowData
from su2_tpu_torch.solvers import euler as es
from su2_tpu_torch.state import Layout

EPS = 1e-16


@dataclass(frozen=True)
class NSParams(es.EulerParams):
    prandtl_lam: float = 0.72
    prandtl_turb: float = 0.90
    lewis_turb: float = 1.2


def _visc_lam12(prm: NSParams, turb_on: bool, mu, kappa, mut, gam, cv):
    """RANS: lam1 = 4/3 (mu + mu_t), lam2 = (1 + Pr_l/Pr_t mu_t/mu)
    gamma mu/Pr_l; laminar: lam1 = 4/3 mu, lam2 = kappa/Cv with Cv :=
    Cp/gamma (the reference's Mean_CV uses Cp/(dPdU[rhoE] + 1))."""
    if turb_on:
        lam1 = 4.0 / 3.0 * (mu + mut)
        lam2 = (1.0 + (prm.prandtl_lam / prm.prandtl_turb) * (mut / mu)) \
            * (gam * mu / prm.prandtl_lam)
    else:
        lam1 = 4.0 / 3.0 * mu
        lam2 = kappa / cv
    return lam1 + lam2


def _cv(lib, lay, v, gamma):
    """Cp/gamma per node (the laminar lam2's Cv)."""
    return cl.mixture_cp(lib, v[:, lay.T], v[:, lay.YS:lay.YS + lay.ns]) \
        / gamma


def viscous_lambda_boundary(lib: ChemLib, mesh: MeshArrays, lay: Layout,
                            prm: NSParams, v, trans, dpdu_full,
                            turb: TurbFlowData | None, lam):
    """Add the boundary-vertex viscous spectral radii (:5188-5214): every
    marker merged into one static area^2 weight per node.  turb None:
    laminar."""
    gamma = dpdu_full[:, lay.RHOE] + 1.0
    on = turb is not None
    lamf = _visc_lam12(prm, on, trans.mu, trans.kappa,
                       turb.mu_t if on else None, gamma,
                       None if on else _cv(lib, lay, v, gamma)) \
        / v[:, lay.PRHO]
    return lam + lamf * mesh.visc_w2


def viscous_lambda(lib: ChemLib, mesh: MeshArrays, lay: Layout,
                   prm: NSParams, v, trans, dpdu_full,
                   turb: TurbFlowData | None):
    """Accumulated viscous spectral radius (SetTime_Step NS branch,
    solver_direct_reactive.cpp:5132-5152), interior families by rolls
    (node-mean transport, gamma of node i) and the boundary vertices.
    turb None: laminar."""
    gamma = dpdu_full[:, lay.RHOE] + 1.0
    on = turb is not None
    cpg = None if on else _cv(lib, lay, v, gamma)
    rho = v[:, lay.PRHO]
    if mesh.fam_offsets is None:
        # the edge list (the explicit MUSCL step on a mesh without a
        # stencil): edge means, gamma of node i (:5138)
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        mean = lambda x: None if x is None else 0.5 * (x[i] + x[j])
        lam_e = _visc_lam12(prm, on, mean(trans.mu), mean(trans.kappa),
                            mean(turb.mu_t) if on else None, gamma[i],
                            mean(cpg)) * mesh.edge_area ** 2 / mean(rho)
        return viscous_lambda_boundary(lib, mesh, lay, prm, v, trans,
                                       dpdu_full, turb,
                                       mesh.sum_edges_abs(lam_e))
    lam = torch.zeros_like(rho)
    for k, o in enumerate(mesh.fam_offsets):
        area2 = (mesh.fam_normal[k] ** 2).sum(1)
        mean = lambda x: 0.5 * (x + torch.roll(x, -int(o), dims=0))
        lam_e = _visc_lam12(prm, on, mean(trans.mu),
                            None if on else mean(trans.kappa),
                            mean(turb.mu_t) if on else None, gamma,
                            None if on else mean(cpg)) * area2 / mean(rho)
        lam = lam + lam_e + torch.roll(lam_e, int(o), dims=0)
    return viscous_lambda_boundary(lib, mesh, lay, prm, v, trans, dpdu_full,
                                   turb, lam)


def add_dual_time(lay: Layout, mesh: MeshArrays, res, jac, u, u_n, u_nm1,
                  dt_phys: float, order: int):
    """Dual-time source (SetResidual_DualTime, solver_direct_reactive.cpp
    :2172): the BDF1 (order 1) or BDF2 physical time derivative added to
    the pseudo-steady residual, and with the implicit system jac (None:
    explicit) its diagonal Vol/dt or 3/2 Vol/dt on every block."""
    vol = mesh.volume[:, None]
    if order == 1:
        src = vol * (u - u_n) / dt_phys
        diag_coef = mesh.volume / dt_phys
    else:
        src = vol * (3.0 * u - 4.0 * u_n + u_nm1) / (2.0 * dt_phys)
        diag_coef = 1.5 * mesh.volume / dt_phys
    res = res + src
    if jac is not None:
        eye = torch.eye(lay.nvar, dtype=u.dtype, device=u.device)
        jac = replace(jac, diag=jac.diag + diag_coef[:, None, None] * eye)
    return res, jac


def enforce_wall_velocity(lay: Layout, u, wall_mask):
    """Strong no-slip: zero momentum at wall nodes (SetVelocity_Old(0))."""
    mom = u[:, lay.RHOVX:lay.RHOVX + lay.ndim]
    mom = torch.where(wall_mask[:, None], 0.0, mom)
    return torch.cat([u[:, :lay.RHOVX], mom, u[:, lay.RHOVX + lay.ndim:]],
                     dim=1)


def viscous_rows(lay: Layout, grad, dim=1):
    """The viscous flux's rows [T, u.., X..] of the NS gradient set [T,
    u.., P, X..] along dim: the rows before and after the pressure row,
    two views joined (no index tensor, no copy from the host)."""
    nd, ns_ = lay.ndim, lay.ns
    return torch.cat([grad.narrow(dim, 0, 1 + nd),
                      grad.narrow(dim, 2 + nd, ns_)], dim=dim)


def _edge_viscous(lib, lay, prm, v, grad, trans, dtdu, gi, gj, normal,
                  evec, implicit, turb=None):
    """The viscous flux (and with implicit its Jacobians), feature-major
    (ops/viscous_t.py, plain torch ops), on the edge slots whose endpoint
    fields gi(x), gj(x) gather from the last (node) axis of x: laminar
    with turb None, else with the SST closure (sigma_k of the i node)."""
    g = viscous_rows(lay, grad).permute(1, 2, 0)
    vi, vj = gi(v.T), gj(v.T)
    tmean = 0.5 * (vi[lay.T] + vj[lay.T])
    jkw = dict(s_i=gi(dtdu.T), s_j=gj(dtdu.T)) if implicit else {}
    tb = (None,) * 7
    if turb is not None:
        gk = turb.grad_tke.T
        tb = (gi(turb.mu_t), gj(turb.mu_t), gi(turb.tke), gj(turb.tke),
              gi(gk), gj(gk), gi(turb.sigma_k))
    return viscous_t.viscous_flux_t(
        lay, edge_flux.species_consts_of(lib), vi, vj, gi(g), gj(g), normal,
        evec, gi(trans.mu), gj(trans.mu), gi(trans.kappa), gj(trans.kappa),
        *tb, cl.species_enthalpy(lib, tmean).T, cl.species_cp(lib, tmean).T,
        prm.prandtl_turb, prm.lewis_turb, **jkw)


def edge_list_interior(lib, lay, mesh, prm, v, grad, lim, trans, turb):
    """Interior terms of the explicit steps without a fused edge pass (the
    JAX package's ns_assemble edge-list branch: the laminar step, and
    MUSCL): the AUSM+-up residual over the edge list (MUSCL faces under
    prm.muscl) minus the scattered viscous flux (turb None: laminar)."""
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    vflux = _edge_viscous(lib, lay, prm, v, grad, trans, None,
                          lambda x: x[..., i], lambda x: x[..., j],
                          mesh.edge_normal.T,
                          (mesh.coords[j] - mesh.coords[i]).T, False, turb)
    return es.convective_residual(lib, lay, mesh, prm, v, grad, lim) \
        - mesh.scatter_edges(vflux.T)


def _laminar_interior(lib, lay, mesh, prm, v, grad, lim, nsd, trans):
    """Implicit interior terms of the laminar step (the JAX package's
    ns_assemble with turb None), on the family slots:
    convective_system_fam (K11) and the laminar viscous flux and
    Jacobians, pad slots masked; returns (res, diag, off_ij, off_ji) with
    the off-diagonal blocks in the lane layout (blockcsr.FamilyJacobian)."""
    nvar = lay.nvar
    res, diag, off_ij, off_ji = es.convective_system_fam(
        lib, lay, mesh, prm, v, grad, lim, nsd.dpdu)
    valid = mesh.fam_valid_flat
    vflux, vjac_i, vjac_j = _edge_viscous(
        lib, lay, prm, v, grad, trans, nsd.dtdu,
        lambda x: mesh.fam_gather_i(x, dim=-1),
        lambda x: mesh.fam_gather_j(x, dim=-1), mesh.fam_normal_flat.T,
        mesh.fam_evec.reshape(-1, lay.ndim).T, True)
    vflux = torch.where(valid, vflux, 0.0)
    vjac_i = torch.where(valid, vjac_i.reshape(nvar * nvar, -1), 0.0)
    vjac_j = torch.where(valid, vjac_j.reshape(nvar * nvar, -1), 0.0)
    n = mesh.npoint
    diag = diag + mesh.fam_accum(-vjac_i, vjac_j, dim=-1).T.reshape(
        n, nvar, nvar)
    res = res - mesh.fam_scatter(vflux, dim=-1).T
    return res, diag, off_ij - vjac_j, off_ji + vjac_i


def _edge_list_system(lib, lay, mesh, prm, v, grad, lim, nsd, trans,
                      turb):
    """Implicit interior terms on a mesh without a static stencil (the JAX
    package's ns_assemble edge-list branch, RANS and, with turb None,
    laminar): euler.convective_system (K11 on the card) and the viscous
    flux and Jacobians over the edge list (sigma_k of the i node); returns
    (res, diag, off_ij, off_ji) with the edge-major off-diagonal blocks of
    a blockcsr.BlockJacobian."""
    res, jac = es.convective_system(lib, lay, mesh, prm, v, grad, lim,
                                    nsd.dpdu)
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    vflux, vjac_i, vjac_j = _edge_viscous(
        lib, lay, prm, v, grad, trans, nsd.dtdu, lambda x: x[..., i],
        lambda x: x[..., j], mesh.edge_normal.T,
        (mesh.coords[j] - mesh.coords[i]).T, True, turb)
    vjac_i, vjac_j = vjac_i.permute(2, 0, 1), vjac_j.permute(2, 0, 1)
    diag = jac.diag + mesh.accumulate_sides(-vjac_i, vjac_j)
    res = res - mesh.scatter_edges(vflux.T)
    return res, diag, jac.off_ij - vjac_j, jac.off_ji + vjac_i


def ns_assemble(lib: ChemLib, lay: Layout, mesh: MeshArrays, prm: NSParams,
                bcs, v, nsd, turb: TurbFlowData | None, omega_turb,
                dt=None):
    """NS residual, with the SST coupling unless turb is None (laminar);
    with dt the implicit system.  Explicit RANS with MUSCL runs the
    edge-list branch (edge_list_interior), as the JAX package leaves its
    fused edge kernel out under MUSCL.

    nsd: the node-state bundle (state.NodeState) of this iteration.
    Returns (res, wall_mask, trans, grad (None in the rows tier of the RANS
    step), extra, flux-BC ghost batch): extra is, when dt is None,
    (lam_conv, lam_visc), the interior sums of the spectral radii (None in
    the laminar step, which sums them itself), else the implicit system
    (time diagonal Vol/dt included): a StencilJacobianT, in the laminar
    step a FamilyJacobian, on a mesh without a static stencil a
    BlockJacobian (RANS and laminar); extra is None also under explicit
    MUSCL, whose spectral radii the caller sums (viscous_lambda)."""
    implicit = dt is not None
    laminar = turb is None
    # the explicit steps without a fused edge pass: laminar, and MUSCL
    edge_list = not implicit and (laminar or prm.muscl)
    # the implicit system on a mesh without a static stencil: edge-major
    # blocks (blockcsr.BlockJacobian)
    gather = implicit and mesh.fam_offsets is None
    n = v.shape[0]
    nd, ns_ = lay.ndim, lay.ns
    q = viscous.ns_gradient_vars(lib, lay, v, xs=nsd.xs)
    ngv = q.shape[1]
    # >= TILED_MIN_NODES: feature-major gradient rows (K7) feed the edge
    # kernels (K8, K10) and the boundary gather directly; the laminar
    # step and explicit MUSCL, which have no fused edge kernel, read them
    # node-major
    grad_rows = grad = None
    if gradients.use_tiled(mesh):
        grad_rows = es.compute_gradient_rows(mesh, prm, q)
        if laminar or edge_list:
            grad = gradients.rows_to_grad(grad_rows, ngv, nd)
            grad_rows = None
    else:
        grad = es.compute_gradients(mesh, prm, q)
    dpdu_full = nsd.dpdu
    trans = viscous.Transport(mu=nsd.mu, kappa=nsd.kappa)

    lim = None
    if (implicit or prm.muscl) and prm.use_limiter:
        qlim = es.gradient_vars(lay, v)
        glim = grad[:, :2 + nd, :] if grad is not None else \
            gradients.rows_to_grad(grad_rows[:(2 + nd) * nd], 2 + nd, nd)
        lim = (limiters.barth_jespersen(mesh, qlim, glim)
               if prm.limiter_kind == "BARTH_JESPERSEN" else
               limiters.venkatakrishnan(mesh, qlim, glim, prm.limiter_coeff,
                                        prm.ref_elem_length))
    if edge_list:
        res = edge_list_interior(lib, lay, mesh, prm, v, grad, lim, trans,
                                 turb)
    elif gather:
        res, diag, off_ij, off_ji = _edge_list_system(
            lib, lay, mesh, prm, v, grad, lim, nsd, trans, turb)
    elif laminar:
        res, diag, off_ij, off_ji = _laminar_interior(
            lib, lay, mesh, prm, v, grad, lim, nsd, trans)
    elif implicit:
        res, diag, sel_t = edge_implicit.fused_implicit_family_terms(
            lib, lay, mesh, prm, v, grad, lim, dpdu_full, nsd.dtdu, trans,
            turb, turb.sigma_k, grad_rows=grad_rows)
    else:
        res, lam_c, lam_v = edge_flux.fused_interior_terms(
            lib, lay, mesh, prm, v, grad, trans, turb, turb.sigma_k,
            dpdu_full[:, lay.RHOE], grad_rows=grad_rows)

    # weak flux BCs: AUSM + uncorrected viscous flux between the domain
    # node and its ghost state over the negated vertex normal (and their
    # Jacobians with respect to the domain node)
    fb = es.flux_bc_batch(lib, lay, bcs, v, dpdu_full, prm.tke_inf)
    if fb is not None:
        nodes = fb.nodes
        vb = v[nodes]
        vbt, vgt = vb.T, fb.v_ghost.T
        nrm = -fb.normal.T
        jkw = {}
        if implicit:
            s_ghost = es.ghost_dpdu(lib, lay, fb.v_ghost, fb.gamma, fb.vel2)
            cf, cj_i, _ = ausm_t.ausm_flux_t(lay, vbt, vgt, nrm, prm.m_infty,
                                             dpdu_full[nodes].T, s_ghost.T)
            s_b = nsd.dtdu[nodes].T
            jkw = dict(s_i=s_b, s_j=s_b)
        else:
            cf = ausm_t.ausm_flux_t(lay, vbt, vgt, nrm, prm.m_infty)
        if grad is not None:
            g_n = viscous_rows(lay, grad[nodes]).permute(1, 2, 0)
        else:
            # the boundary columns of the rows (ng*d, nb) -> (ng', d, nb)
            g_n = viscous_rows(lay, grad_rows[:, nodes].reshape(ngv, nd, -1),
                               dim=0)
        tmean = 0.5 * (vbt[lay.T] + vgt[lay.T])
        mu_b, ka_b = trans.mu[nodes], trans.kappa[nodes]
        tb = (None,) * 7
        if not laminar:
            mut_b, tke_b = turb.mu_t[nodes], turb.tke[nodes]
            gk_b = turb.grad_tke[nodes].T
            tb = (mut_b, mut_b, tke_b, tke_b, gk_b, gk_b,
                  turb.sigma_k[nodes])
        vf = viscous_t.viscous_flux_t(
            lay, edge_flux.species_consts_of(lib), vbt, vgt, g_n, g_n, nrm,
            (mesh.coords[fb.nn] - mesh.coords[nodes]).T, mu_b, mu_b, ka_b,
            ka_b, *tb, cl.species_enthalpy(lib, tmean).T,
            cl.species_cp(lib, tmean).T, prm.prandtl_turb, prm.lewis_turb,
            corrected=False, v_fuller_j=vbt, **jkw)
        if implicit:
            vf, vj_i, _ = vf
            diag = es.add_rows(diag, nodes, (cj_i - vj_i).permute(2, 0, 1),
                               fb.seg)
        res = es.add_rows(res, nodes, (cf - vf).T, fb.seg)

    # weak slip walls (MARKER_EULER / MARKER_SYM): pressure (+ 2/3 rho k)
    # on the momentum rows
    for bc in bcs:
        if bc.kind == "euler_wall":
            res = es.add_rows(res, bc.nodes, es.euler_wall_residual(
                lib, lay, bc.nodes, bc.normal, v,
                None if laminar else turb.tke))
            if implicit:
                diag = es.add_rows(diag, bc.nodes, es.euler_wall_jacobian(
                    lay, bc.normal, dpdu_full[bc.nodes]))

    # chemistry source (implicit: with its Jacobian, in plain torch ops)
    if prm.reactive_sources:
        if implicit:
            sres, sdiag = es.chemistry_source_system(
                lib, lay, mesh, prm, v, nsd.dtdu, omega_turb)
            diag = diag + sdiag
        else:
            sres = es.chemistry_source_residual(lib, lay, mesh, prm, v,
                                                omega_turb)
        res = res + sres

    # strong no-slip walls (isothermal / heat flux)
    wall_mask = torch.zeros(n, dtype=torch.bool, device=v.device)
    erow = torch.zeros(n, dtype=v.dtype, device=v.device)
    for bc in bcs:
        if bc.kind not in ("isothermal_wall", "heatflux_wall"):
            continue
        nodes = bc.nodes
        area = torch.linalg.norm(bc.normal, dim=1)
        wall_mask.index_fill_(0, nodes, True)
        if bc.kind == "isothermal_wall":
            twall = bc.params["twall"]
            tj = v[bc.nn, lay.T]
            dij = torch.linalg.norm(mesh.coords[bc.nn] - mesh.coords[nodes],
                                    dim=1)
            ktr = trans.kappa[nodes]
            dtdn = (twall - tj) / dij
            evisc = ktr * dtdn * area
            c_turb = None
            if not laminar:
                # the reference's ALTERNATIVE closure (:5516-5541):
                # sum_s mu_t/Pr_t Cp_s rho_s (Twall - Tj)/dij
                cp_s = cl.species_cp(lib, torch.full_like(area, twall))
                vn = v[nodes]
                rho_s = vn[:, lay.PRHO, None] * vn[:, lay.YS:lay.YS + ns_]
                coef = (turb.mu_t[nodes] / prm.prandtl_turb)[:, None] \
                    * cp_s * rho_s
                evisc = evisc + coef.sum(-1) * dtdn * area
                c_turb = coef.sum(-1) / dij * area
            erow = es.add_rows(erow, nodes, -evisc)
            if implicit:
                diag = es.add_rows(diag, nodes, _isothermal_energy_rows(
                    lay, nsd.dtdu[bc.nn], ktr / dij * area, c_turb))
        else:
            erow = es.add_rows(erow, nodes, -bc.params["qwall"] * area)
    res = torch.cat([res[:, :lay.RHOE], (res[:, lay.RHOE] + erow)[:, None],
                     res[:, lay.RHOE + 1:]], dim=1)
    # zero momentum residual rows at strong walls
    res = enforce_wall_velocity(lay, res, wall_mask)
    if not implicit:
        return res, wall_mask, trans, grad, \
            None if edge_list else (lam_c, lam_v), fb

    # momentum rows of wall nodes: identity on the diagonal, zero off it
    # (DeleteValsRowi)
    nvar = lay.nvar
    mom = torch.zeros(nvar, dtype=torch.bool, device=v.device)
    mom[lay.RHOVX:lay.RHOVX + nd] = True
    eye = torch.eye(nvar, dtype=v.dtype, device=v.device)
    diag = torch.where((wall_mask[:, None] & mom[None])[:, :, None], eye[None],
                       diag)
    row_mom = mom.repeat_interleave(nvar)
    if gather:
        # edge-major blocks: off_ij's rows belong to node i, off_ji's to j
        iw = wall_mask[mesh.edges[:, 0]]
        jw = wall_mask[mesh.edges[:, 1]]
        off_ij = torch.where((iw[:, None] & mom[None])[:, :, None], 0.0,
                             off_ij)
        off_ji = torch.where((jw[:, None] & mom[None])[:, :, None], 0.0,
                             off_ji)
    elif laminar:
        # family slots: off_ij's rows belong to node i, off_ji's to node j
        iw = mesh.fam_gather_i(wall_mask)
        jw = mesh.fam_gather_j(wall_mask)
        off_ij = torch.where(row_mom[:, None] & iw[None, :], 0.0, off_ij)
        off_ji = torch.where(row_mom[:, None] & jw[None, :], 0.0, off_ji)
    else:
        row_mom = row_mom.repeat(len(mesh.stencil_offsets))
        sel_t = torch.where(row_mom[:, None] & wall_mask[None, :], 0.0,
                            sel_t)
    # time diagonal Vol/dt
    ok = dt > EPS
    delta = torch.where(ok, mesh.volume / torch.where(ok, dt, 1.0), 0.0)
    diag = diag + delta[:, None, None] * eye
    diag = torch.where(ok[:, None, None], diag, eye[None])
    res = torch.where(ok[:, None], res, 0.0)
    if gather:
        jac = BlockJacobian(diag=diag, off_ij=off_ij, off_ji=off_ji)
    elif laminar:
        jac = FamilyJacobian(diag=diag, off_ij=off_ij, off_ji=off_ji)
    else:
        jac = StencilJacobianT(diag=diag, sel_t=sel_t)
    return res, wall_mask, trans, grad, jac, fb


def _isothermal_energy_rows(lay, dtdu_nn, c, c_turb):
    """(nV, nVar, nVar) blocks whose energy row is the isothermal wall's
    Jacobian (SubtractBlock of -ktr dT/dU(nn) Area/dij): c dT/dU on the
    density, energy and species columns, plus c_turb dT/dU on energy (the
    RANS closure; None laminar), zero on momentum."""
    nd = lay.ndim
    row = c[:, None] * dtdu_nn
    e_col = row[:, lay.RHOE:lay.RHOE + 1]
    if c_turb is not None:
        e_col = e_col + (c_turb * dtdu_nn[:, lay.RHOE])[:, None]
    row = torch.cat([row[:, :lay.RHOVX], torch.zeros_like(row[:, :nd]),
                     e_col, row[:, lay.RHOS:]], dim=1)
    z = lambda m: torch.zeros((row.shape[0], m, lay.nvar), dtype=row.dtype,
                              device=row.device)
    return torch.cat([z(lay.RHOE), row[:, None], z(lay.nvar - lay.RHOE - 1)],
                     dim=1)
