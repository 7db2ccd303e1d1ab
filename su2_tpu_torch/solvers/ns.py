"""Reactive Navier-Stokes layer (torch): the explicit residual and the
implicit system.

Port of the fused paths of the JAX package's ns_assemble
(CReactiveNSSolver, solver_direct_reactive.cpp:4131-6354): interior edge
terms, weak flux BCs with their viscous part, weak slip walls, the
chemistry source, strong isothermal/heat-flux walls and the viscous
spectral radius.  Explicit: the interior terms by kernel T3 on the card
(K8 on the gradient rows of K7 from TILED_MIN_NODES nodes up) and the
chemistry source by kernel T4.  Implicit: the interior terms and their
edge Jacobians by kernel K10 (ops/edge_implicit.py), with MUSCL and the
limiters, plus the boundary, slip-wall, source and isothermal-wall
Jacobians, the wall momentum rows and the time diagonal, as a
StencilJacobianT.  Boundary rows are added marker by marker in batch order
(euler.add_rows), without atomics.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.chemistry.library import ChemLib
from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.linalg.blockcsr import StencilJacobianT
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


def _visc_lam12(prm: NSParams, mu, mut, gam):
    """RANS: lam1 = 4/3 (mu + mu_t), lam2 = (1 + Pr_l/Pr_t mu_t/mu)
    gamma mu/Pr_l."""
    lam1 = 4.0 / 3.0 * (mu + mut)
    lam2 = (1.0 + (prm.prandtl_lam / prm.prandtl_turb) * (mut / mu)) \
        * (gam * mu / prm.prandtl_lam)
    return lam1 + lam2


def viscous_lambda_boundary(lib: ChemLib, mesh: MeshArrays, lay: Layout,
                            prm: NSParams, v, trans, dpdu_full,
                            turb: TurbFlowData, lam):
    """Add the boundary-vertex viscous spectral radii (:5188-5214): every
    marker merged into one static area^2 weight per node."""
    gamma = dpdu_full[:, lay.RHOE] + 1.0
    lamf = _visc_lam12(prm, trans.mu, turb.mu_t, gamma) / v[:, lay.PRHO]
    return lam + lamf * mesh.visc_w2


def viscous_lambda(lib: ChemLib, mesh: MeshArrays, lay: Layout,
                   prm: NSParams, v, trans, dpdu_full, turb: TurbFlowData):
    """Accumulated viscous spectral radius (SetTime_Step NS branch,
    solver_direct_reactive.cpp:5132-5152), interior families by rolls
    (node-mean transport, gamma of node i) and the boundary vertices."""
    gamma = dpdu_full[:, lay.RHOE] + 1.0
    rho = v[:, lay.PRHO]
    lam = torch.zeros_like(rho)
    for k, o in enumerate(mesh.fam_offsets):
        area2 = (mesh.fam_normal[k] ** 2).sum(1)
        mean = lambda x: 0.5 * (x + torch.roll(x, -int(o), dims=0))
        lam_e = _visc_lam12(prm, mean(trans.mu), mean(turb.mu_t), gamma) \
            * area2 / mean(rho)
        lam = lam + lam_e + torch.roll(lam_e, int(o), dims=0)
    return viscous_lambda_boundary(lib, mesh, lay, prm, v, trans, dpdu_full,
                                   turb, lam)


def enforce_wall_velocity(lay: Layout, u, wall_mask):
    """Strong no-slip: zero momentum at wall nodes (SetVelocity_Old(0))."""
    mom = u[:, lay.RHOVX:lay.RHOVX + lay.ndim]
    mom = torch.where(wall_mask[:, None], 0.0, mom)
    return torch.cat([u[:, :lay.RHOVX], mom, u[:, lay.RHOVX + lay.ndim:]],
                     dim=1)


def ns_assemble(lib: ChemLib, lay: Layout, mesh: MeshArrays, prm: NSParams,
                bcs, v, nsd, turb: TurbFlowData, omega_turb, dt=None):
    """NS residual with the SST coupling; with dt the implicit system.

    nsd: the node-state bundle (state.NodeState) of this iteration.
    Returns (res, wall_mask, trans, grad (None in the rows tier), extra,
    flux-BC ghost batch): extra is (lam_conv, lam_visc), the interior sums
    of the spectral radii, when dt is None, else the StencilJacobianT of
    the implicit system (time diagonal Vol/dt included)."""
    implicit = dt is not None
    n = v.shape[0]
    nd, ns_ = lay.ndim, lay.ns
    q = viscous.ns_gradient_vars(lib, lay, v, xs=nsd.xs)
    ngv = q.shape[1]
    # >= TILED_MIN_NODES: feature-major gradient rows (K7) feed the edge
    # kernels (K8, K10) and the boundary gather directly
    grad_rows = grad = None
    if gradients.use_tiled(mesh):
        grad_rows = es.compute_gradient_rows(mesh, prm, q)
    else:
        grad = es.compute_gradients(mesh, prm, q)
    dpdu_full = nsd.dpdu
    trans = viscous.Transport(mu=nsd.mu, kappa=nsd.kappa)

    if implicit:
        lim = None
        if prm.use_limiter:
            qlim = es.gradient_vars(lay, v)
            glim = grad[:, :2 + nd, :] if grad is not None else \
                gradients.rows_to_grad(grad_rows[:(2 + nd) * nd], 2 + nd, nd)
            lim = (limiters.barth_jespersen(mesh, qlim, glim)
                   if prm.limiter_kind == "BARTH_JESPERSEN" else
                   limiters.venkatakrishnan(mesh, qlim, glim,
                                            prm.limiter_coeff,
                                            prm.ref_elem_length))
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
        sel = [0] + list(range(1, 1 + nd)) + list(range(2 + nd, 2 + nd + ns_))
        if grad is not None:
            g_n = grad[nodes][:, sel, :].permute(1, 2, 0)
        else:
            # the boundary columns of the rows (ng*d, nb) -> (ng', d, nb)
            g_n = grad_rows[:, nodes].reshape(ngv, nd, -1)[sel]
        tmean = 0.5 * (vbt[lay.T] + vgt[lay.T])
        mu_b, ka_b = trans.mu[nodes], trans.kappa[nodes]
        mut_b, tke_b = turb.mu_t[nodes], turb.tke[nodes]
        gk_b = turb.grad_tke[nodes].T
        vf = viscous_t.viscous_flux_t(
            lay, edge_flux.species_consts_of(lib), vbt, vgt, g_n, g_n, nrm,
            (mesh.coords[fb.nn] - mesh.coords[nodes]).T, mu_b, mu_b, ka_b,
            ka_b, mut_b, mut_b, tke_b, tke_b, gk_b, gk_b,
            turb.sigma_k[nodes], cl.species_enthalpy(lib, tmean).T,
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
                lib, lay, bc.nodes, bc.normal, v, turb.tke))
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
        wall_mask[nodes] = True
        if bc.kind == "isothermal_wall":
            twall = bc.params["twall"]
            tj = v[bc.nn, lay.T]
            dij = torch.linalg.norm(mesh.coords[bc.nn] - mesh.coords[nodes],
                                    dim=1)
            ktr = trans.kappa[nodes]
            dtdn = (twall - tj) / dij
            evisc = ktr * dtdn * area
            # the reference's ALTERNATIVE closure (:5516-5541):
            # sum_s mu_t/Pr_t Cp_s rho_s (Twall - Tj)/dij
            cp_s = cl.species_cp(lib, torch.full_like(area, twall))
            vn = v[nodes]
            rho_s = vn[:, lay.PRHO, None] * vn[:, lay.YS:lay.YS + ns_]
            coef = (turb.mu_t[nodes] / prm.prandtl_turb)[:, None] \
                * cp_s * rho_s
            evisc = evisc + coef.sum(-1) * dtdn * area
            erow = es.add_rows(erow, nodes, -evisc)
            if implicit:
                diag = es.add_rows(diag, nodes, _isothermal_energy_rows(
                    lay, nsd.dtdu[bc.nn], ktr / dij * area,
                    coef.sum(-1) / dij * area))
        else:
            erow = es.add_rows(erow, nodes, -bc.params["qwall"] * area)
    res = torch.cat([res[:, :lay.RHOE], (res[:, lay.RHOE] + erow)[:, None],
                     res[:, lay.RHOE + 1:]], dim=1)
    # zero momentum residual rows at strong walls
    res = enforce_wall_velocity(lay, res, wall_mask)
    if not implicit:
        return res, wall_mask, trans, grad, (lam_c, lam_v), fb

    # momentum rows of wall nodes: identity on the diagonal, zero off it
    # (DeleteValsRowi)
    nvar = lay.nvar
    mom = torch.zeros(nvar, dtype=torch.bool, device=v.device)
    mom[lay.RHOVX:lay.RHOVX + nd] = True
    eye = torch.eye(nvar, dtype=v.dtype, device=v.device)
    diag = torch.where((wall_mask[:, None] & mom[None])[:, :, None], eye[None],
                       diag)
    row_mom = mom.repeat_interleave(nvar).repeat(len(mesh.stencil_offsets))
    sel_t = torch.where(row_mom[:, None] & wall_mask[None, :], 0.0, sel_t)
    # time diagonal Vol/dt
    ok = dt > EPS
    delta = torch.where(ok, mesh.volume / torch.where(ok, dt, 1.0), 0.0)
    diag = diag + delta[:, None, None] * eye
    diag = torch.where(ok[:, None, None], diag, eye[None])
    res = torch.where(ok[:, None], res, 0.0)
    return res, wall_mask, trans, grad, StencilJacobianT(diag=diag,
                                                         sel_t=sel_t), fb


def _isothermal_energy_rows(lay, dtdu_nn, c, c_turb):
    """(nV, nVar, nVar) blocks whose energy row is the isothermal wall's
    Jacobian (SubtractBlock of -ktr dT/dU(nn) Area/dij): c dT/dU on the
    density, energy and species columns, c_turb dT/dU on energy, zero on
    momentum."""
    nd = lay.ndim
    row = c[:, None] * dtdu_nn
    row = torch.cat([row[:, :lay.RHOVX], torch.zeros_like(row[:, :nd]),
                     row[:, lay.RHOE:lay.RHOE + 1]
                     + (c_turb * dtdu_nn[:, lay.RHOE])[:, None],
                     row[:, lay.RHOS:]], dim=1)
    z = lambda m: torch.zeros((row.shape[0], m, lay.nvar), dtype=row.dtype,
                              device=row.device)
    return torch.cat([z(lay.RHOE), row[:, None], z(lay.nvar - lay.RHOE - 1)],
                     dim=1)
