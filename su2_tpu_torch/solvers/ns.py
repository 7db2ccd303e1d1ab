"""Reactive Navier-Stokes layer, explicit branch (torch).

Port of the explicit fused path of the JAX package's ns_assemble
(CReactiveNSSolver, solver_direct_reactive.cpp:4131-6354): interior edge
terms (kernel T3 on the card; K8 on the gradient rows of K7 from
TILED_MIN_NODES nodes up), weak flux BCs with their viscous part, weak
slip walls, the chemistry source (kernel T4 on the card), strong
isothermal/heat-flux walls and the viscous spectral radius.  Boundary
rows are added marker by marker in batch order (euler.add_rows), without
atomics.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.chemistry.library import ChemLib
from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.ops import ausm_t, edge_flux, gradients, viscous, viscous_t
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


def enforce_wall_velocity(lay: Layout, u, wall_mask):
    """Strong no-slip: zero momentum at wall nodes (SetVelocity_Old(0))."""
    mom = u[:, lay.RHOVX:lay.RHOVX + lay.ndim]
    mom = torch.where(wall_mask[:, None], 0.0, mom)
    return torch.cat([u[:, :lay.RHOVX], mom, u[:, lay.RHOVX + lay.ndim:]],
                     dim=1)


def ns_assemble(lib: ChemLib, lay: Layout, mesh: MeshArrays, prm: NSParams,
                bcs, v, nsd, turb: TurbFlowData, omega_turb):
    """Explicit NS residual with the SST coupling.

    nsd: the node-state bundle (state.NodeState) of this iteration.
    Returns (res, wall_mask, trans, grad (None in the rows tier),
    (lam_conv, lam_visc) interior sums, flux-BC ghost batch)."""
    n = v.shape[0]
    nd, ns_ = lay.ndim, lay.ns
    q = viscous.ns_gradient_vars(lib, lay, v, xs=nsd.xs)
    ngv = q.shape[1]
    # >= TILED_MIN_NODES: feature-major gradient rows (K7) feed the
    # windowed edge kernel (K8) and the boundary gather directly
    grad_rows = grad = None
    if gradients.use_tiled(mesh):
        grad_rows = es.compute_gradient_rows(mesh, prm, q)
    else:
        grad = es.compute_gradients(mesh, prm, q)
    dpdu_full = nsd.dpdu
    trans = viscous.Transport(mu=nsd.mu, kappa=nsd.kappa)

    res, lam_c, lam_v = edge_flux.fused_interior_terms(
        lib, lay, mesh, prm, v, grad, trans, turb, turb.sigma_k,
        dpdu_full[:, lay.RHOE], grad_rows=grad_rows)

    # weak flux BCs: AUSM + uncorrected viscous flux between the domain
    # node and its ghost state over the negated vertex normal
    fb = es.flux_bc_batch(lib, lay, bcs, v, dpdu_full, prm.tke_inf)
    if fb is not None:
        nodes = fb.nodes
        vb = v[nodes]
        vbt, vgt = vb.T, fb.v_ghost.T
        nrm = -fb.normal.T
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
            None, mu_b, mu_b, ka_b, ka_b, mut_b, mut_b, tke_b, tke_b,
            gk_b, gk_b, turb.sigma_k[nodes],
            cl.species_enthalpy(lib, tmean).T, cl.species_cp(lib, tmean).T,
            prm.prandtl_turb, prm.lewis_turb, corrected=False,
            v_fuller_j=vbt)
        res = es.add_rows(res, nodes, (cf - vf).T, fb.seg)

    # weak slip walls (MARKER_EULER / MARKER_SYM): pressure (+ 2/3 rho k)
    # on the momentum rows
    for bc in bcs:
        if bc.kind == "euler_wall":
            res = es.add_rows(res, bc.nodes, es.euler_wall_residual(
                lib, lay, bc.nodes, bc.normal, v, turb.tke))

    # chemistry source
    if prm.reactive_sources:
        res = res + es.chemistry_source_residual(lib, lay, mesh, prm, v,
                                                 omega_turb)

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
        else:
            erow = es.add_rows(erow, nodes, -bc.params["qwall"] * area)
    res = torch.cat([res[:, :lay.RHOE], (res[:, lay.RHOE] + erow)[:, None],
                     res[:, lay.RHOE + 1:]], dim=1)
    # zero momentum residual rows at strong walls
    res = enforce_wall_velocity(lay, res, wall_mask)
    return res, wall_mask, trans, grad, (lam_c, lam_v), fb
