"""Interior edge terms of the explicit NS residual on stencil meshes.

Per edge family (positive stencil offset o_k) and slot p, the edge
(p, p + o_k) gets the AUSM+-up flux, the viscous flux with Stefan-Maxwell
diffusion and the SST closure, and the convective and viscous spectral
radii (Upwind_Residual + Viscous_Residual + SetTime_Step,
solver_direct_reactive.cpp:2535, :5305, :5057).  All per-node inputs ride
in one feature-major stack F (R, nP); slot p reads columns p and p + o_k.
Padded slots carry zero normals, so their flux is exactly zero.

On CUDA tensors the per-edge pipeline is kernel T3 (csrc/edge_flux.cu);
on CPU tensors ``edge_flux_plain``.  The residual is formed here by
roll-subtracts, deterministic and without atomics.
"""

from __future__ import annotations

import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.ops import ausm_t, viscous_t


def stack_rows(lay):
    """Row offsets of the per-node stack F: v (nPrim) | gradients of
    [T, u.., X..] (gd) | mu | kappa | mu_t | tke | grad tke (d) |
    gamma | sigma_k."""
    nd, ns = lay.ndim, lay.ns
    r = {"g": lay.nprim}
    r["gd"] = (1 + nd + ns) * nd
    r["mu"] = r["g"] + r["gd"]
    r["ka"] = r["mu"] + 1
    r["mut"] = r["ka"] + 1
    r["tke"] = r["mut"] + 1
    r["gk"] = r["tke"] + 1
    r["gam"] = r["gk"] + nd
    r["sk"] = r["gam"] + 1
    r["total"] = r["sk"] + 1
    return r


def edge_flux_plain(lib, lay, sc, consts, f_all, offsets, fam_normal,
                    fam_evec):
    """Plain version of kernel T3.  f_all (R, nP); fam_normal/fam_evec
    (Kh, nP, d).  consts = (m_infty, prandtl_lam, prandtl_turb, lewis_turb).
    Returns flux (Kh, nVar, nP), lc (Kh, nP), lv (Kh, nP)."""
    m_infty, pr_lam, pr_turb, le_turb = consts
    r = stack_rows(lay)
    nd, nprim = lay.ndim, lay.nprim
    n = f_all.shape[1]
    fi = f_all
    vi = fi[:nprim]
    fluxes, lcs, lvs = [], [], []
    for k, o in enumerate(offsets):
        fj = torch.roll(f_all, -o, dims=1)
        vj = fj[:nprim]
        nm = fam_normal[k].T
        ev = fam_evec[k].T
        tmean = 0.5 * (vi[lay.T] + vj[lay.T])
        h_s = cl.species_enthalpy(lib, tmean).T
        cp_s = cl.species_cp(lib, tmean).T
        conv = ausm_t.ausm_flux_t(lay, vi, vj, nm, m_infty)
        g = lambda f: f[r["g"]:r["mu"]].reshape(r["gd"] // nd, nd, n)
        visc = viscous_t.viscous_flux_t(
            lay, sc, vi, vj, g(fi), g(fj), nm, ev,
            fi[r["mu"]], fj[r["mu"]], fi[r["ka"]], fj[r["ka"]],
            fi[r["mut"]], fj[r["mut"]], fi[r["tke"]], fj[r["tke"]],
            fi[r["gk"]:r["gk"] + nd], fj[r["gk"]:r["gk"] + nd], fi[r["sk"]],
            h_s, cp_s, pr_turb, le_turb)
        area = torch.sqrt((nm * nm).sum(0))
        proj = 0.5 * ((vi[lay.VX:lay.VX + nd] + vj[lay.VX:lay.VX + nd])
                      * nm).sum(0)
        a_mean = 0.5 * (vi[lay.A] + vj[lay.A])
        mean_rho = 0.5 * (vi[lay.PRHO] + vj[lay.PRHO])
        mean_mu = 0.5 * (fi[r["mu"]] + fj[r["mu"]])
        mean_mut = 0.5 * (fi[r["mut"]] + fj[r["mut"]])
        lam1 = 4.0 / 3.0 * (mean_mu + mean_mut)
        lam2 = (1.0 + (pr_lam / pr_turb) * (mean_mut / mean_mu)) \
            * (fi[r["gam"]] * mean_mu / pr_lam)
        fluxes.append(conv - visc)
        lcs.append((torch.abs(proj) + a_mean) * area)
        lvs.append((lam1 + lam2) * area * area / mean_rho)
    return torch.stack(fluxes), torch.stack(lcs), torch.stack(lvs)


def stack_inputs(lay, v, grad, trans, turb, sigma_k, dpdu_e):
    """The feature-major per-node stack F (R, nP) of stack_rows; grad is
    the NS gradient set [T, u.., P, X..] (nP, nG, d), whose pressure row
    the viscous flux does not read."""
    nd, ns = lay.ndim, lay.ns
    n = v.shape[0]
    sel = [0] + list(range(1, 1 + nd)) + list(range(2 + nd, 2 + nd + ns))
    gsel = grad[:, sel, :].reshape(n, (1 + nd + ns) * nd)
    return torch.cat([
        v, gsel, trans.mu[:, None], trans.kappa[:, None], turb.mu_t[:, None],
        turb.tke[:, None], turb.grad_tke, (dpdu_e + 1.0)[:, None],
        sigma_k[:, None]], dim=1).T.contiguous()


def fused_interior_terms(lib, lay, mesh, prm, v, grad, trans, turb, sigma_k,
                         dpdu_e):
    """Interior-edge residual (nP, nVar) and the interior sums of the two
    spectral radii (nP,), (nP,); boundary terms are added by the caller."""
    f_all = stack_inputs(lay, v, grad, trans, turb, sigma_k, dpdu_e)
    sc = species_consts_of(lib)
    consts = (float(prm.m_infty), float(prm.prandtl_lam),
              float(prm.prandtl_turb), float(prm.lewis_turb))
    if v.is_cuda:
        from su2_tpu_torch import kernels
        fluxes, lcs, lvs = kernels.edge_flux(lib, lay, sc, consts, f_all,
                                             mesh.fam_offsets,
                                             mesh.fam_normal, mesh.fam_evec)
    else:
        fluxes, lcs, lvs = edge_flux_plain(lib, lay, sc, consts, f_all,
                                           mesh.fam_offsets, mesh.fam_normal,
                                           mesh.fam_evec)
    res_t = lc_n = lv_n = None
    for k, o in enumerate(mesh.fam_offsets):
        rt = fluxes[k] - torch.roll(fluxes[k], o, dims=1)
        lcn = lcs[k] + torch.roll(lcs[k], o)
        lvn = lvs[k] + torch.roll(lvs[k], o)
        res_t = rt if res_t is None else res_t + rt
        lc_n = lcn if lc_n is None else lc_n + lcn
        lv_n = lvn if lv_n is None else lv_n + lvn
    return res_t.T, lc_n, lv_n


def species_consts_of(lib) -> viscous_t.SpeciesConsts:
    """SpeciesConsts of a ChemLib (host float64 precompute, cached per
    library object)."""
    cache = lib.__dict__.get("_species_consts")
    if cache is None:
        cache = viscous_t.species_consts(lib.mm.cpu().numpy(),
                                         lib.diff_vol.cpu().numpy(),
                                         lib.dtype, lib.device)
        object.__setattr__(lib, "_species_consts", cache)
    return cache
