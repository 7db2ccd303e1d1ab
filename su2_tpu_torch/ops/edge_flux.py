"""Interior edge terms of the explicit NS residual.

Each edge (i, j) gets the AUSM+-up flux, the viscous flux with
Stefan-Maxwell diffusion and the SST closure, and the convective and
viscous spectral radii (Upwind_Residual + Viscous_Residual + SetTime_Step,
solver_direct_reactive.cpp:2535, :5305, :5057), from the columns i and j
of one feature-major stack F (R, nP) of all per-node inputs
(``edge_terms``).

Stencil meshes: per edge family (positive stencil offset o_k) slot p is
the edge (p, p + o_k); padded slots carry zero normals, so their flux is
exactly zero.  On CUDA tensors the per-edge pipeline is kernel T3
(csrc/edge_flux.cu), and the residual is formed here by roll-subtracts,
deterministic and without atomics; from TILED_MIN_NODES nodes up
(ops/gradients.use_tiled) kernel K8 (csrc/edge_win.cu) computes the same
node sums in one launch, from a stack built straight from the gradient
rows.  On CPU tensors ``edge_flux_plain`` and the roll-subtract serve both.

Other meshes (the edge list): the stack node-major (``stack_nodes``, no
transpose), then on CUDA tensors kernel K13 (csrc/edge_list.cu: the edge
pass reads the stack in place, a second launch sums per node in slot
order), on CPU tensors ``edge_list_terms_plain`` (``edge_list_flux_plain``
and one mesh.scatter_edges_mixed: gather + slot sum, no atomics).
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


def edge_terms(lib, lay, sc, consts, fi, fj, nm, ev):
    """The per-edge terms from the endpoint columns fi, fj (R, E) of the
    stack, the edges' area normals nm and node-to-node vectors ev (d, E).
    consts = (m_infty, prandtl_lam, prandtl_turb, lewis_turb).  Returns
    flux (nVar, E) = conv - visc, lc (E,), lv (E,)."""
    m_infty, pr_lam, pr_turb, le_turb = consts
    r = stack_rows(lay)
    nd, nprim = lay.ndim, lay.nprim
    e = fi.shape[1]
    vi, vj = fi[:nprim], fj[:nprim]
    tmean = 0.5 * (vi[lay.T] + vj[lay.T])
    h_s = cl.species_enthalpy(lib, tmean).T
    cp_s = cl.species_cp(lib, tmean).T
    conv = ausm_t.ausm_flux_t(lay, vi, vj, nm, m_infty)
    g = lambda f: f[r["g"]:r["mu"]].reshape(r["gd"] // nd, nd, e)
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
    return (conv - visc, (torch.abs(proj) + a_mean) * area,
            (lam1 + lam2) * area * area / mean_rho)


def edge_flux_plain(lib, lay, sc, consts, f_all, offsets, fam_normal,
                    fam_evec):
    """Plain version of kernel T3.  f_all (R, nP); fam_normal/fam_evec
    (Kh, nP, d).  consts = (m_infty, prandtl_lam, prandtl_turb, lewis_turb).
    Returns flux (Kh, nVar, nP), lc (Kh, nP), lv (Kh, nP)."""
    fluxes, lcs, lvs = [], [], []
    for k, o in enumerate(offsets):
        flux, lc, lv = edge_terms(lib, lay, sc, consts, f_all,
                                  torch.roll(f_all, -o, dims=1),
                                  fam_normal[k].T, fam_evec[k].T)
        fluxes.append(flux)
        lcs.append(lc)
        lvs.append(lv)
    return torch.stack(fluxes), torch.stack(lcs), torch.stack(lvs)


def edge_list_flux_plain(lib, lay, sc, consts, f_all, edges, edge_normal,
                         coords):
    """Plain version of kernel K13: the edge terms of every edge (i, j) of
    the list edges (E, 2), from the stack's columns i and j, the area
    normal edge_normal (E, d) and coords[j] - coords[i].  Returns flux
    (nVar, E), lc (E,), lv (E,)."""
    i, j = edges[:, 0], edges[:, 1]
    return edge_terms(lib, lay, sc, consts, f_all[:, i], f_all[:, j],
                      edge_normal.T, (coords[j] - coords[i]).T)


def edge_list_terms_plain(lib, lay, sc, consts, f_nodes, mesh):
    """Plain version of kernel K13's whole call (kernels.edge_list_terms):
    edge_list_flux_plain over mesh's edge list from the node-major stack
    f_nodes (nP, R), then one mesh.scatter_edges_mixed.  Returns res (nP,
    nVar), lc (nP,), lv (nP,)."""
    flux, lc, lv = edge_list_flux_plain(lib, lay, sc, consts, f_nodes.T,
                                        mesh.edges, mesh.edge_normal,
                                        mesh.coords)
    res, lams = mesh.scatter_edges_mixed(flux.T, torch.stack([lc, lv], dim=1))
    return res, lams[:, 0], lams[:, 1]


def stack_nodes(lay, v, grad, trans, turb, sigma_k, dpdu_e):
    """The per-node stack of stack_rows node-major, F^T (nP, R): each
    node's R inputs one contiguous row; grad is the NS gradient set [T,
    u.., P, X..] (nP, nG, d), whose pressure row the viscous flux does not
    read: the rows before and after it are taken as two views (no index
    tensor, no copy to the card)."""
    nd, ns = lay.ndim, lay.ns
    n = v.shape[0]
    return torch.cat([
        v, grad[:, :1 + nd].reshape(n, -1),
        grad[:, 2 + nd:2 + nd + ns].reshape(n, -1),
        trans.mu[:, None], trans.kappa[:, None], turb.mu_t[:, None],
        turb.tke[:, None], turb.grad_tke, (dpdu_e + 1.0)[:, None],
        sigma_k[:, None]], dim=1)


def stack_inputs(lay, v, grad, trans, turb, sigma_k, dpdu_e,
                 grad_rows=None):
    """The feature-major per-node stack F (R, nP) of stack_rows: stack_nodes
    transposed.  With grad_rows (nG*d, nP) (the tier's feature-major rows)
    the stack is built from them, with no node-major transpose of the
    gradients."""
    nd = lay.ndim
    if grad_rows is not None:
        return torch.cat([
            v.T, grad_rows[:(1 + nd) * nd], grad_rows[(2 + nd) * nd:],
            trans.mu[None], trans.kappa[None], turb.mu_t[None],
            turb.tke[None], turb.grad_tke.T, (dpdu_e + 1.0)[None],
            sigma_k[None]], dim=0).contiguous()
    return stack_nodes(lay, v, grad, trans, turb, sigma_k,
                       dpdu_e).T.contiguous()


def roll_subtract(offsets, fluxes, lcs, lvs):
    """Node sums of per-family slot outputs: res[:, p] = sum_k flux_k[:, p]
    - flux_k[:, p - o_k], lc[p] = sum_k lc_k[p] + lc_k[p - o_k] (lv
    likewise), each family's difference formed before it is added."""
    res_t = lc_n = lv_n = None
    for k, o in enumerate(offsets):
        rt = fluxes[k] - torch.roll(fluxes[k], o, dims=1)
        lcn = lcs[k] + torch.roll(lcs[k], o)
        lvn = lvs[k] + torch.roll(lvs[k], o)
        res_t = rt if res_t is None else res_t + rt
        lc_n = lcn if lc_n is None else lc_n + lcn
        lv_n = lvn if lv_n is None else lv_n + lvn
    return res_t, lc_n, lv_n


def edge_win_plain(lib, lay, sc, consts, f_all, offsets, fam_normal,
                   fam_evec):
    """Plain version of kernel K8: res (nVar, nP), lc (nP,), lv (nP,) of
    edge_flux_plain's slots summed per node by roll_subtract."""
    return roll_subtract(offsets, *edge_flux_plain(
        lib, lay, sc, consts, f_all, offsets, fam_normal, fam_evec))


def fused_interior_terms(lib, lay, mesh, prm, v, grad, trans, turb, sigma_k,
                         dpdu_e, grad_rows=None):
    """Interior-edge residual (nP, nVar) and the interior sums of the two
    spectral radii (nP,), (nP,); boundary terms are added by the caller.
    Stencil meshes, below TILED_MIN_NODES: the per-slot fluxes (T3 on the
    card) and the roll-subtract here; from it up (grad_rows given): the
    node sums in one launch of K8 on the card, edge_win_plain on the CPU.
    Other meshes: the node-major stack, then the per-edge terms of the
    edge list summed per node (K13's two launches on the card,
    edge_list_terms_plain on the CPU)."""
    sc = species_consts_of(lib)
    consts = (float(prm.m_infty), float(prm.prandtl_lam),
              float(prm.prandtl_turb), float(prm.lewis_turb))
    if v.is_cuda:
        from su2_tpu_torch import kernels
    if mesh.fam_offsets is None:
        args = (lib, lay, sc, consts, stack_nodes(lay, v, grad, trans, turb,
                                                  sigma_k, dpdu_e), mesh)
        return (kernels.edge_list_terms(*args) if v.is_cuda
                else edge_list_terms_plain(*args))
    f_all = stack_inputs(lay, v, grad, trans, turb, sigma_k, dpdu_e,
                         grad_rows)
    args = (lib, lay, sc, consts, f_all, mesh.fam_offsets, mesh.fam_normal,
            mesh.fam_evec)
    if v.is_cuda:
        if grad_rows is not None:
            res_t, lc_n, lv_n = kernels.edge_win(*args)
        else:
            res_t, lc_n, lv_n = roll_subtract(mesh.fam_offsets,
                                              *kernels.edge_flux(*args))
    else:
        res_t, lc_n, lv_n = edge_win_plain(*args)
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
