"""Interior edge terms of the implicit NS system on stencil meshes.

Per edge family (positive stencil offset o_k) and slot p, the edge
(p, p + o_k) gets the MUSCL face states (limited or not, thermodynamically
re-consistent through the species h/cp tables, with the face dP/dU rows),
the AUSM+-up flux and both its Jacobians on the face states, and the
viscous flux with Stefan-Maxwell diffusion, the SST closure and both its
approximate Jacobians on the node states (Upwind_Residual,
solver_direct_reactive.cpp:2535; Viscous_Residual, :5305;
SetLaminarViscousProjJacs and the SST closures).  Every per-node input
rides in one feature-major stack F (R, nP) (implicit_rows); slot p reads
columns p and p + o_k.  Padded slots carry zero normals, so their flux and
Jacobian blocks are exactly zero.

On CUDA tensors the per-edge pipeline is kernel K10
(csrc/edge_implicit.cu), one launch for every family; on CPU tensors
``edge_implicit_plain``.  The residual roll-subtract, the diagonal
j_i - roll(j_j, o) and the lane-layout off-diagonal blocks are formed here
by rolls, deterministic and without atomics.
"""

from __future__ import annotations

import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.ops import ausm_t, edge_flux, viscous_t
from su2_tpu_torch.solvers import euler as es

EPS = 1e-16


def implicit_rows(lay):
    """Row offsets of the stack F: v (nPrim) | gradients of [T, u.., P,
    X..] (ng*d) | limiter of [T, u.., P] (2+d) | mu | kappa | mu_t | tke |
    grad tke (d) | sigma_k | dT/dU (nVar) | dP/dU (nVar)."""
    nd, ns, nvar, nprim = lay.ndim, lay.ns, lay.nvar, lay.nprim
    ng = 2 + nd + ns
    r = {"g": nprim}
    r["lim"] = r["g"] + ng * nd
    r["mu"] = r["lim"] + (2 + nd)
    r["ka"] = r["mu"] + 1
    r["mut"] = r["ka"] + 1
    r["tke"] = r["mut"] + 1
    r["gk"] = r["tke"] + 1
    r["sk"] = r["gk"] + nd
    r["dtdu"] = r["sk"] + 1
    r["dpdu"] = r["dtdu"] + nvar
    r["total"] = r["dpdu"] + nvar
    return r


def stack_inputs(lay, v, grad, lim, trans, turb, sigma_k, dtdu, dpdu,
                 grad_rows=None):
    """The stack F (R, nP) of implicit_rows from node-major fields; with
    grad_rows (ng*d, nP) (the tier's feature-major rows) the gradient rows
    go in as they are, with no node-major transpose."""
    n = v.shape[0]
    if lim is None:
        lim = torch.ones((n, 2 + lay.ndim), dtype=v.dtype, device=v.device)
    if grad_rows is not None:
        return torch.cat([
            v.T, grad_rows, lim.T, trans.mu[None], trans.kappa[None],
            turb.mu_t[None], turb.tke[None], turb.grad_tke.T, sigma_k[None],
            dtdu.T, dpdu.T], dim=0).contiguous()
    return torch.cat([
        v, grad.reshape(n, -1), lim, trans.mu[:, None], trans.kappa[:, None],
        turb.mu_t[:, None], turb.tke[:, None], turb.grad_tke,
        sigma_k[:, None], dtdu, dpdu], dim=1).T.contiguous()


def _hcp(lib, t):
    """Species h, cp (S, E) at temperatures t (E,)."""
    return cl.species_enthalpy(lib, t).T, cl.species_cp(lib, t).T


def muscl_reconstruct(lay, v, g, lim, ev, dxsign):
    """The MUSCL face values (T, velocity (d, E), P) of one edge side,
    feature-major, at the midpoint x + dxsign ev / 2 from the node state v
    (nPrim, E) and the gradients g (2+d, d, E) of [T, u.., P], limited by
    lim (2+d, E) unless lim is None; and the mask of the faces where T or
    P <= EPS, which keep the node state (the JAX package's _muscl_rows)."""
    nd = lay.ndim
    dx = dxsign * 0.5 * ev
    q = torch.cat([v[lay.T][None], v[lay.VX:lay.VX + nd], v[lay.P][None]])
    proj = g[:, 0] * dx[0][None]
    for d in range(1, nd):
        proj = proj + g[:, d] * dx[d][None]
    if lim is not None:
        proj = proj * lim
    qr = q + proj
    t_r, vel_r, p_r = qr[0], qr[1:1 + nd], qr[1 + nd]
    return t_r, vel_r, p_r, (t_r <= EPS) | (p_r <= EPS)


def muscl_face_rows(lib, lay, v, g, lim, ev, dxsign):
    """The MUSCL face state (nPrim, E) of one edge side of the explicit
    step (the JAX package's _muscl_rows): muscl_reconstruct's T, velocity
    and P, the node's Y, and rho, h and a recomputed from the library at
    the face T (h by cl.mixture_enthalpy: kernel T1 on the card); the node
    state where T or P <= EPS."""
    t_r, vel_r, p_r, bad = muscl_reconstruct(lay, v, g, lim, ev, dxsign)
    ys = v[lay.YS:lay.YS + lay.ns]
    ys_rows = ys.T
    rgas = cl.mixture_rgas(lib, ys_rows)
    rho_r = p_r / (rgas * t_r)
    h_r = cl.mixture_enthalpy(lib, t_r, ys_rows) \
        + 0.5 * (vel_r * vel_r).sum(0)
    gamma_r, _ = cl.frozen_gamma_sound(lib, t_r, ys_rows)
    a_r = torch.sqrt(gamma_r * p_r / rho_r)
    vface = torch.cat([t_r[None], vel_r, p_r[None], rho_r[None], h_r[None],
                       a_r[None], ys], dim=0)
    return torch.where(bad[None], v, vface)


def face_state(lib, lay, v, g, lim, dpdu, ev, dxsign, muscl):
    """(v_face (nPrim, E), its dP/dU rows (nVar, E)) of one edge side,
    feature-major: the node state v (nPrim, E) with its dP/dU rows dpdu
    (nVar, E), or with muscl the MUSCL state at the edge midpoint x +
    dxsign ev / 2 from the gradients g (2+d, d, E) of [T, u.., P], limited
    by lim (2+d, E) unless lim is None, with h, a and dP/dU recomputed from
    the species tables at the face temperature; a face with T or P <= EPS
    keeps the node state (the JAX package's euler._muscl_rows and
    ghost_dpdu)."""
    nd, ns = lay.ndim, lay.ns
    if not muscl:
        return v, dpdu
    t_r, vel_r, p_r, bad = muscl_reconstruct(lay, v, g, lim, ev, dxsign)
    t_face = torch.where(bad, v[lay.T], t_r)
    ys = v[lay.YS:lay.YS + ns]
    ysc = viscous_t._clip_ys_t(ys)
    ri = lib.ri
    h_s, cp_s = _hcp(lib, t_face)
    rgas = ysc[0] * ri[0]
    hmix = ysc[0] * h_s[0]
    cpmix = ysc[0] * cp_s[0]
    for k in range(1, ns):
        rgas = rgas + ysc[k] * ri[k]
        hmix = hmix + ysc[k] * h_s[k]
        cpmix = cpmix + ysc[k] * cp_s[k]
    ke = vel_r[0] * vel_r[0]
    for d in range(1, nd):
        ke = ke + vel_r[d] * vel_r[d]
    hmix = hmix + 0.5 * ke
    gamma_r = cpmix / (cpmix - rgas)
    rho_r = p_r / (rgas * t_r)
    a_r = torch.sqrt(torch.abs(gamma_r * p_r / rho_r))
    vface = torch.cat([t_r[None], vel_r, p_r[None], rho_r[None], hmix[None],
                       a_r[None], ys], dim=0)
    vface = torch.where(bad[None], v, vface)
    # dP/dU of the face state, gamma = a^2 rho / P
    gam, vel2 = es.row_gamma_vel2(lay, vface.T)
    return vface, es.ghost_dpdu(lib, lay, vface.T, gam, vel2).T


def edge_implicit_plain(lib, lay, sc, consts, f_all, offsets, fam_normal,
                        fam_evec, muscl, use_limiter):
    """Plain version of kernel K10.  f_all (R, nP); fam_normal/fam_evec
    (Kh, nP, d); consts = (m_infty, prandtl_turb, lewis_turb).  Returns
    flux = conv - visc (Kh, nVar, nP) and the edge Jacobian blocks
    j_i, j_j = conv_jac - visc_jac (Kh, nVar^2, nP), rows a*nVar + b."""
    m_infty, pr_turb, le_turb = consts
    r = implicit_rows(lay)
    nd, ns, nvar, nprim = lay.ndim, lay.ns, lay.nvar, lay.nprim
    ng = 2 + nd + ns
    n = f_all.shape[1]
    fi = f_all
    vi = fi[:nprim]
    sel = [0] + list(range(1, 1 + nd)) + list(range(2 + nd, ng))
    g_i = fi[r["g"]:r["g"] + ng * nd].reshape(ng, nd, n)[sel]
    fluxes, jis, jjs = [], [], []

    def side(fs, ev, dxsign):
        g = fs[r["g"]:r["g"] + (2 + nd) * nd].reshape(2 + nd, nd, n)
        lim = fs[r["lim"]:r["lim"] + 2 + nd] if use_limiter else None
        return face_state(lib, lay, fs[:nprim], g, lim,
                          fs[r["dpdu"]:r["dpdu"] + nvar], ev, dxsign, muscl)

    for k, o in enumerate(offsets):
        fj = torch.roll(f_all, -int(o), dims=1)
        nm = fam_normal[k].T
        ev = fam_evec[k].T
        vf_i, sc_i = side(fi, ev, 1.0)
        vf_j, sc_j = side(fj, ev, -1.0)
        conv, cj_i, cj_j = ausm_t.ausm_flux_t(lay, vf_i, vf_j, nm, m_infty,
                                              sc_i, sc_j)
        # the viscous terms read the node states and gradients
        vj = fj[:nprim]
        h_s, cp_s = _hcp(lib, 0.5 * (vi[lay.T] + vj[lay.T]))
        g_j = fj[r["g"]:r["g"] + ng * nd].reshape(ng, nd, n)[sel]
        visc, vj_i, vj_j = viscous_t.viscous_flux_t(
            lay, sc, vi, vj, g_i, g_j, nm, ev,
            fi[r["mu"]], fj[r["mu"]], fi[r["ka"]], fj[r["ka"]],
            fi[r["mut"]], fj[r["mut"]], fi[r["tke"]], fj[r["tke"]],
            fi[r["gk"]:r["gk"] + nd], fj[r["gk"]:r["gk"] + nd], fi[r["sk"]],
            h_s, cp_s, pr_turb, le_turb,
            s_i=fi[r["dtdu"]:r["dtdu"] + nvar],
            s_j=fj[r["dtdu"]:r["dtdu"] + nvar])
        fluxes.append(conv - visc)
        jis.append((cj_i - vj_i).reshape(nvar * nvar, n))
        jjs.append((cj_j - vj_j).reshape(nvar * nvar, n))
    return torch.stack(fluxes), torch.stack(jis), torch.stack(jjs)


def fused_implicit_family_terms(lib, lay, mesh, prm, v, grad, lim, dpdu,
                                dtdu, trans, turb, sigma_k, grad_rows=None):
    """Interior part of the implicit system: res (nP, nVar), diag
    (nP, nVar, nVar) and sel_t (K*nVar^2, nP), the off-diagonal blocks in
    the stencil lane layout (block k couples row p to column
    p + stencil_offsets[k], rows a*nVar + b).  lim None: unlimited.  The
    per-slot terms come from K10 on the card (one launch for every family)
    and from edge_implicit_plain on the CPU."""
    nvar = lay.nvar
    n = v.shape[0]
    f_all = stack_inputs(lay, v, grad, lim, trans, turb, sigma_k, dtdu,
                         dpdu, grad_rows)
    args = (lib, lay, edge_flux.species_consts_of(lib),
            (float(prm.m_infty), float(prm.prandtl_turb),
             float(prm.lewis_turb)), f_all, mesh.fam_offsets,
            mesh.fam_normal, mesh.fam_evec, bool(prm.muscl),
            bool(prm.use_limiter))
    if v.is_cuda:
        from su2_tpu_torch import kernels
        flux, j_i, j_j = kernels.edge_implicit(*args)
    else:
        flux, j_i, j_j = edge_implicit_plain(*args)
    res_t = diag_t = None
    by_off = {}
    for k, o in enumerate(mesh.fam_offsets):
        o = int(o)
        rt = flux[k] - torch.roll(flux[k], o, dims=1)
        dk = j_i[k] - torch.roll(j_j[k], o, dims=1)
        res_t = rt if res_t is None else res_t + rt
        diag_t = dk if diag_t is None else diag_t + dk
        by_off[o] = j_j[k]
        by_off[-o] = -torch.roll(j_i[k], o, dims=1)
    sel_t = torch.cat([by_off[int(o)] for o in mesh.stencil_offsets], dim=0)
    return res_t.T, diag_t.T.reshape(n, nvar, nvar), sel_t
