"""Feature-major viscous flux with Stefan-Maxwell diffusion and the SST
closure, and its approximate Jacobians (torch).

CAvgGradReactive_Flow / CAvgGradReactive_Boundary (reference:
numerics_direct_reactive.cpp:385-1684 and the SST closure :656-889) with
every array (features, edges).  This is the viscous half of the plain
versions of kernels T3 (csrc/edge_flux.cu) and K10 (csrc/edge_implicit.cu,
with the Jacobians of SetLaminarViscousProjJacs :1200-1409 and
SST_Reactive_JacobianClosure :891-1097, in 2D and 3D, where the closure
takes the reference's own 3D branch); the boundary faces use it with
``corrected=False`` and the Fuller factor of the domain node on both sides.
Without the SST fields (mu_t_i None) it is the laminar flux and Jacobians,
the JAX package's node-major ops/viscous.py viscous_flux with turb_i None,
which the laminar steps run in plain torch ops on every edge.

The Fuller binary diffusion is separable, D_ij = g(T, P) / den[i, j], so
the Stefan-Maxwell matrix uses one per-edge scalar g against the static
(S, S) ``den``; the molar-to-mass gradient operator is solved in its
rank-2 Woodbury form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from su2_tpu_torch.state import Layout

TWO3 = 2.0 / 3.0


@dataclass(frozen=True)
class SpeciesConsts:
    """mm_col (S, 1) molar masses, sm_den (S, S) Fuller denominator
    Mij*(vi^(1/3)+vj^(1/3))^2, mm_sum the sum of molar masses."""
    mm_col: torch.Tensor
    sm_den: torch.Tensor
    mm_sum: float


def species_consts(mm, diff_vol, dtype, device="cpu") -> SpeciesConsts:
    mm = np.asarray(mm, dtype=np.float64)
    dv = np.asarray(diff_vol, dtype=np.float64)
    mij = np.sqrt(mm[:, None] * mm[None, :] / (mm[:, None] + mm[None, :]))
    cbr = np.cbrt(dv)
    den = mij * (cbr[:, None] + cbr[None, :]) ** 2
    t = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    return SpeciesConsts(mm_col=t(mm[:, None]), sm_den=t(den),
                         mm_sum=float(mm.sum()))


def gauss_solve_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pivot-free Gauss-Jordan, trailing batch axis: a (n, n, E),
    b (n, k, E) -> (n, k, E)."""
    n = a.shape[0]
    aug = torch.cat([a, b], dim=1)
    rows = torch.arange(n, device=a.device).reshape(n, 1, 1)
    for col in range(n):
        pivval = aug[col, col][None]
        safe = torch.where(pivval == 0.0, 1.0, pivval)
        prow = aug[col] / safe
        factors = aug[:, col][:, None]
        aug = torch.where(rows == col, prow[None], aug - factors * prow[None])
    return aug[:, n:]


def _clip_ys_t(ys):
    return torch.where(ys < 0.0, 1.0e-30, ys)


def _molar_from_mass_t(mm_col, ys):
    ysc = _clip_ys_t(ys)
    xs = ysc / mm_col
    return xs * (ysc.sum(0, keepdim=True) / xs.sum(0, keepdim=True))


def _rowsum(x):
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out + x[k]
    return out


def _stefan_maxwell_gamma_g(mm_col, rho, xs, ys, g, den):
    """GetGamma (reacting_model_library.cpp:771-798), (S, S, E), from the
    separable Fuller form dij[a, b] = g / den[a, b]."""
    s = mm_col.shape[0]
    eye = torch.eye(s, dtype=xs.dtype, device=xs.device)
    sigma = ys.sum(0)
    mtot = 1.0 / (ys / mm_col).sum(0)
    prefg = sigma * mtot / (rho * g)
    mm_row = mm_col.T
    k1 = den / mm_row * (1.0 - eye)
    a_mat = den * (1.0 - eye)
    sum_terms = a_mat[:, 0][:, None] * xs[0][None]
    for k in range(1, s):
        sum_terms = sum_terms + a_mat[:, k][:, None] * xs[k][None]
    diag = prefg[None] * sum_terms / mm_col
    off = -(prefg[None] * xs)[:, None, :] * k1[:, :, None]
    return off + eye[:, :, None] * diag[:, None, :]


def _molar2mass_solve_t(mm_col, mm_sum, ys, xs, b):
    """Solve M gy = b for the Get_Molar2MassGrad_Operator M
    (numerics_direct_reactive.cpp:855-880): M = D + u 1^T + w z^T, solved
    by Woodbury.  b: (S, R, E); returns (S, R, E)."""
    s = mm_col.shape[0]
    sigma = xs.sum(0)
    dinv = mm_col / (mm_sum * sigma)[None]
    u = mm_sum * ys / mm_col
    w = -mm_sum * xs
    zc = 1.0 / mm_col
    du = dinv * u
    dw = dinv * w
    g11 = 1.0 + _rowsum(du)
    g12 = _rowsum(dw)
    g21 = _rowsum(zc * du)
    g22 = 1.0 + _rowsum(zc * dw)
    det = g11 * g22 - g12 * g21
    det = torch.where(det == 0.0, 1.0, det)
    cols = []
    for r in range(b.shape[1]):
        db = dinv * b[:, r]
        c1 = _rowsum(db)
        c2 = _rowsum(zc * db)
        a1 = (g22 * c1 - g12 * c2) / det
        a2 = (g11 * c2 - g21 * c1) / det
        cols.append((db - du * a1[None] - dw * a2[None])[:, None])
    return torch.cat(cols, dim=1)


def fuller_factor(lay: Layout, v):
    """g(T, P) = 1e-7 T^1.75 / P[atm]: the Fuller D_ij times den, in m^2/s."""
    return 1.0e-7 * v[lay.T] ** 1.75 / (v[lay.P] / 101325.0)


def viscous_flux_t(lay: Layout, sc: SpeciesConsts, v_i, v_j, g_i, g_j,
                   normal, evec, mu_i, mu_j, ka_i, ka_j, mu_t_i, mu_t_j,
                   tke_i, tke_j, gk_i, gk_j, sigma_k, h_s, cp_s,
                   prandtl_turb: float, lewis_turb: float,
                   corrected: bool = True, v_fuller_j=None, s_i=None,
                   s_j=None):
    """Projected viscous flux with the SST closure, feature-major.

    v_*: (nPrim, E); g_*: (1+nd+ns, d, E) gradients of [T, u.., X..];
    normal, evec: (d, E) (evec = x_j - x_i; read only by the correction
    and the Jacobians); mu/ka/mu_t/tke/sigma_k: (E,); gk_*: (d, E);
    mu_t_i None: laminar, without the SST closure (mu_t_j, tke_*, gk_*
    and sigma_k are not read);
    h_s/cp_s: (S, E) species enthalpy/cp at the face-mean T.
    corrected: edge-projection correction (interior faces).
    v_fuller_j: state whose (T, P) gives side j's Fuller factor (boundary
    faces evaluate D_ij at the domain node on both sides).
    s_*: (nVar, E) dT/dU rows; with them the approximate Jacobians
    (nVar, nVar, E) are returned too.
    Returns flux (nVar, E) with the reference's Proj_Flux_Tensor sign
    [, jac_i, jac_j]."""
    nd, ns = lay.ndim, lay.ns
    mm_col = sc.mm_col

    def harm(a, b):
        return 2.0 / (1.0 / a + 1.0 / b)

    mu = harm(mu_i, mu_j)
    ktr = harm(ka_i, ka_j)
    f_i = fuller_factor(lay, v_i)
    f_j = fuller_factor(lay, v_j if v_fuller_j is None else v_fuller_j)
    g_fuller = harm(f_i, f_j)

    vmean = 0.5 * (v_i + v_j)
    rho = vmean[lay.PRHO]
    ys = vmean[lay.YS:lay.YS + ns]
    ysc = _clip_ys_t(ys)
    xs = _molar_from_mass_t(mm_col, ys)

    gmean = 0.5 * (g_i + g_j)                                  # (G, d, E)
    tiny = 1e-300 if v_i.dtype == torch.float64 else 1e-30
    jac = s_i is not None
    if corrected or jac:
        dist2 = torch.clamp((evec * evec).sum(0), min=tiny)
        xs_i = _molar_from_mass_t(mm_col, v_i[lay.YS:lay.YS + ns])
        xs_j = _molar_from_mass_t(mm_col, v_j[lay.YS:lay.YS + ns])
    if corrected:
        diff = torch.cat([(v_j[lay.T] - v_i[lay.T])[None],
                          v_j[lay.VX:lay.VX + nd] - v_i[lay.VX:lay.VX + nd],
                          xs_j - xs_i], dim=0)
        proj = gmean[:, 0] * evec[0][None]
        for d in range(1, nd):
            proj = proj + gmean[:, d] * evec[d][None]
        gmean = gmean - ((proj - diff) / dist2[None])[:, None, :] * evec[None]

    g_t = gmean[0]
    g_vel = gmean[1:1 + nd]
    g_xs = gmean[1 + nd:]

    div_vel = g_vel[0, 0]
    for d in range(1, nd):
        div_vel = div_vel + g_vel[d, d]
    eye_d = torch.eye(nd, dtype=v_i.dtype, device=v_i.device)
    sym = g_vel + g_vel.transpose(0, 1)
    tau = mu[None, None] * sym \
        - (TWO3 * mu * div_vel)[None, None] * eye_d[:, :, None]
    vel = vmean[lay.VX:lay.VX + nd]

    def dot_n(x):                      # (.., d, E) . normal -> (.., E)
        out = x[..., 0, :] * normal[0]
        for d in range(1, nd):
            out = out + x[..., d, :] * normal[d]
        return out

    grad_xs_norm = dot_n(g_xs)                                 # (S, E)
    den = sc.sm_den
    gamma = _stefan_maxwell_gamma_g(mm_col, rho, xs, ysc, g_fuller, den)
    alpha = den.min() / (rho * g_fuller)
    gt = gamma + (alpha * ysc)[:, None, :]
    jd = gauss_solve_t(gt, -grad_xs_norm[:, None, :])[:, 0, :]
    e_heat = -_rowsum(h_s * jd)

    def tau_n(tt):                     # sum_i tau[i, j] n_i -> (nd, E)
        return torch.stack([sum(tt[i_, j_] * normal[i_] for i_ in range(nd))
                            for j_ in range(nd)], dim=0)

    def tau_vn(tt):
        return sum(tt[i_, j_] * vel[j_] * normal[i_]
                   for i_ in range(nd) for j_ in range(nd))

    gtn = dot_n(g_t[None])[0]
    mom = tau_n(tau)
    e_tau = tau_vn(tau)
    e_cond = ktr * gtn

    species = -jd
    mu_t = gy = cmt = None
    if mu_t_i is not None:
        # SST closure (SST_Reactive_ResidualClosure, :656-889)
        mu_t = harm(mu_t_i, mu_t_j)
        tke = 0.5 * (tke_i + tke_j)
        g_k = 0.5 * (gk_i + gk_j)
        tau_t = mu_t[None, None] * sym \
            - (TWO3 * (mu_t * div_vel + tke * rho))[None, None] \
            * eye_d[:, :, None]
        mom = mom + tau_n(tau_t)
        e_tau = e_tau + tau_vn(tau_t)
        gy = _molar2mass_solve_t(mm_col, sc.mm_sum, ysc, xs, g_xs)
        gy = torch.where(torch.abs(g_xs) < 1e-8, 0.0, gy)    # (S, d, E)
        cmt = mu_t / (prandtl_turb * lewis_turb)
        gy_n = dot_n(gy)
        e_heat = e_heat + cmt * _rowsum(h_s * ysc * gy_n)
        e_cond = e_cond + (mu_t / prandtl_turb) * _rowsum(cp_s * ysc) * gtn
        e_cond = e_cond + (mu + mu_t / sigma_k) * dot_n(g_k[None])[0]
        species = species + cmt[None] * gy_n

    flux = torch.cat([(-_rowsum(jd))[None], mom,
                      (e_tau + e_cond + e_heat)[None], species], dim=0)
    if not jac:
        return flux

    area = torch.sqrt((normal * normal).sum(0))
    area_s = torch.clamp(area, min=tiny)
    unit = normal / area_s
    dist = torch.sqrt(dist2)
    # per-side mean effective diffusion (reference :556-575) from the
    # separable Fuller form: ds = f_side (1 - xs) / sum_{k!=s} den[s,k] xs_k,
    # with 1 - xs_s taken as sum_{k!=s} xs_k.  The two differ by
    # 1 - sum_k xs_k, which the implicit update leaves at ~1e-9..1e-8 (it
    # does not keep sum rho_s = rho).  Where species s is nearly pure and
    # the others are traces, that residue, not the traces, sets 1 - xs_s
    # over a trace-sized sum: with the JAX package's form a 1e-15 change of
    # the state moves an implicit step by far more than rounding, and the
    # synthetic channel's pure streams turn non-finite; with this one,
    # both packages agree there (tests/test_torch_pure_streams.py).
    eye_s = torch.eye(ns, dtype=v_i.dtype, device=v_i.device)
    dmask = den * (1.0 - eye_s)

    def eff_ds(xs_side, f_side):
        q = dmask[:, 0][:, None] * xs_side[0][None]
        rest = (1.0 - eye_s[:, 0])[:, None] * xs_side[0][None]
        for k in range(1, ns):
            q = q + dmask[:, k][:, None] * xs_side[k][None]
            rest = rest + (1.0 - eye_s[:, k])[:, None] * xs_side[k][None]
        ds_side = f_side[None] * rest / torch.where(q == 0.0, 1.0, q)
        return torch.where((q == 0.0) | ~torch.isfinite(ds_side), 0.0,
                           ds_side)

    ds = 0.5 * (eff_ds(xs_i, f_i) + eff_ds(xs_j, f_j))
    jac_i, jac_j = _viscous_jacobians_t(
        lay, sc, v_i, v_j, vmean, mu, ktr, ds, xs, xs_i, xs_j,
        grad_xs_norm / area_s[None], jd, dist, area, unit, s_i, s_j, flux,
        mu_t, gy, cmt, ysc, h_s, cp_s, prandtl_turb)
    return flux, jac_i, jac_j


def _viscous_jacobians_t(lay, sc, v_i, v_j, vmean, mu, ktr, ds, xs, xs_i,
                         xs_j, grad_xs_norm, jd, dist, area, unit, s_i, s_j,
                         flux, mu_t, gy, cmt, ys, h_s, cp_s, prandtl_turb):
    """dF/dV . dV/dU (SetLaminarViscousProjJacs :1200-1409 +
    SST_Reactive_JacobianClosure :891-1097, 2D and 3D; mu_t None:
    laminar), the (nVar, nVar) block held as lists of (E,) rows, the sparse
    dV/dU applied analytically."""
    nd, ns, nvar = lay.ndim, lay.ns, lay.nvar
    mm_col = sc.mm_col
    tot_mass = _rowsum(mm_col * xs)
    tot_mass_i = _rowsum(mm_col * xs_i)
    tot_mass_j = _rowsum(mm_col * xs_j)
    sigma_i = _rowsum(xs_i)
    sigma_j = _rowsum(xs_j)
    rho = vmean[lay.PRHO]
    rho_i = v_i[lay.PRHO]
    rho_j = v_j[lay.PRHO]
    mds = mm_col * ds                                        # (S, E)

    def djdr(xs_side, tot_side, sigma_side, rho_side, sgn):
        """dJ/dr species blocks (reference :1260-1293), rows [s][k]."""
        c = rho / (tot_mass * dist * sigma_side * rho_side)
        t12 = -mds * xs_side * c[None] \
            + ys * (_rowsum(mds * xs_side) * c)[None]
        ck = rho * tot_side * sigma_side / (dist * tot_mass * rho_side)
        t3_col = ds * ck[None]
        extra = (0.5 * rho / (tot_mass * rho_side)) \
            * _rowsum(mds * grad_xs_norm)
        rows = []
        for s_ in range(ns):
            row = [sgn * (t12[s_] + ys[s_] * t3_col[k]) for k in range(ns)]
            row[s_] = row[s_] + sgn * (-ds[s_] * ck) + extra
            rows.append(row)
        return rows

    djdr_j = djdr(xs_j, tot_mass_j, sigma_j, rho_j, 1.0)
    djdr_i = djdr(xs_i, tot_mass_i, sigma_i, rho_i, -1.0)

    # dF/dV as [a][b] of (E,) rows (None: zero); thin-shear tensor
    # M = theta I + n (x) n / 3, pi = M u (2D :912-918, 3D :981-995)
    theta = unit[0] * unit[0]
    for d in range(1, nd):
        theta = theta + unit[d] * unit[d]
    mrows = [[(theta + unit[d] * unit[d] / 3.0) if d == e
              else unit[d] * unit[e] / 3.0 for e in range(nd)]
             for d in range(nd)]
    pi = [sum(vmean[lay.VX + e] * mrows[d][e] for e in range(nd))
          for d in range(nd)]
    coef = mu / dist * area

    def emp():
        return [[None] * nvar for _ in range(nvar)]

    def dadd(m, a, b, val):
        m[a][b] = val if m[a][b] is None else m[a][b] + val

    dfdv_j = emp()
    for d in range(nd):
        for e in range(nd):
            dadd(dfdv_j, lay.RHOVX + d, lay.RHOVX + e, coef * mrows[d][e])
        dadd(dfdv_j, lay.RHOE, lay.RHOVX + d, coef * pi[d])
    dadd(dfdv_j, lay.RHOE, lay.RHOE, ktr * theta / dist * area)
    dfdv_i = emp()
    for a in range(nvar):
        for b in range(nvar):
            if dfdv_j[a][b] is not None:
                dfdv_i[a][b] = -dfdv_j[a][b]
    # shared Cp-weighted Jd term on the energy diagonal
    jd_cp = -0.5 * _rowsum(jd * cp_s)
    dadd(dfdv_i, lay.RHOE, lay.RHOE, jd_cp)
    dadd(dfdv_j, lay.RHOE, lay.RHOE, jd_cp)
    # species / density / energy rows from dJ/dr
    for side, dj in ((dfdv_j, djdr_j), (dfdv_i, djdr_i)):
        for k in range(ns):
            col_rho = col_e = None
            for s_ in range(ns):
                val = -dj[s_][k] * area
                side[lay.RHOS + s_][lay.RHOS + k] = val
                col_rho = val if col_rho is None else col_rho + val
                he = val * h_s[s_]
                col_e = he if col_e is None else col_e + he
            dadd(side, lay.RHO, lay.RHOS + k, col_rho)
            dadd(side, lay.RHOE, lay.RHOS + k, col_e)
    if mu_t is not None:
        # SST closure Jacobian (2D :911-983, 3D :996-1090)
        coef_t = mu_t / dist * area
        add = emp()
        for d in range(nd):
            for e in range(nd):
                dadd(add, lay.RHOVX + d, lay.RHOVX + e, coef_t * mrows[d][e])
            dadd(add, lay.RHOE, lay.RHOVX + d, coef_t * pi[d])
        cpy = _rowsum(cp_s * ys)
        dadd(add, lay.RHOE, lay.RHOE,
             mu_t / prandtl_turb * cpy * theta / dist * area)
        ce = cmt / dist * area * theta
        if nd == 2:
            for k in range(ns):
                dadd(dfdv_j, lay.RHOE, lay.RHOS + k,
                     ce * h_s[k] * ys[k] / rho_j)
                dadd(dfdv_i, lay.RHOE, lay.RHOS + k,
                     -ce * h_s[k] * ys[k] / rho_i)
        else:
            # the reference's 3D branch (:983-1075) keeps the species
            # mass-closure diagonal that 2D comments out (:957-966),
            # mu_t / (Pr_t Le_t) / dist area theta Y_k / rho: ce (cmt holds
            # Le_t); and its energy-species term has no Y_k factor (:1067)
            for k in range(ns):
                dadd(dfdv_j, lay.RHOE, lay.RHOS + k, ce * h_s[k] / rho_j)
                dadd(dfdv_i, lay.RHOE, lay.RHOS + k, -ce * h_s[k] / rho_i)
                dadd(dfdv_j, lay.RHOS + k, lay.RHOS + k, ce * ys[k] / rho_j)
                dadd(dfdv_i, lay.RHOS + k, lay.RHOS + k, -ce * ys[k] / rho_i)
        for a in range(nvar):
            for b in range(nvar):
                if add[a][b] is not None:
                    dadd(dfdv_j, a, b, add[a][b])
                    dadd(dfdv_i, a, b, -add[a][b])
        # common energy-diagonal term with the mass-fraction gradients
        aux = [sum(gy[s_, d] * unit[d] for d in range(nd)) for s_ in range(ns)]
        com = cmt * sum(cp_s[s_] * ys[s_] * aux[s_] for s_ in range(ns)) * area
        dadd(dfdv_i, lay.RHOE, lay.RHOE, com)
        dadd(dfdv_j, lay.RHOE, lay.RHOE, com)
    # common flux-dependent term on the energy/velocity entries
    for d in range(nd):
        hm = 0.5 * flux[lay.RHOVX + d]
        dadd(dfdv_i, lay.RHOE, lay.RHOVX + d, hm)
        dadd(dfdv_j, lay.RHOE, lay.RHOVX + d, hm)

    def apply_dvdu(dfdv, vrow, srow):
        """dV/dU rows: RHO -> e_RHO; RHOVX+d -> (-u_d/rho) e_RHO + e_d/rho;
        RHOE -> s (the dT/dU row); RHOS+s -> e_s."""
        rho_l = vrow[lay.PRHO]
        zero = torch.zeros_like(rho_l)
        rows = []
        for a in range(nvar):
            g = dfdv[a]
            ge = g[lay.RHOE]
            col_rho = g[lay.RHO]
            for d in range(nd):
                gv = g[lay.RHOVX + d]
                if gv is not None:
                    term = -gv * vrow[lay.VX + d] / rho_l
                    col_rho = term if col_rho is None else col_rho + term
            if ge is not None:
                term = ge * srow[lay.RHO]
                col_rho = term if col_rho is None else col_rho + term
            cols = [col_rho if col_rho is not None else zero]
            for d in range(nd):
                gv = g[lay.RHOVX + d]
                cv = gv / rho_l if gv is not None else None
                if ge is not None:
                    term = ge * srow[lay.RHOVX + d]
                    cv = term if cv is None else cv + term
                cols.append(cv if cv is not None else zero)
            cols.append(ge * srow[lay.RHOE] if ge is not None else zero)
            for s_ in range(ns):
                cs = g[lay.RHOS + s_]
                if ge is not None:
                    term = ge * srow[lay.RHOS + s_]
                    cs = term if cs is None else cs + term
                cols.append(cs if cs is not None else zero)
            rows.append(torch.stack(cols, dim=0))
        return torch.stack(rows, dim=0)                      # (nvar, nvar, E)

    return apply_dvdu(dfdv_i, v_i, s_i), apply_dvdu(dfdv_j, v_j, s_j)
