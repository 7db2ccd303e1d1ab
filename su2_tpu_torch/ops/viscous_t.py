"""Feature-major viscous flux with Stefan-Maxwell diffusion and the SST
closure (torch, explicit).

CAvgGradReactive_Flow / CAvgGradReactive_Boundary (reference:
numerics_direct_reactive.cpp:385-1684 and the SST closure :656-889) with
every array (features, edges).  This is the viscous half of the plain
version of kernel T3 (csrc/edge_flux.cu); the boundary faces use it with
``corrected=False`` and the Fuller factor of the domain node on both sides.

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
                   corrected: bool = True, v_fuller_j=None):
    """Projected viscous flux with the SST closure, feature-major.

    v_*: (nPrim, E); g_*: (1+nd+ns, d, E) gradients of [T, u.., X..];
    normal, evec: (d, E); mu/ka/mu_t/tke/sigma_k: (E,); gk_*: (d, E);
    h_s/cp_s: (S, E) species enthalpy/cp at the face-mean T.
    corrected: edge-projection correction (interior faces).
    v_fuller_j: state whose (T, P) gives side j's Fuller factor (boundary
    faces evaluate D_ij at the domain node on both sides).
    Returns flux (nVar, E) with the reference's Proj_Flux_Tensor sign."""
    nd, ns = lay.ndim, lay.ns
    mm_col = sc.mm_col

    def harm(a, b):
        return 2.0 / (1.0 / a + 1.0 / b)

    mu = harm(mu_i, mu_j)
    ktr = harm(ka_i, ka_j)
    g_fuller = harm(fuller_factor(lay, v_i), fuller_factor(
        lay, v_j if v_fuller_j is None else v_fuller_j))

    vmean = 0.5 * (v_i + v_j)
    rho = vmean[lay.PRHO]
    ys = vmean[lay.YS:lay.YS + ns]
    ysc = _clip_ys_t(ys)
    xs = _molar_from_mass_t(mm_col, ys)

    gmean = 0.5 * (g_i + g_j)                                  # (G, d, E)
    if corrected:
        tiny = 1e-300 if v_i.dtype == torch.float64 else 1e-30
        dist2 = torch.clamp((evec * evec).sum(0), min=tiny)
        xs_i = _molar_from_mass_t(mm_col, v_i[lay.YS:lay.YS + ns])
        xs_j = _molar_from_mass_t(mm_col, v_j[lay.YS:lay.YS + ns])
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

    # SST closure (SST_Reactive_ResidualClosure, :656-889)
    mu_t = harm(mu_t_i, mu_t_j)
    tke = 0.5 * (tke_i + tke_j)
    g_k = 0.5 * (gk_i + gk_j)
    tau_t = mu_t[None, None] * sym \
        - (TWO3 * (mu_t * div_vel + tke * rho))[None, None] * eye_d[:, :, None]
    mom = mom + tau_n(tau_t)
    e_tau = e_tau + tau_vn(tau_t)
    gy = _molar2mass_solve_t(mm_col, sc.mm_sum, ysc, xs, g_xs)  # (S, d, E)
    gy = torch.where(torch.abs(g_xs) < 1e-8, 0.0, gy)
    cmt = mu_t / (prandtl_turb * lewis_turb)
    gy_n = dot_n(gy)
    e_heat = e_heat + cmt * _rowsum(h_s * ysc * gy_n)
    e_cond = e_cond + (mu_t / prandtl_turb) * _rowsum(cp_s * ysc) * gtn
    e_cond = e_cond + (mu + mu_t / sigma_k) * dot_n(g_k[None])[0]

    return torch.cat([(-_rowsum(jd))[None], mom,
                      (e_tau + e_cond + e_heat)[None],
                      -jd + cmt[None] * gy_n], dim=0)
