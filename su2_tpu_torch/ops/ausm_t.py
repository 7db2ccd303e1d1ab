"""Feature-major AUSM+-up convective flux and its Jacobians (torch).

CUpwReactiveAUSM::ComputeResidual (numerics_direct_reactive.cpp:53-383)
over a batch of faces, every array (features, edges).  This is the
convective half of the plain versions of kernels T3 (csrc/edge_flux.cu)
and K10 (csrc/edge_implicit.cu, with the Jacobians) and also serves the
boundary faces.  Constants: Kp=0.25, sigma=1, Ku=0.75, beta=1/8.
"""

from __future__ import annotations

import torch

from su2_tpu_torch.state import Layout

KP = 0.25
SIGMA = 1.0
KU = 0.75
BETA = 0.125


def _split_mach(m):
    sub = torch.abs(m) < 1.0
    m_p = torch.where(sub, 0.25 * (m + 1.0) ** 2 + BETA * (m * m - 1.0) ** 2,
                      0.5 * (m + torch.abs(m)))
    m_m = torch.where(sub, -0.25 * (m - 1.0) ** 2 - BETA * (m * m - 1.0) ** 2,
                      0.5 * (m - torch.abs(m)))
    return m_p, m_m


def _press_polys(m, alpha):
    sub = torch.abs(m) < 1.0
    safe_m = torch.where(m == 0.0, 1.0, m)
    p_p = torch.where(sub, 0.25 * (m + 1.0) ** 2 * (2.0 - m)
                      + alpha * m * (m * m - 1.0) ** 2,
                      0.5 * (1.0 + torch.abs(m) / safe_m))
    p_m = torch.where(sub, 0.25 * (m - 1.0) ** 2 * (2.0 + m)
                      - alpha * m * (m * m - 1.0) ** 2,
                      0.5 * (1.0 - torch.abs(m) / safe_m))
    return p_p, p_m


def _add_rows(x, start, vals):
    """x with vals added to rows start..start + len(vals)."""
    w = vals.shape[0]
    return torch.cat([x[:start], x[start:start + w] + vals, x[start + w:]],
                     dim=0)


def ausm_flux_t(lay: Layout, v_i, v_j, normal, m_infty: float, s_i=None,
                s_j=None):
    """v_*: (nPrim, E) primitives; normal: (d, E) area normals; s_*:
    (nVar, E) dP/dU rows.  Returns the residual (nVar, E); with s_i/s_j
    also the Jacobians jac_i, jac_j (nVar, nVar, E)."""
    nd, ns = lay.ndim, lay.ns
    area = torch.sqrt((normal * normal).sum(0))
    # zero-area guard: padded family slots carry a zero normal and give
    # exactly zero flux
    tiny = 1e-300 if area.dtype == torch.float64 else 1e-30
    unit = normal / torch.clamp(area, min=tiny)

    rho_i, rho_j = v_i[lay.PRHO], v_j[lay.PRHO]
    p_i, p_j = v_i[lay.P], v_j[lay.P]
    vel_i = v_i[lay.VX:lay.VX + nd]
    vel_j = v_j[lay.VX:lay.VX + nd]
    proj_i = (vel_i * unit).sum(0)
    proj_j = (vel_j * unit).sum(0)

    a_mean = 0.5 * (v_i[lay.A] + v_j[lay.A])
    m_l = proj_i / a_mean
    m_r = proj_j / a_mean
    m_f2 = 0.5 * (m_l * m_l + m_r * m_r)
    m_ref2 = torch.clamp(torch.clamp(m_f2, min=m_infty * m_infty), max=1.0)
    m_ref = torch.sqrt(m_ref2)
    fa = m_ref * (2.0 - m_ref)
    alpha = 3.0 / 16.0 * (5.0 * fa * fa - 4.0)

    m_lp, _ = _split_mach(m_l)
    _, m_rm = _split_mach(m_r)
    p_lp, _ = _press_polys(m_l, alpha)
    _, p_rm = _press_polys(m_r, alpha)

    rho_mean = 0.5 * (rho_i + rho_j)
    factor = torch.clamp(1.0 - SIGMA * m_f2, min=0.0)
    m12 = m_lp + m_rm - KP / fa * factor * (p_j - p_i) \
        / (rho_mean * a_mean * a_mean)
    m_lf = 0.5 * (m12 + torch.abs(m12))
    m_rf = 0.5 * (m12 - torch.abs(m12))
    mass12 = a_mean * (m_lf * rho_i + m_rf * rho_j)

    one = torch.ones_like(rho_i)
    phi_i = torch.cat([one[None], vel_i, v_i[lay.H][None],
                       v_i[lay.YS:lay.YS + ns]], dim=0)
    phi_j = torch.cat([one[None], vel_j, v_j[lay.H][None],
                       v_j[lay.YS:lay.YS + ns]], dim=0)
    res = 0.5 * (mass12 * (phi_i + phi_j)
                 + torch.abs(mass12) * (phi_i - phi_j)) * area

    p_lf = p_lp * p_i + p_rm * p_j \
        - KU * p_lp * p_rm * (rho_i + rho_j) * fa * a_mean * (proj_j - proj_i)
    res = _add_rows(res, lay.RHOVX, (p_lf * area) * unit)
    if s_i is None:
        return res
    jac_i, jac_j = _jacobians(
        lay, s_i, s_j, unit, area, rho_i, rho_j, p_i, p_j, proj_i, proj_j,
        a_mean, m_l, m_r, m_f2, m_ref2, fa, alpha, p_lp, p_rm, rho_mean,
        factor, m12, m_lf, m_rf, phi_i, phi_j)
    return res, jac_i, jac_j


def _jacobians(lay, s_i, s_j, unit, area, rho_i, rho_j, p_i, p_j, proj_i,
               proj_j, a_mean, m_l, m_r, m_f2, m_ref2, fa, alpha, p_lp, p_rm,
               rho_mean, factor, m12, m_lf, m_rf, phi_i, phi_j):
    """dF/dU_i, dF/dU_j of the AUSM+-up flux (CUpwReactiveAUSM implicit
    part), (nVar, nVar, E) each."""
    nvar = lay.nvar
    zer = torch.zeros((nvar,) + rho_i.shape, dtype=rho_i.dtype,
                      device=rho_i.device)

    def set_rows(x, start, vals):
        w = vals.shape[0]
        return torch.cat([x[:start], vals, x[start + w:]], dim=0)

    mld = set_rows(zer, lay.RHO, (-m_l / rho_i)[None])
    mld = set_rows(mld, lay.RHOVX, unit / (rho_i * a_mean))
    mrd = set_rows(zer, lay.RHO, (-m_r / rho_j)[None])
    mrd = set_rows(mrd, lay.RHOVX, unit / (rho_j * a_mean))

    sub_l = (torch.abs(m_l) < 1.0)[None]
    sub_r = (torch.abs(m_r) < 1.0)[None]
    safe_ml = torch.where(m_l == 0.0, 1.0, m_l)
    safe_mr = torch.where(m_r == 0.0, 1.0, m_r)
    mpol_ld = torch.where(
        sub_l, mld * (0.5 * (m_l + 1.0) + 4.0 * BETA * m_l
                      * (m_l * m_l - 1.0)),
        mld * (0.5 * (1.0 + torch.abs(m_l) / safe_ml)))
    mpol_rd = torch.where(
        sub_r, mrd * (0.5 * (1.0 - m_r) + 4.0 * BETA * m_r
                      * (1.0 - m_r * m_r)),
        mrd * (0.5 * (1.0 - torch.abs(m_r) / safe_mr)))

    m_f = torch.sqrt(m_f2)
    at_ref = (m_f2 == m_ref2)[None]
    safe_mf = torch.where(m_f == 0.0, 1.0, m_f)
    scal_ld = torch.where(at_ref, mld * (m_l * (1.0 - m_f) / safe_mf), 0.0)
    scal_rd = torch.where(at_ref, mrd * (m_r * (1.0 - m_f) / safe_mf), 0.0)

    fpos = (factor > 0.0).to(rho_i.dtype)
    dp = p_j - p_i
    c0 = KP / (a_mean * a_mean * fa * fa * rho_mean * rho_mean)
    mext_ld = -c0 * (
        (fpos * SIGMA * m_l * dp * fa * rho_mean) * mld
        + (factor * fa * rho_mean) * s_i
        + (factor * dp * rho_mean) * scal_ld)
    mext_rd = c0 * (
        (fpos * SIGMA * m_r * (p_i - p_j) * fa * rho_mean) * mrd
        + (factor * fa * rho_mean) * s_j
        - (factor * dp * rho_mean) * scal_rd)
    c1 = KP / (a_mean * a_mean * fa * rho_mean * rho_mean) * 0.5 * factor \
        * dp
    mext_ld = _add_rows(mext_ld, lay.RHO, (-c1)[None])
    mext_rd = _add_rows(mext_rd, lay.RHO, (-c1)[None])

    sign_m12 = torch.where(m12 == 0.0, 0.0, torch.abs(m12) / torch.where(
        m12 == 0.0, 1.0, m12))
    sp = 1.0 + sign_m12
    sm = 1.0 - sign_m12
    mass_p_ld = 0.5 * (mpol_ld - mext_ld) * sp
    mass_m_ld = 0.5 * (mpol_ld - mext_ld) * sm
    mass_p_rd = 0.5 * (mpol_rd - mext_rd) * sp
    mass_m_rd = 0.5 * (mpol_rd - mext_rd) * sm

    rpi = (rho_i * phi_i)[:, None, :]
    rpj = (rho_j * phi_j)[:, None, :]
    jac_i = a_mean * (rpi * mass_p_ld[None] + rpj * mass_m_ld[None])
    jac_j = a_mean * (rpi * mass_p_rd[None] + rpj * mass_m_rd[None])
    eye = torch.eye(nvar, dtype=rho_i.dtype, device=rho_i.device)[:, :, None]
    jac_i = jac_i + (a_mean * m_lf) * eye
    jac_j = jac_j + (a_mean * m_rf) * eye
    # pressure contribution to the energy row
    jac_i = _add_rows(jac_i, lay.RHOE, ((a_mean * m_lf) * s_i)[None])
    jac_j = _add_rows(jac_j, lay.RHOE, ((a_mean * m_rf) * s_j)[None])

    ppol_ld = torch.where(
        sub_l,
        (0.25 * (m_l + 1.0) * (3.0 * (1.0 - m_l) + 4.0 * alpha
                               * (5.0 * m_l * m_l - 1.0) * (m_l - 1.0)))
        * mld + (15.0 / 8.0 * m_l * (m_l * m_l - 1.0) ** 2) * scal_ld,
        torch.zeros_like(mld))
    ppol_rd = torch.where(
        sub_r,
        (0.25 * (m_r - 1.0) * (3.0 * (1.0 + m_r) + 4.0 * alpha
                               * (1.0 - 5.0 * m_r * m_r) * (m_r + 1.0)))
        * mrd - (15.0 / 8.0 * m_r * (m_r * m_r - 1.0) ** 2) * scal_rd,
        torch.zeros_like(mrd))

    rho_sum = rho_i + rho_j
    dproj = proj_j - proj_i
    pext_ld = (KU * p_rm * a_mean) * (
        (rho_sum * fa * dproj) * ppol_ld + (p_lp * rho_sum * dproj) * scal_ld)
    pext_rd = (KU * p_lp * a_mean) * (
        (rho_sum * fa * dproj) * ppol_rd + (p_rm * rho_sum * dproj) * scal_rd)
    pext_ld = _add_rows(pext_ld, lay.RHO,
                        (KU * p_rm * a_mean * p_lp * fa
                         * (dproj + rho_sum * proj_i / rho_i))[None])
    pext_rd = _add_rows(pext_rd, lay.RHO,
                        (KU * p_lp * a_mean * p_rm * fa
                         * (dproj - rho_sum * proj_j / rho_j))[None])
    pext_ld = _add_rows(pext_ld, lay.RHOVX,
                        -(KU * p_rm * a_mean * p_lp * fa * rho_sum / rho_i)
                        * unit)
    pext_rd = _add_rows(pext_rd, lay.RHOVX,
                        (KU * p_lp * a_mean * p_rm * fa * rho_sum / rho_j)
                        * unit)
    press_ld = p_lp * s_i + p_i * ppol_ld - pext_ld
    press_rd = p_rm * s_j + p_j * ppol_rd - pext_rd
    jac_i = _add_rows(jac_i, lay.RHOVX, unit[:, None, :] * press_ld[None])
    jac_j = _add_rows(jac_j, lay.RHOVX, unit[:, None, :] * press_rd[None])
    return jac_i * area, jac_j * area
