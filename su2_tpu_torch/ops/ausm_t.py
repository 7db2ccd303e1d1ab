"""Feature-major AUSM+-up convective flux (torch, explicit).

CUpwReactiveAUSM::ComputeResidual (numerics_direct_reactive.cpp:53-383)
over a batch of faces, every array (features, edges).  This is the
convective half of the plain version of kernel T3 (csrc/edge_flux.cu) and
also serves the boundary faces.  Constants: Kp=0.25, sigma=1, Ku=0.75,
beta=1/8.
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


def ausm_flux_t(lay: Layout, v_i, v_j, normal, m_infty: float):
    """v_*: (nPrim, E) primitives; normal: (d, E) area normals.
    Returns the residual (nVar, E)."""
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
    mom = res[lay.RHOVX:lay.RHOVX + nd] + (p_lf * area) * unit
    return torch.cat([res[:lay.RHOVX], mom, res[lay.RHOVX + nd:]], dim=0)
