"""Aerodynamic force/heat-flux monitoring (Pressure_Forces/Friction_Forces/
Heat_Fluxes equivalent, reference: solver_direct_mean.cpp patterns used by
the reactive solver's COutput path), including the per-marker
pressure/friction decomposition that feeds forces_breakdown.dat
(COutput::SetForces_Breakdown, output_structure.cpp).

Host NumPy over the monitored markers' rows, as the JAX package's
solvers/forces.py: the caller copies the rows of v, the gradient, mu,
kappa and mu_t at the markers' nodes to the host once
(Simulation.forces_inputs) and numbers the markers' nodes into those
rows."""

from __future__ import annotations

import numpy as np


def _marker_forces(lay, v, grad, mu, kappa, nodes, normal, p_inf, mu_t,
                   viscous):
    """One marker's (fp, ff, hf_total, hf_max, fvec_p, fvec_f):
    pressure/friction force 3-vectors, heat flux, and the per-vertex
    pressure/friction force vectors (the caller integrates moments)."""
    nd = lay.ndim
    out_n = -np.asarray(normal)                       # outward area normal
    fp = np.zeros(3)
    ff = np.zeros(3)
    p = v[nodes, lay.P]
    fvec_p = (p - p_inf)[:, None] * out_n             # (nb, nd)
    fp[:nd] = fvec_p.sum(axis=0)
    hf_total = 0.0
    hf_max = 0.0
    fvec_f = np.zeros_like(fvec_p)
    if viscous:
        g = grad[nodes]                               # (nb, >= 1 + nd, d)
        gvel = g[:, 1:1 + nd, :]
        mu_n = mu[nodes]
        if mu_t is not None:
            mu_n = mu_n + mu_t[nodes]
        div = np.trace(gvel, axis1=1, axis2=2)
        tau = mu_n[:, None, None] * (gvel + np.swapaxes(gvel, 1, 2))
        for d in range(nd):
            tau[:, d, d] -= 2.0 / 3.0 * mu_n * div
        fvec_f = -np.einsum("vij,vi->vj", tau, out_n)
        ff[:nd] = fvec_f.sum(axis=0)
        area = np.linalg.norm(out_n, axis=1)
        gt = g[:, 0, :]
        q = -kappa[nodes] * np.einsum("vd,vd->v", gt, out_n)
        hf_total = float(q.sum())
        if len(q):
            hf_max = float(np.abs(q / np.maximum(area, 1e-30)).max())
    return fp, ff, hf_total, hf_max, fvec_p, fvec_f


def surface_forces(lay, v, grad, mu, kappa, markers, p_inf: float,
                   rho_inf: float, vel_inf, ref_area: float,
                   viscous: bool = True, mu_t=None, coords=None,
                   origin=(0.25, 0.0, 0.0), ref_len: float = 1.0,
                   aoa_deg: float = 0.0):
    """Force coefficients + heat flux over the markers dict {tag: (nodes,
    normal)}: nodes number rows of the host arrays v (primitives), grad
    (the NS gradient set's rows T and the velocities, (nb, >= 1 + d, d)),
    mu, kappa, mu_t and coords.  Outward normal = -stored vertex normal.

    Returns the monitoring totals (CL/CD/CFx.. keys) plus "splits" (totals
    decomposed into pressure/friction 3-vectors and moments) and
    "per_marker" (the same decomposition per marker) for
    forces_breakdown.dat."""
    vinf2 = float(np.dot(vel_inf, vel_inf))
    q_dyn = 0.5 * rho_inf * vinf2 * ref_area
    a = np.deg2rad(aoa_deg)
    ca, sa = np.cos(a), np.sin(a)

    def coeffs(fvec_p, fvec_f, mom_p, mom_f):
        cp = fvec_p / q_dyn
        cf = fvec_f / q_dyn
        # 2D wind-axis rotation (3D: same in the x-y plane; shipped cases
        # fly alpha in that plane)
        qm = q_dyn * ref_len
        return {
            "CFx": (cp[0], cf[0]), "CFy": (cp[1], cf[1]),
            "CFz": (cp[2], cf[2]),
            "CD": (cp[0] * ca + cp[1] * sa, cf[0] * ca + cf[1] * sa),
            "CL": (-cp[0] * sa + cp[1] * ca, -cf[0] * sa + cf[1] * ca),
            "CMx": (mom_p[0] / qm, mom_f[0] / qm),
            "CMy": (mom_p[1] / qm, mom_f[1] / qm),
            "CMz": (mom_p[2] / qm, mom_f[2] / qm),
        }

    totals_p = np.zeros(3)
    totals_f = np.zeros(3)
    moms_p = np.zeros(3)
    moms_f = np.zeros(3)
    hf_total = 0.0
    hf_max = 0.0
    per_marker = {}
    for tag, (nodes, normal) in markers.items():
        fp, ff, hft, hfm, fvp, fvf = _marker_forces(
            lay, v, grad, mu, kappa, nodes, normal, p_inf, mu_t, viscous)
        m_p = np.zeros(3)
        m_f = np.zeros(3)
        if coords is not None and lay.ndim >= 2:
            xy = coords[nodes]
            darm = np.zeros((xy.shape[0], 3))
            darm[:, :lay.ndim] = xy - np.asarray(origin)[:lay.ndim]
            fv3_p = np.zeros((xy.shape[0], 3))
            fv3_p[:, :lay.ndim] = fvp
            fv3_f = np.zeros((xy.shape[0], 3))
            fv3_f[:, :lay.ndim] = fvf
            m_p = np.cross(darm, fv3_p).sum(axis=0)
            m_f = np.cross(darm, fv3_f).sum(axis=0)
        totals_p += fp
        totals_f += ff
        moms_p += m_p
        moms_f += m_f
        hf_total += hft
        hf_max = max(hf_max, hfm)
        per_marker[tag] = coeffs(fp, ff, m_p, m_f)

    splits = coeffs(totals_p, totals_f, moms_p, moms_f)
    tot = {k: p + f for k, (p, f) in splits.items()}
    return {"CL": tot["CL"], "CD": tot["CD"], "CFx": tot["CFx"],
            "CFy": tot["CFy"], "CFz": tot["CFz"],
            "CMx": tot["CMx"], "CMy": tot["CMy"], "CMz": tot["CMz"],
            "HF_total": hf_total, "HF_max": hf_max,
            "splits": splits, "per_marker": per_marker}
