"""Local time step from inviscid/viscous spectral radii (torch).

SetTime_Step (reference: solver_direct_reactive.cpp:2000-2171 Euler,
:5057-5230 NS).  The fork's inviscid eigenvalue uses the area-weighted
projected velocity: Lambda = (|v . N| + a_mean) * Area with N the dual
normal.
"""

from __future__ import annotations

import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.state import Layout

EPS = 1e-16


def boundary_lambda_inv(mesh: MeshArrays, lay: Layout, v: torch.Tensor,
                        lam: torch.Tensor) -> torch.Tensor:
    """Add the boundary-vertex inviscid spectral radii to lam: each marker
    is a zero-padded full-mesh (normal, area) field, so this is one
    elementwise pass per marker."""
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    a = v[:, lay.A]
    for tag in mesh.markers:
        ndv, adv = mesh.marker_dense[tag]
        proj = (vel * ndv).sum(1)
        lam = lam + (torch.abs(proj) + a) * adv
    return lam


def max_lambda_inv(mesh: MeshArrays, lay: Layout, v: torch.Tensor):
    """Per-node accumulated inviscid spectral radius (interior families +
    boundary vertices)."""
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    a = v[:, lay.A]
    if mesh.fam_offsets is None:
        # the edge list (meshes without a static stencil)
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        proj_i = (vel[i] * mesh.edge_normal).sum(1)
        proj_j = (vel[j] * mesh.edge_normal).sum(1)
        lam_e = (torch.abs(0.5 * (proj_i + proj_j)) + 0.5 * (a[i] + a[j])) \
            * mesh.edge_area
        return boundary_lambda_inv(mesh, lay, v, mesh.sum_edges_abs(lam_e))
    lam = torch.zeros_like(a)
    for k, o in enumerate(mesh.fam_offsets):
        nrm = mesh.fam_normal[k]
        area = torch.linalg.norm(nrm, dim=1)
        proj_i = (vel * nrm).sum(1)
        proj_j = (torch.roll(vel, -o, dims=0) * nrm).sum(1)
        mean_a = 0.5 * (a + torch.roll(a, -o, dims=0))
        lam_e = (torch.abs(0.5 * (proj_i + proj_j)) + mean_a) * area
        lam = lam + lam_e + torch.roll(lam_e, o, dims=0)
    return boundary_lambda_inv(mesh, lay, v, lam)


def local_time_step(mesh: MeshArrays, lay: Layout, v: torch.Tensor,
                    cfl: float | torch.Tensor, max_dt: float = 1e6,
                    lam_visc=None, k_v: float = 0.25, lam_inv=None):
    """Per-node dt = CFL*Vol/lambda_inv, with the viscous bound
    CFL*K_v*Vol^2/lambda_visc when given (NS SetTime_Step, :5216-5220).
    cfl: a float, or a 0-d tensor on v's device (CFL_ADAPT's value, read
    by a captured step from its buffer).  Returns (dt, min_dt,
    max_dt_seen)."""
    lam = max_lambda_inv(mesh, lay, v) if lam_inv is None else lam_inv
    vol = mesh.volume
    vol_ok = vol > EPS
    dt = torch.where(vol_ok, cfl * vol / torch.where(lam > 0, lam, 1.0), 0.0)
    if lam_visc is not None:
        dt_v = cfl * k_v * vol ** 2 \
            / torch.where(lam_visc > 0, lam_visc, 1.0)
        dt = torch.where(vol_ok, torch.minimum(dt, dt_v), 0.0)
    min_dt = torch.where(vol_ok, dt, torch.inf).min()
    max_dt_seen = torch.where(vol_ok, dt, 0.0).max()
    dt = torch.clamp(dt, max=max_dt)
    # CVs with a single neighbor take the global min dt (:2120-2123)
    dt = torch.where(mesh.n_neighbors == 1, min_dt, dt)
    return dt, min_dt, max_dt_seen


def apply_time_marching(dt, min_dt, mode: str, unst_dt: float = 0.0,
                        unst_cfl: float = 0.0):
    """TIME_STEPPING: one global dt everywhere (:2125-2143)."""
    if mode != "TIME_STEPPING":
        return dt
    if unst_cfl <= 0.0 and unst_dt > 0.0:
        return torch.full_like(dt, unst_dt)
    return torch.full_like(dt, min_dt)
