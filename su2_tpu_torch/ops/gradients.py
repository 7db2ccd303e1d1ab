"""Spatial gradients of selected primitive variables (torch).

Green-Gauss (SetPrimitive_Gradient_GG, solver_direct_reactive.cpp
:1086-1165) and weighted least squares (SetPrimitive_Gradient_LS,
:1170-1326).  On static-stencil meshes the WLS normal-equation inverse is
folded into per-offset coefficients at setup, so a gradient is K rolls and
multiply-adds; on other meshes both gather over the edge list and the
padded neighbour table (WLS: the Cholesky-through-R form in 2D, the
normal equations with an adjugate inverse in 3D).  ``q`` is
(nP, nG); results are (nP, nG, d).

From TILED_MIN_NODES nodes up the JAX package runs every gradient sweep
through its tiled kernel, which emits feature-major rows (nG*d, nP); the
port takes the same tier (``use_tiled``): ``gradient_rows`` there, kernel
K7 on the card (ops/gradients_tiled.py), and node-major consumers convert
with ``rows_to_grad``.
"""

from __future__ import annotations

import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays

# the guard of the gather WLS (the JAX package's ops/gradients.EPS)
EPS = 1e-16

GRAD_METHOD_MODE = {
    "GREEN_GAUSS": "GG",
    "WEIGHTED_LEAST_SQUARES": "WLS",
    "LEAST_SQUARES": "WLS",
}

# the tier of the tiled gradient rows and the windowed edge kernel (the JAX
# package's ops/gradients._use_tiled and pallas/edge_fused._edge_win_plan)
TILED_MIN_NODES = 200_000


def use_tiled(mesh: MeshArrays) -> bool:
    """The >= TILED_MIN_NODES tier: gradient rows (K7) and the windowed
    edge kernel (K8) instead of node-major gradients and T3."""
    return mesh.stencil_offsets is not None \
        and mesh.npoint >= TILED_MIN_NODES


def gradient_rows(mesh: MeshArrays, q: torch.Tensor, method: str):
    """(nP, nG) -> (nG*d, nP) feature-major rows, row g*d + dd holding
    d(q_g)/dx_dd (the tier's sweep; K7 on CUDA tensors)."""
    from su2_tpu_torch.ops import gradients_tiled as gt
    return gt.gradient_rows(mesh, q, GRAD_METHOD_MODE.get(method, "WLS"))


def rows_to_grad(rows: torch.Tensor, ng: int, d: int) -> torch.Tensor:
    """(nG*d, nP) rows -> (nP, nG, d) node-major gradient (a view)."""
    return rows.T.reshape(rows.shape[1], ng, d)


def green_gauss(mesh: MeshArrays, q: torch.Tensor) -> torch.Tensor:
    """grad_i = (sum_edges 0.5(q_i+q_j) n_signed - q_i n_bnd,i) / Vol_i."""
    if mesh.gg_snormal is not None:
        acc = None
        for k, o in enumerate(mesh.stencil_offsets):
            avg = 0.5 * (q + torch.roll(q, -o, dims=0))
            part = avg[:, :, None] * mesh.gg_snormal[k][:, None, :]
            acc = part if acc is None else acc + part
    else:
        avg = 0.5 * (q[mesh.edges[:, 0]] + q[mesh.edges[:, 1]])
        acc = mesh.scatter_edges(avg[:, :, None]
                                 * mesh.edge_normal[:, None, :])
    acc = acc - q[:, :, None] * mesh.bnd_accum_normal[:, None, :]
    return acc / mesh.volume[:, None, None]


def weighted_least_squares(mesh: MeshArrays, q: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted LS gradient with the reference's
    singular-matrix guard (gradient 0): per-offset coefficients on stencil
    meshes, else over the padded neighbour table the Cholesky-through-R
    form (2D) or _wls_3d."""
    if mesh.wls_coeff is not None:
        grad = None
        for k, o in enumerate(mesh.stencil_offsets):
            dq = torch.roll(q, -o, dims=0) - q
            part = mesh.wls_coeff[k][:, None, :] * dq[:, :, None]
            grad = part if grad is None else grad + part
        return grad
    if mesh.ndim == 3:
        return _wls_3d(mesh, q)
    dx = mesh.coords[mesh.node_nbrs] - mesh.coords[:, None, :]  # (nP, D, 2)
    w = (dx * dx).sum(-1)
    valid = (w > EPS) & (mesh.nbr_mask > 0.5)
    invw = torch.where(valid, 1.0 / torch.where(valid, w, 1.0), 0.0)
    r11s = (dx[..., 0] * dx[..., 0] * invw).sum(1)
    r12s = (dx[..., 0] * dx[..., 1] * invw).sum(1)
    r22s = (dx[..., 1] * dx[..., 1] * invw).sum(1)
    dq = q[mesh.node_nbrs] - q[:, None, :]                      # (nP, D, nG)
    cx = ((dx[..., 0] * invw)[:, :, None] * dq).sum(1)
    cy = ((dx[..., 1] * invw)[:, :, None] * dq).sum(1)
    r11 = torch.where(r11s > EPS, torch.sqrt(torch.clamp(r11s, min=0.0)),
                      0.0)
    r12 = torch.where(torch.abs(r11) > EPS,
                      r12s / torch.where(r11 == 0, 1.0, r11), 0.0)
    r22sq = r22s - r12 * r12
    r22 = torch.where(r22sq > EPS, torch.sqrt(torch.clamp(r22sq, min=0.0)),
                      0.0)
    det_r2 = (r11 * r22) ** 2
    singular = torch.abs(det_r2) < EPS
    det_safe = torch.where(singular, 1.0, det_r2)
    s00 = torch.where(singular, 0.0, (r12 * r12 + r22 * r22) / det_safe)
    s01 = torch.where(singular, 0.0, -r11 * r12 / det_safe)
    s11 = torch.where(singular, 0.0, r11 * r11 / det_safe)
    gx = cx * s00[:, None] + cy * s01[:, None]
    gy = cx * s01[:, None] + cy * s11[:, None]
    return torch.stack([gx, gy], dim=-1)


def _wls_3d(mesh: MeshArrays, q: torch.Tensor) -> torch.Tensor:
    """3D inverse-distance-weighted LS over the padded neighbour table (the
    JAX package's _wls_3d): the normal equations A g = b, A = sum w dx dx^T
    and b = sum w dx dq with w = 1/|dx|^2, solved by the 3 x 3 adjugate
    inverse; a node whose det(A) is below EPS gets the gradient 0 (the
    reference's singular-matrix guard)."""
    dx = mesh.coords[mesh.node_nbrs] - mesh.coords[:, None, :]  # (nP, D, 3)
    w = (dx * dx).sum(-1)
    valid = (w > EPS) & (mesh.nbr_mask > 0.5)
    invw = torch.where(valid, 1.0 / torch.where(valid, w, 1.0), 0.0)
    # elementwise products summed over the slots (no batched GEMM, whose
    # algorithm a captured graph may pick apart from the eager step)
    wdx = invw[..., None] * dx                                   # (nP, D, 3)
    a = (wdx[..., :, None] * dx[..., None, :]).sum(1)           # (nP, 3, 3)
    dq = q[mesh.node_nbrs] - q[:, None, :]                      # (nP, D, nG)
    b = (wdx[..., :, None] * dq[..., None, :]).sum(1)           # (nP, 3, nG)
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c02 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c10 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c20 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c21 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c10 + a[:, 0, 2] * c20
    singular = torch.abs(det) < EPS
    inv_det = torch.where(singular, 0.0,
                          1.0 / torch.where(singular, 1.0, det))
    ainv = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                        torch.stack([c10, c11, c12], dim=-1),
                        torch.stack([c20, c21, c22], dim=-1)], dim=-2) \
        * inv_det[:, None, None]
    return (ainv[:, None] * b.transpose(1, 2)[:, :, None, :]).sum(-1)
