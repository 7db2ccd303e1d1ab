"""Spatial gradients of selected primitive variables (torch).

Green-Gauss (SetPrimitive_Gradient_GG, solver_direct_reactive.cpp
:1086-1165) and weighted least squares (SetPrimitive_Gradient_LS,
:1170-1326) on static-stencil meshes: the WLS normal-equation inverse is
folded into per-offset coefficients at setup, so a gradient is K rolls and
multiply-adds.  ``q`` is (nP, nG); results are (nP, nG, d).

From TILED_MIN_NODES nodes up the JAX package runs every gradient sweep
through its tiled kernel, which emits feature-major rows (nG*d, nP); the
port takes the same tier (``use_tiled``): ``gradient_rows`` there, kernel
K7 on the card (ops/gradients_tiled.py), and node-major consumers convert
with ``rows_to_grad``.
"""

from __future__ import annotations

import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays

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
    acc = None
    for k, o in enumerate(mesh.stencil_offsets):
        avg = 0.5 * (q + torch.roll(q, -o, dims=0))
        part = avg[:, :, None] * mesh.gg_snormal[k][:, None, :]
        acc = part if acc is None else acc + part
    acc = acc - q[:, :, None] * mesh.bnd_accum_normal[:, None, :]
    return acc / mesh.volume[:, None, None]


def weighted_least_squares(mesh: MeshArrays, q: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted LS gradient with the reference's
    singular-matrix guard (gradient 0), as per-offset coefficients."""
    grad = None
    for k, o in enumerate(mesh.stencil_offsets):
        dq = torch.roll(q, -o, dims=0) - q
        part = mesh.wls_coeff[k][:, None, :] * dq[:, :, None]
        grad = part if grad is None else grad + part
    return grad
