"""Spatial gradients of selected primitive variables (torch).

Green-Gauss (SetPrimitive_Gradient_GG, solver_direct_reactive.cpp
:1086-1165) and weighted least squares (SetPrimitive_Gradient_LS,
:1170-1326) on static-stencil meshes: the WLS normal-equation inverse is
folded into per-offset coefficients at setup, so a gradient is K rolls and
multiply-adds.  ``q`` is (nP, nG); results are (nP, nG, d).
"""

from __future__ import annotations

import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays

GRAD_METHOD_MODE = {
    "GREEN_GAUSS": "GG",
    "WEIGHTED_LEAST_SQUARES": "WLS",
    "LEAST_SQUARES": "WLS",
}


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
