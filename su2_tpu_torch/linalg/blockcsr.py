"""Block-sparse Jacobian operators on static-stencil meshes (torch).

The off-diagonal blocks live in the stencil lane layout (StencilJacobianT):
row k*v*v + a*v + b, lane p holds entry (a, b) of the block coupling row p
to column p + stencil_offsets[k] (zero where the edge is absent).  This
module carries the JACOBI preconditioner; the multicolor-SGS kernels of
the default LU_SGS are not ported yet (su2_tpu.pallas.stencil_solve).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays


@dataclass(frozen=True)
class StencilJacobianT:
    diag: torch.Tensor     # (nP, v, v)
    sel_t: torch.Tensor    # (K*v*v, nP)


def _bmv(blocks: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched small-block matvec ("...ij,...j->...i")."""
    return (blocks * vecs[..., None, :]).sum(-1)


def block_diag_inv(diag: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (nP, v, v) diagonal blocks (closed-form 2x2
    adjugate, Gauss-Jordan otherwise)."""
    if diag.shape[-1] == 2:
        a, b = diag[:, 0, 0], diag[:, 0, 1]
        c, d = diag[:, 1, 0], diag[:, 1, 1]
        det = a * d - b * c
        det = torch.where(det == 0.0, 1.0, det)
        inv = torch.stack([d, -b, -c, a], dim=-1) / det[:, None]
        return inv.reshape(diag.shape)
    from su2_tpu_torch.linalg.smallsolve import gauss_inv_t
    return gauss_inv_t(diag)


def block_jacobi_apply(dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return _bmv(dinv, r)


def _offdiag_apply(mesh: MeshArrays, sel: torch.Tensor, x: torch.Tensor):
    """sum_k sel[k, p] @ x[p + o_k] for the (K, nP, v, v) stencil form;
    wrapped rolls meet zero padding blocks."""
    out = None
    for k, o in enumerate(mesh.stencil_offsets):
        part = _bmv(sel[k], torch.roll(x, -o, dims=0))
        out = part if out is None else out + part
    return out


def make_solver_ops_stencil_t(mesh: MeshArrays, diag: torch.Tensor,
                              sel_t: torch.Tensor, kind: str = "JACOBI"):
    """(matvec, precond) from lane-layout off-diagonal blocks."""
    if kind != "JACOBI":
        raise NotImplementedError(
            f"LINEAR_SOLVER_PREC= {kind}: not ported (the multicolor SGS "
            "kernels are in su2_tpu.pallas.stencil_solve); use JACOBI")
    dinv = block_diag_inv(diag)
    v = diag.shape[-1]
    n = mesh.npoint
    k = len(mesh.stencil_offsets)
    sel = sel_t.reshape(k, v, v, n).permute(0, 3, 1, 2)
    mv = lambda x: _bmv(diag, x) + _offdiag_apply(mesh, sel, x)
    pc = lambda r: block_jacobi_apply(dinv, r)
    return mv, pc
