"""Block-sparse Jacobian operators (torch).

On static-stencil meshes the off-diagonal blocks live in the stencil lane
layout (StencilJacobianT): row k*v*v + a*v + b, lane p holds entry (a, b)
of the block coupling row p to column p + stencil_offsets[k] (zero where
the edge is absent), and a solve goes to the stencil kernels
(linalg/stencil_solve.py).  On other meshes the blocks are edge-major
(BlockJacobian, the JAX package's form) and the matvec and the multicolor
sweep gather through the padded node-edge table in plain torch ops, as
the JAX package runs them in XLA.  This module also carries the JACOBI
preconditioner, the coloring of the multicolor SGS sweep of the default
LU_SGS (and ILU0, which the reference maps to the same sweep, as it maps
LINELET where no lines are given), and the LINELET operators
(linalg/linelet.py) over the family slots of a stencil system or the
edge list of a BlockJacobian.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from su2_tpu_torch.geometry.mesh_data import MeshArrays
from su2_tpu_torch.linalg import stencil_solve as sts


@dataclass(frozen=True)
class BlockJacobian:
    """Edge-major blocks (meshes without a static stencil): off_ij[e] is
    the row-i / column-j block of the edge e = (i, j), off_ji[e] the
    row-j / column-i block."""
    diag: torch.Tensor     # (nP, v, v)
    off_ij: torch.Tensor   # (nE, v, v)
    off_ji: torch.Tensor   # (nE, v, v)


@dataclass(frozen=True)
class StencilJacobianT:
    diag: torch.Tensor     # (nP, v, v)
    sel_t: torch.Tensor    # (K*v*v, nP)


@dataclass(frozen=True)
class FamilyJacobian:
    """Block Jacobian assembled on the family-major edge slots
    (MeshArrays.fam_gather_*; the laminar implicit step): slot (k, p) is
    the edge (p, p + fam_offsets[k]).  off_ij[:, k*nP + p] is the
    row-p / column-(p + o_k) block, off_ji[:, k*nP + p] the row-(p + o_k) /
    column-p block, both in the lane layout (v*v, Kh*nP), rows a*v + b, as
    kernel K11 emits them; pad slots carry zero blocks.  (The JAX package
    keeps them edge-major, (Kh*nP, v, v).)"""
    diag: torch.Tensor     # (nP, v, v)
    off_ij: torch.Tensor   # (v*v, Kh*nP)
    off_ji: torch.Tensor   # (v*v, Kh*nP)


def family_sel(mesh: MeshArrays, jac: FamilyJacobian) -> torch.Tensor:
    """(K*v*v, nP) stencil lane-layout blocks from family-major ones: offset
    +o_k reads off_ij of family k in place, offset -o_k reads its off_ji
    shifted to the j node (roll by +o_k; the wrapped lanes are zero pad
    blocks), as the JAX package's family_sel; no permute."""
    n = mesh.npoint
    by_off = {}
    for k, o in enumerate(mesh.fam_offsets):
        o = int(o)
        by_off[o] = jac.off_ij[:, k * n:(k + 1) * n]
        by_off[-o] = torch.roll(jac.off_ji[:, k * n:(k + 1) * n], o, dims=1)
    return torch.cat([by_off[int(o)] for o in mesh.stencil_offsets], dim=0)


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


# ---- the gather forms of a BlockJacobian (the JAX package's XLA path) ----

def gather_offdiag(mesh: MeshArrays, jac: BlockJacobian) -> torch.Tensor:
    """The neighbour block of every (node, slot), (nP, D, v, v), once per
    solve; pad slots read a zero block.  (The JAX package gathers them
    slot-major from 16,384 nodes up, for the TPU; on the card the
    node-major form takes fewer launches and less time at 9,072 and
    142,317 nodes: su2_tpu_torch/bench_gather.py.)"""
    pad = torch.zeros((1,) + jac.off_ij.shape[1:], dtype=jac.off_ij.dtype,
                      device=jac.off_ij.device)
    stacked = torch.cat([jac.off_ij, jac.off_ji, pad], dim=0)
    return stacked[mesh.node_edges_sel]


def _offdiag_apply(mesh: MeshArrays, sel: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """sum over slots d of sel[p, d] @ x[nbr(p, d)] for sel of
    gather_offdiag."""
    return _bmv(sel, x[mesh.node_nbrs]).sum(1)


def matvec(mesh: MeshArrays, jac: BlockJacobian, offdiag: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """y = A x, x and y (nP, v); offdiag from gather_offdiag (hoisted out
    of the Krylov loop by the caller)."""
    return _bmv(jac.diag, x) + _offdiag_apply(mesh, offdiag, x)


def multicolor_sgs_apply(mesh: MeshArrays, offdiag: torch.Tensor,
                         dinv: torch.Tensor, colors: torch.Tensor,
                         ncolor: int, r: torch.Tensor) -> torch.Tensor:
    """One symmetric multicolor block-Gauss-Seidel sweep z ~ A^-1 r with
    offdiag from gather_offdiag: the colors forward, then backward without
    the first backward color (same color nodes share no edge, so it would
    repeat the last forward update exactly), each color one masked update
    from the current z."""
    z = torch.zeros_like(r)
    order = list(range(ncolor)) + list(range(ncolor - 2, -1, -1))
    for c in order:
        znew = _bmv(dinv, r - _offdiag_apply(mesh, offdiag, z))
        z = torch.where((colors == c)[:, None], znew, z)
    return z


def greedy_coloring(node_nbrs) -> np.ndarray:
    """Greedy graph coloring on the host (NumPy).  node_nbrs: (nP, D)
    padded with self.  Returns (nP,) int colors: nodes of one color share
    no edge, so each color of the SGS sweep updates in one step."""
    nbrs = np.asarray(node_nbrs)
    n = nbrs.shape[0]
    colors = -np.ones(n, dtype=np.int64)
    for p in range(n):
        used = set(colors[q] for q in nbrs[p] if q != p and colors[q] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[p] = c
    return colors


def sweep_colors(node_nbrs, device) -> tuple[torch.Tensor, int]:
    """(colors, ncolor) of the multicolor sweep: greedy_coloring's colors as
    the (nP,) int8 tensor on `device` that the stencil kernels read."""
    colors = greedy_coloring(node_nbrs)
    ncolor = int(colors.max()) + 1
    if ncolor > 127:
        raise ValueError(f"{ncolor} colors; the sweep takes at most 127")
    return torch.as_tensor(colors.astype(np.int8)).to(device), ncolor


# preconditioners of the reference that this package does not carry, with
# the su2_tpu module that has each
UNPORTED_PREC = {"LU_SGS_SEQ": "su2_tpu.linalg.seq_sgs",
                 "LU_SGS_WAVE": "su2_tpu.linalg.wavefront"}
# the preconditioners that run the multicolor SGS sweep (LINELET where
# the system has no lines)
SGS_KINDS = ("LU_SGS", "ILU0", "LINELET")


def sel_t_to_family(mesh: MeshArrays, sel_t: torch.Tensor, v: int):
    """(off_ij, off_ji) family-major lane-layout blocks (v*v, Kh*nP) of a
    StencilJacobianT's sel_t (the JAX package's sel_t_to_family; the
    inverse of family_sel): family k's off_ij is the block row of offset
    +o_k, its off_ji the block row of -o_k shifted to the i node."""
    vv = v * v
    pos = {int(o): i for i, o in enumerate(mesh.stencil_offsets)}
    blk = lambda o: sel_t[pos[o] * vv:(pos[o] + 1) * vv]
    fam = [int(o) for o in mesh.fam_offsets]
    return (torch.cat([blk(o) for o in fam], dim=1),
            torch.cat([torch.roll(blk(-o), -o, dims=1) for o in fam], dim=1))


def make_solver_ops_stencil_t(mesh: MeshArrays, diag: torch.Tensor,
                              sel_t: torch.Tensor, kind: str = "JACOBI",
                              colors=None, ncolor: int = 0,
                              linear_iter: int = 5, solver: str = "FGMRES"):
    """(matvec, precond, precond_matvec | None, solve | None) from
    lane-layout off-diagonal blocks.

    LU_SGS/ILU0 with colors run the stencil kernels in the reference's
    tiers (stencil_solve.solve_tier), at every block width from 2 to
    kernels.STENCIL_MAX_V (the SST's 2; the flow's nDim + nSpecies + 2, 4
    to 21: compiled at 7, 8, 13 and 14, the run-time-width instance at
    the others).  Where the reference sweeps
    with XLA ops (float64 past its full-precision gate, float32 with no
    mixed tier) the kernels compute the same sweep and matvec at full
    precision; the (z, A z) kernel of the mixed tier stands for the
    reference's resident and windowed mixed kernels and its split of a
    sweep-only kernel plus an XLA matvec.  The whole FGMRES cycle is one
    launch (`solve(b, max_iter, tol)`) where the tier's one-launch
    predicate holds at Krylov budget linear_iter.  solver= "BCGSTAB" (the
    JAX package's bcgstab calls its sweep-only and matvec-only kernels):
    the sweep-only and matvec-only K5 forms, never the one-launch cycle."""
    if kind in UNPORTED_PREC:
        raise NotImplementedError(
            f"LINEAR_SOLVER_PREC= {kind}: not ported; "
            f"{UNPORTED_PREC[kind]} has it")
    dinv = block_diag_inv(diag)
    v = diag.shape[-1]
    offsets = tuple(int(o) for o in mesh.stencil_offsets)
    if kind not in SGS_KINDS or colors is None:
        mv = lambda x: _bmv(diag, x) + sts.offdiag_plain(sel_t, x, offsets,
                                                         v)
        return mv, (lambda r: block_jacobi_apply(dinv, r)), None, None
    sel_dtype, one = sts.solve_tier(mesh.npoint, offsets, v, diag.dtype,
                                    ncolor, linear_iter)
    one = one and solver != "BCGSTAB"
    ops = sts.StencilSolveOps(mesh, sel_t, dinv, diag, colors, ncolor,
                              sel_dtype=sel_dtype, one_launch=one)
    return ops.matvec, ops.precond, ops.precond_matvec, \
        (ops.fgmres if one else None)


def make_solver_ops_fam(mesh: MeshArrays, jac: FamilyJacobian,
                        kind: str = "JACOBI", colors=None, ncolor: int = 0,
                        linear_iter: int = 5, solver: str = "FGMRES"):
    """make_solver_ops_stencil_t of a FamilyJacobian (the JAX package's
    make_solver_ops_fam): the same tiers (stencil_solve.solve_tier), K5/K6
    on the lane-layout blocks of family_sel."""
    return make_solver_ops_stencil_t(mesh, jac.diag, family_sel(mesh, jac),
                                     kind, colors, ncolor, linear_iter,
                                     solver)


def make_linelet_ops(mesh: MeshArrays, jac, lines, colors, ncolor):
    """(matvec, precond, None, None) of LINEAR_SOLVER_PREC= LINELET with
    lines (linelet.line_maps): on a stencil system (StencilJacobianT or
    FamilyJacobian; the JAX package converts the former with
    sel_t_to_family; lines of the family slots) the linelet
    preconditioner, and the matvec through StencilSolveOps (K5's
    matvec-only form on the card) on the lane-layout blocks of
    family_sel; on a BlockJacobian (lines of the edge list, the JAX
    package's family=False) the linelet preconditioner over the
    edge-major blocks and the gather matvec in torch ops."""
    from su2_tpu_torch.linalg import linelet
    v = jac.diag.shape[-1]
    edge_list = isinstance(jac, BlockJacobian)
    if lines.family == edge_list:
        raise ValueError("make_linelet_ops: the lines index the family "
                         "slots of a stencil system, or the edge list of "
                         "a BlockJacobian (line_maps family=)")
    if edge_list:
        ne, vv = jac.off_ij.shape[0], v * v
        dinv = block_diag_inv(jac.diag)
        pc = linelet.make_linelet_apply(
            lines, jac.diag, jac.off_ij.reshape(ne, vv).T,
            jac.off_ji.reshape(ne, vv).T, dinv)
        sel = gather_offdiag(mesh, jac)
        return (lambda x: matvec(mesh, jac, sel, x)), pc, None, None
    if isinstance(jac, StencilJacobianT):
        oij, oji = sel_t_to_family(mesh, jac.sel_t, v)
        jac = FamilyJacobian(diag=jac.diag, off_ij=oij, off_ji=oji)
    dinv = block_diag_inv(jac.diag)
    pc = linelet.make_linelet_apply(lines, jac.diag, jac.off_ij,
                                    jac.off_ji, dinv)
    ops = sts.StencilSolveOps(mesh, family_sel(mesh, jac), dinv, jac.diag,
                              colors, ncolor)
    return ops.matvec, pc, None, None


def make_solver_ops(mesh: MeshArrays, jac, kind: str = "JACOBI",
                    colors=None, ncolor: int = 0, linear_iter: int = 5,
                    lines=None, solver: str = "FGMRES"):
    """(matvec, precond, precond_matvec | None, solve | None) of an
    implicit system: a StencilJacobianT (the RANS step), a FamilyJacobian
    (the laminar step) or, on a mesh without a static stencil, a
    BlockJacobian (the JAX package's gather tail: the neighbour blocks
    gathered once, the matvec and the multicolor sweep, or JACOBI, in
    torch ops; no kernel).  LINELET with lines (linelet.line_maps, of the
    family slots or of the edge list): make_linelet_ops; without (the
    SST's system, a mesh without walls) the multicolor sweep.
    solver: the LINEAR_SOLVER the operators serve (BCGSTAB: no one-launch
    cycle)."""
    if kind == "LINELET" and lines is not None:
        return make_linelet_ops(mesh, jac, lines, colors, ncolor)
    if isinstance(jac, FamilyJacobian):
        return make_solver_ops_fam(mesh, jac, kind, colors, ncolor,
                                   linear_iter, solver)
    if isinstance(jac, BlockJacobian):
        if kind in UNPORTED_PREC:
            raise NotImplementedError(
                f"LINEAR_SOLVER_PREC= {kind}: not ported; "
                f"{UNPORTED_PREC[kind]} has it")
        dinv = block_diag_inv(jac.diag)
        sel = gather_offdiag(mesh, jac)
        mv = lambda x: matvec(mesh, jac, sel, x)
        if kind in SGS_KINDS and colors is not None:
            pc = lambda r: multicolor_sgs_apply(mesh, sel, dinv, colors,
                                                ncolor, r)
        else:
            pc = lambda r: block_jacobi_apply(dinv, r)
        return mv, pc, None, None
    return make_solver_ops_stencil_t(mesh, jac.diag, jac.sel_t, kind,
                                     colors, ncolor, linear_iter, solver)
