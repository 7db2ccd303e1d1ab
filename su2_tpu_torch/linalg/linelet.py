"""Linelet preconditioner (torch): a block Thomas solve along wall-normal
lines, block Jacobi elsewhere.

Port of the JAX package's linalg/linelet.py (CSysMatrix::
BuildLineletPreconditioner / ComputeLineletPreconditioner, reference
Common/src/matrix_structure.cpp:1837-2148).  The lines are built on the
host (NumPy): one per no-slip or slip-wall vertex, grown along the edge of
largest weight area/2 (1/Vol_i + 1/Vol_j) while that edge alone passes
ALPHA times the largest weight.  The lines are padded to one length and
solved together, one step of the Thomas recurrences per line element
(a fixed loop over the padded length: capturable in a CUDA graph).  The
lines' index maps go to the device once (line_maps), so a captured step
copies nothing from the host.  The factorisation (the eliminated diagonal
blocks and their inverses) depends on the system only, so it is formed
once per solve (make_linelet_apply) and each application runs the two
substitutions; the JAX package forms it inside every application, with
the same operations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ALPHA = 0.9
WALL_KINDS = ("isothermal_wall", "heatflux_wall", "euler_wall")


def build_linelets(mesh, bcs=None, wall_kinds=WALL_KINDS):
    """(nL, Lmax) int64 node ids of the lines, padded with -1, or None
    where no wall marker seeds one or no line grows past its seed.  A
    line stops where several unvisited neighbours pass the weight test
    (an isotropic zone) or none does."""
    nbrs = mesh.node_nbrs.cpu().numpy()
    edges = mesh.edges.cpu().numpy()
    area = np.linalg.norm(mesh.edge_normal.cpu().numpy(), axis=1)
    vol = mesh.volume.cpu().numpy()
    n = vol.shape[0]
    edge_of = {}
    for e, (i, j) in enumerate(edges):
        edge_of[(int(i), int(j))] = e
        edge_of[(int(j), int(i))] = e
    seeds = [int(p) for bc in (bcs or ()) if bc.kind in wall_kinds
             for p in bc.nodes.cpu().numpy()]
    if not seeds:
        return None

    def weight(i, j):
        return 0.5 * area[edge_of[(i, j)]] * (1.0 / vol[i] + 1.0 / vol[j])

    unvisited = np.ones(n, dtype=bool)
    unvisited[seeds] = False
    lines = []
    for seed in seeds:
        line = [seed]
        while True:
            p = line[-1]
            cands = [int(q) for q in nbrs[p] if q != p and unvisited[q]]
            if not cands:
                break
            wmax = max(weight(p, q) for q in cands)
            good = [q for q in cands if weight(p, q) / wmax > ALPHA
                    and (len(line) < 2 or q != line[-2])]
            if len(good) != 1:
                break
            line.append(good[0])
            unvisited[good[0]] = False
        lines.append(line)
    lmax = max(len(ln) for ln in lines)
    if lmax < 2:
        return None
    out = np.full((len(lines), lmax), -1, dtype=np.int64)
    for k, ln in enumerate(lines):
        out[k, :len(ln)] = ln
    return out


def block_sel_edges(mesh, lines):
    """(lsel, fsel) (nL, Lmax) int64 into the edge-major blocks
    cat([off_ij, off_ji, zero]) (BlockJacobian): lsel[k, e] names
    block(line[e], line[e-1]), the lower block of step e, fsel[k, e]
    block(line[e-1], line[e]), the upper; element 0 and the padding point
    at the zero block."""
    edges = mesh.edges.cpu().numpy()
    ne = edges.shape[0]
    edge_of = {}
    for e, (i, j) in enumerate(edges):
        edge_of[(int(i), int(j))] = e          # block(i, j) is off_ij[e]
        edge_of[(int(j), int(i))] = e + ne     # block(j, i) is off_ji[e]
    nl, lmax = lines.shape
    lsel = np.full((nl, lmax), 2 * ne, dtype=np.int64)
    fsel = np.full((nl, lmax), 2 * ne, dtype=np.int64)
    for k in range(nl):
        for e in range(1, lmax):
            prev, cur = int(lines[k, e - 1]), int(lines[k, e])
            if cur < 0:
                break
            lsel[k, e] = edge_of[(cur, prev)]
            fsel[k, e] = edge_of[(prev, cur)]
    return lsel, fsel


def block_sel_family(mesh, lines):
    """(lsel, fsel) as block_sel_edges into the family-major blocks
    cat([off_ij, off_ji, zero]) of Kh*nP slots each (slot k*nP + p of
    off_ij is block(p, p + o_k), of off_ji block(p + o_k, p))."""
    offs = {int(o): k for k, o in enumerate(mesh.fam_offsets)}
    n = mesh.npoint
    kh = len(offs)
    pad = 2 * kh * n
    nl, lmax = lines.shape
    lsel = np.full((nl, lmax), pad, dtype=np.int64)
    fsel = np.full((nl, lmax), pad, dtype=np.int64)
    for li in range(nl):
        for e in range(1, lmax):
            prev, cur = int(lines[li, e - 1]), int(lines[li, e])
            if cur < 0:
                break
            d = cur - prev
            if d in offs:               # cur = prev + o
                k = offs[d]
                lsel[li, e] = kh * n + k * n + prev
                fsel[li, e] = k * n + prev
            else:                       # prev = cur + o
                k = offs[-d]
                lsel[li, e] = k * n + cur
                fsel[li, e] = kh * n + k * n + cur
    return lsel, fsel


def _inv_blocks(a):
    """Batched inverse of (B, v, v) blocks: pivot-free Gauss-Jordan on
    [a | I] (the JAX package's gauss_solve(a, I, pivot=False))."""
    v = a.shape[-1]
    eye = torch.eye(v, dtype=a.dtype, device=a.device)
    aug = torch.cat([a, eye.expand(a.shape)], dim=-1)
    not_col = torch.arange(v, device=a.device)[:, None]
    for col in range(v):
        pivval = aug[..., col, col][..., None]
        safe = torch.where(pivval == 0.0, 1.0, pivval)
        prow = aug[..., col, :] / safe
        factors = aug[..., :, col][..., None]
        aug = torch.where(not_col != col, aug - factors * prow[..., None, :],
                          prow[..., None, :].expand(aug.shape))
    return aug[..., :, v:]


def _bmv(blocks, vecs):
    return (blocks * vecs[..., None, :]).sum(-1)


@dataclass(frozen=True)
class LineMaps:
    """The lines (build_linelets' host array) and their index maps on the
    device: node ids (padding read node 0) and the valid mask (nL, Lmax),
    lsel/fsel of block_sel_family (family) or block_sel_edges, and for
    each node whether a line holds it and its (line, element) slot (the
    last line that holds it)."""
    lines: np.ndarray
    family: bool
    node_idx: torch.Tensor
    valid: torch.Tensor
    lsel: torch.Tensor
    fsel: torch.Tensor
    in_line: torch.Tensor
    slot_of: torch.Tensor


def line_maps(mesh, lines, family=True) -> LineMaps:
    """LineMaps of lines on mesh's device (family: the family-major slots
    of a stencil system, else the edge list)."""
    dev = mesh.coords.device
    lsel, fsel = (block_sel_family if family else block_sel_edges)(
        mesh, lines)
    in_line = np.zeros(mesh.npoint, dtype=bool)
    slot_of = np.zeros(mesh.npoint, dtype=np.int64)
    for s, p in enumerate(lines.reshape(-1)):
        if p >= 0:
            in_line[p] = True
            slot_of[p] = s
    t = lambda x: torch.as_tensor(x).to(dev)
    return LineMaps(lines, family, t(np.where(lines < 0, 0, lines)),
                    t(lines >= 0), t(lsel), t(fsel), t(in_line), t(slot_of))


def make_linelet_apply(maps: LineMaps, diag, off_ij, off_ji, dinv):
    """r -> z, the linelet preconditioner of the block system with
    diagonal blocks diag (nP, v, v) and off-diagonal blocks off_ij, off_ji
    in the lane layout (v*v, slots), rows a*v + b: family-major slots
    (blockcsr.FamilyJacobian) for maps of family lines, else edge-major
    ones (BlockJacobian's (nE, v, v) blocks as (v*v, nE)).  dinv (nP, v,
    v): the block Jacobi factor off the lines.  The elimination runs here,
    once: U_0 = D_0, L'_e = L_e U_{e-1}^-1, U_e = D_e - L'_e F_e, with the
    inverses of the U_e; padding slots carry zero L, F blocks and an
    identity D."""
    nl, lmax = maps.lines.shape
    v = diag.shape[-1]
    dev, dt = diag.device, diag.dtype
    node_idx, valid = maps.node_idx, maps.valid
    stacked = torch.cat([off_ij.T, off_ji.T,
                         torch.zeros((1, v * v), dtype=dt, device=dev)])
    lblk = stacked[maps.lsel].reshape(nl, lmax, v, v)
    fblk = stacked[maps.fsel].reshape(nl, lmax, v, v)
    eye = torch.eye(v, dtype=dt, device=dev)
    dblk = torch.where(valid[:, :, None, None], diag[node_idx], eye)
    us = [dblk[:, 0]]
    lbs = [None]
    invs = []
    for e in range(1, lmax):
        inv_u = _inv_blocks(us[-1])
        invs.append(inv_u)
        lb = torch.einsum("kij,kjl->kil", lblk[:, e], inv_u)
        us.append(dblk[:, e] - torch.einsum("kij,kjl->kil", lb, fblk[:, e]))
        lbs.append(lb)
    invs.append(_inv_blocks(us[-1]))
    in_line, slot_of = maps.in_line, maps.slot_of

    def apply(r):
        rl = torch.where(valid[:, :, None], r[node_idx], 0.0)
        ys = [rl[:, 0]]
        for e in range(1, lmax):
            ys.append(rl[:, e] - _bmv(lbs[e], ys[-1]))
        zs = [_bmv(invs[-1], ys[-1])]
        for e in range(lmax - 2, -1, -1):
            zs.append(_bmv(invs[e], ys[e] - _bmv(fblk[:, e + 1], zs[-1])))
        zflat = torch.stack(zs[::-1], dim=1).reshape(nl * lmax, v)
        return torch.where(in_line[:, None], zflat[slot_of], _bmv(dinv, r))

    return apply
