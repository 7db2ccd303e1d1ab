"""Static mesh tensors (struct-of-arrays) built from the host DualGrid.

Torch port of the JAX package's mesh arrays.  Edge->node accumulation is
gather-based: each node stores its padded incident-edge list and signs, so a
residual scatter is a deterministic gather + sum with no atomics, the
slots summed in slot order.  On static-stencil meshes (every neighbour at
one of K fixed index offsets) the gradient and edge sweeps use rolls
against per-offset geometry instead; on other meshes (triangles, nodes in
any order) every stencil and family field is None and they gather.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from su2_tpu_torch.geometry.dual_grid import DualGrid

_INT_FIELDS = ("edges", "node_edges", "n_neighbors", "node_edges_t",
               "stencil_sel", "node_nbrs", "node_edges_sel")
_FLOAT_FIELDS = ("coords", "volume", "edge_normal", "edge_area", "node_sign",
                 "bnd_accum_normal", "node_sign_t", "wls_coeff", "gg_snormal",
                 "stencil_pvec", "fam_normal", "fam_evec", "visc_w2",
                 "nbr_mask")


@dataclass(frozen=True)
class MeshArrays:
    ndim: int
    npoint: int
    nedge: int
    max_degree: int
    coords: torch.Tensor        # (nP, d)
    volume: torch.Tensor        # (nP,)
    edges: torch.Tensor         # (nE, 2) int64
    edge_normal: torch.Tensor   # (nE, d)
    edge_area: torch.Tensor     # (nE,)
    node_edges: torch.Tensor    # (nP, D) int64, pad = nE
    node_sign: torch.Tensor     # (nP, D)
    n_neighbors: torch.Tensor   # (nP,) int64
    bnd_accum_normal: torch.Tensor  # (nP, d) sum of marker vertex normals
    markers: dict               # tag -> (nodes (nV,) int64, normal (nV, d))
    marker_nn: dict             # tag -> (nV,) int64 normal-neighbour ids
    marker_dense: dict          # tag -> (normal (nP, d), area (nP,)) zero-padded
    node_edges_t: torch.Tensor = None   # (D*nP,) slot-major node_edges
    node_sign_t: torch.Tensor = None    # (D*nP,)
    node_nbrs: torch.Tensor = None      # (nP, D) int64, pad = self
    nbr_mask: torch.Tensor = None       # (nP, D) 1.0 for real neighbours
    # (nP, D) index into cat([off_ij, off_ji, pad]): sign > 0 -> edge id,
    # sign < 0 -> edge id + nE, pad -> 2 nE (linalg/blockcsr.gather_offdiag)
    node_edges_sel: torch.Tensor = None
    # static-stencil form (geometry/stencil.py)
    stencil_sel: torch.Tensor = None    # (K, nP)
    stencil_offsets: tuple = None       # K signed offsets
    wls_coeff: torch.Tensor = None      # (K, nP, d) WLS coefficients
    gg_snormal: torch.Tensor = None     # (K, nP, d) signed dual normals
    stencil_pvec: torch.Tensor = None   # (K, nP) (dx . n)/|dx|^2
    # positive-offset family geometry for the fused edge kernel
    fam_normal: torch.Tensor = None     # (Kh, nP, d)
    fam_evec: torch.Tensor = None       # (Kh, nP, d)
    fam_offsets: tuple = None           # Kh positive offsets
    visc_w2: torch.Tensor = None        # (nP,) summed marker area^2

    def to(self, device=None, dtype=None) -> "MeshArrays":
        """Copy with float fields in `dtype` and every tensor on `device`."""
        def conv(x, is_float):
            if x is None:
                return None
            return x.to(device=device, dtype=dtype if is_float else None)
        upd = {k: conv(getattr(self, k), False) for k in _INT_FIELDS}
        upd.update({k: conv(getattr(self, k), True) for k in _FLOAT_FIELDS})
        upd["markers"] = {t: (conv(a, False), conv(b, True))
                          for t, (a, b) in self.markers.items()}
        upd["marker_nn"] = {t: conv(a, False)
                            for t, a in self.marker_nn.items()}
        upd["marker_dense"] = {t: (conv(a, True), conv(b, True))
                               for t, (a, b) in self.marker_dense.items()}
        return dataclasses.replace(self, **upd)

    # ---- the family-major virtual edge set (stencil meshes) ----
    # Kh*nP slots, family k's slot p is the edge (p, p + fam_offsets[k]);
    # absent edges are pad slots with a zero fam_normal.  The endpoint
    # gathers are tiles and rolls and the scatters roll-subtracts, without
    # atomics: the parts are added in family order, as the JAX package's
    # MeshArrays.fam_* do.  dim: the slot axis (0 node-major, -1 for
    # feature-major arrays whose lanes are the slots).

    @property
    def fam_normal_flat(self) -> torch.Tensor:
        """(Kh*nP, d) area normals of the family slots."""
        return self.fam_normal.reshape(len(self.fam_offsets) * self.npoint,
                                       -1)

    @property
    def fam_valid_flat(self) -> torch.Tensor:
        """(Kh*nP,) True where the slot is an edge."""
        return (self.fam_normal_flat != 0.0).any(dim=-1)

    def fam_gather_i(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return torch.cat([x] * len(self.fam_offsets), dim=dim)

    def fam_gather_j(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return torch.cat([torch.roll(x, -int(o), dims=dim)
                          for o in self.fam_offsets], dim=dim)

    def _fam_parts(self, ev: torch.Tensor, dim: int):
        return list(torch.split(ev, self.npoint, dim=dim))

    def fam_scatter(self, ev: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """out[i] += ev, out[j] -= ev over the family slots (pad slots must
        already be zero: the wrapped rolls then add nothing)."""
        parts = self._fam_parts(ev, dim)
        neg = [torch.roll(p, int(o), dims=dim)
               for p, o in zip(parts, self.fam_offsets)]
        return sum(parts[1:], parts[0]) - sum(neg[1:], neg[0])

    def fam_accum(self, val_i: torch.Tensor, val_j: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
        """out[i] += val_i, out[j] += val_j over the family slots."""
        pi = self._fam_parts(val_i, dim)
        pj = [torch.roll(p, int(o), dims=dim)
              for p, o in zip(self._fam_parts(val_j, dim), self.fam_offsets)]
        return sum(pi[1:], pi[0]) + sum(pj[1:], pj[0])

    # ---- edge -> node sums (any mesh) ----
    # Each gathers the edge values of every node's slots (slot-major, pad
    # slots read a zero row) and sums the slots in slot order, as the JAX
    # package's MeshArrays do: no index_add_, no atomics.

    def _gather_slots(self, edge_vals: torch.Tensor) -> torch.Tensor:
        """(D*nP, ...) edge values of the slots, pad slots zero."""
        pad = torch.zeros((1,) + edge_vals.shape[1:], dtype=edge_vals.dtype,
                          device=edge_vals.device)
        return torch.cat([edge_vals, pad], dim=0)[self.node_edges_t]

    def _slot_sum(self, g: torch.Tensor) -> torch.Tensor:
        n = self.npoint
        out = g[0:n]
        for d in range(1, self.max_degree):
            out = out + g[d * n:(d + 1) * n]
        return out

    @staticmethod
    def _col(x: torch.Tensor, ndim: int) -> torch.Tensor:
        return x.reshape(x.shape + (1,) * (ndim - 1))

    def scatter_edges(self, edge_vals: torch.Tensor) -> torch.Tensor:
        """out[i] = sum_e sign(i, e) * edge_vals[e]: gather + slot sum, no
        atomics, fixed summation order."""
        return self._slot_sum(self._gather_slots(edge_vals)
                              * self._col(self.node_sign_t, edge_vals.ndim))

    def accumulate_sides(self, val_i: torch.Tensor,
                         val_j: torch.Tensor) -> torch.Tensor:
        """out[p] = sum over p's edges of val_i[e] where p is the edge's
        i-node and val_j[e] where it is the j-node."""
        sign = self._col(self.node_sign_t, val_i.ndim)
        ei = self._gather_slots(val_i)
        ej = self._gather_slots(val_j)
        return self._slot_sum(torch.where(
            sign > 0.5, ei, torch.where(sign < -0.5, ej,
                                        torch.zeros_like(ei))))

    def scatter_edges_mixed(self, signed_vals: torch.Tensor,
                            abs_vals: torch.Tensor):
        """One gather + slot sum of a signed block (nE, k), summed as
        scatter_edges, and an unsigned block (nE, m), summed as
        sum_edges_abs.  Returns ((nP, k), (nP, m))."""
        k = signed_vals.shape[1]
        g = self._gather_slots(torch.cat([signed_vals, abs_vals], dim=1))
        sign = self.node_sign_t[:, None]
        mult = torch.cat([sign.expand(-1, k),
                          sign.abs().expand(-1, g.shape[1] - k)], dim=1)
        tot = self._slot_sum(g * mult)
        return tot[:, :k], tot[:, k:]

    def sum_edges_abs(self, edge_vals: torch.Tensor) -> torch.Tensor:
        """out[i] = sum over i's edges of edge_vals (no sign)."""
        return self._slot_sum(self._gather_slots(edge_vals) * self._col(
            self.node_sign_t.abs(), edge_vals.ndim))


def _stencil_grad_geometry(offsets, edges, coords, npoint, ndim):
    """Host precompute of the per-offset WLS gradient coefficients
    ((K, nP, d) float64), the reference's Cholesky-through-R guards
    included (SetPrimitive_Gradient_LS, solver_direct_reactive.cpp
    :1170-1326)."""
    k = len(offsets)
    d = ndim
    exists = np.zeros((k, npoint), dtype=bool)
    ei, ej = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    diff = ej - ei
    for ki, o in enumerate(offsets):
        if o > 0:
            exists[ki, ei[diff == o]] = True
        else:
            exists[ki, ej[diff == -o]] = True

    dx = np.zeros((k, npoint, d))
    for ki, o in enumerate(offsets):
        rolled = np.roll(coords, -o, axis=0)
        dx[ki] = np.where(exists[ki][:, None], rolled - coords, 0.0)

    w = (dx * dx).sum(axis=-1)
    valid = exists & (w > 1e-16)
    invw = np.where(valid, 1.0 / np.where(valid, w, 1.0), 0.0)
    a = np.einsum("kp,kpi,kpj->pij", invw, dx, dx)
    if d == 2:
        r11s, r12s, r22s = a[:, 0, 0], a[:, 0, 1], a[:, 1, 1]
        r11 = np.where(r11s > 1e-16, np.sqrt(np.maximum(r11s, 0.0)), 0.0)
        r12 = np.where(np.abs(r11) > 1e-16,
                       r12s / np.where(r11 == 0, 1.0, r11), 0.0)
        r22sq = r22s - r12 * r12
        r22 = np.where(r22sq > 1e-16, np.sqrt(np.maximum(r22sq, 0.0)), 0.0)
        det2 = (r11 * r22) ** 2
        sing = np.abs(det2) < 1e-16
        dets = np.where(sing, 1.0, det2)
        s = np.zeros((npoint, 2, 2))
        s[:, 0, 0] = np.where(sing, 0.0, (r12 * r12 + r22 * r22) / dets)
        s[:, 0, 1] = s[:, 1, 0] = np.where(sing, 0.0, -r11 * r12 / dets)
        s[:, 1, 1] = np.where(sing, 0.0, r11 * r11 / dets)
    else:
        det = np.linalg.det(a)
        sing = np.abs(det) < 1e-16
        a_safe = np.where(sing[:, None, None], np.eye(d)[None], a)
        s = np.where(sing[:, None, None], 0.0, np.linalg.inv(a_safe))
    return np.einsum("pij,kpj->kpi", s, invw[:, :, None] * dx)


def _stencil_gg_snormal(offsets, edges, edge_normal, npoint, ndim):
    """(K, nP, d) signed edge normal of the (p, p+o_k) edge (0 if absent)."""
    snormal = np.zeros((len(offsets), npoint, ndim))
    ei, ej = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    diff = ej - ei
    for ki, o in enumerate(offsets):
        if o > 0:
            sel = diff == o
            snormal[ki, ei[sel]] = edge_normal[sel]
        else:
            sel = diff == -o
            snormal[ki, ej[sel]] = -edge_normal[sel]
    return snormal


def mesh_arrays(grid: DualGrid, dtype=torch.float64,
                device="cpu") -> MeshArrays:
    """MeshArrays of a DualGrid: the gather fields always, and on a
    static-stencil mesh (at most MAX_OFFSETS neighbour offsets) the stencil
    and family fields (the gradients, edge families and the SST sweep are
    then rolls); elsewhere those are None and the sweeps gather."""
    from su2_tpu_torch.geometry import stencil as stn

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64)).to(device=device)

    n = grid.npoint
    offsets = stn.edge_offsets(grid.edges)
    stencil = {}
    if 0 < len(offsets) <= stn.MAX_OFFSETS:
        stencil = _stencil_fields(grid, tuple(int(o) for o in offsets), f, i)

    bnd_accum = np.zeros_like(grid.coords)
    dense = {}
    w2 = np.zeros((n,), np.float64)
    for tag in grid.bnd_nodes:
        nodes, nm = grid.bnd_nodes[tag], grid.bnd_normal[tag]
        np.add.at(bnd_accum, nodes, nm)
        ndn = np.zeros((n, nm.shape[1]))
        ndn[nodes] = nm
        ad = np.zeros((n,))
        ad[nodes] = np.linalg.norm(nm, axis=1)
        dense[tag] = (f(ndn), f(ad))
        np.add.at(w2, nodes, np.sum(nm.astype(np.float64) ** 2, axis=1))

    ne = grid.nedge
    sign = grid.node_edge_sign
    # each slot's index into cat([off_ij, off_ji, pad]) by its sign
    sel = np.where(sign > 0.5, grid.node_edges,
                   np.where(sign < -0.5, grid.node_edges + ne, 2 * ne))
    return MeshArrays(
        ndim=grid.ndim, npoint=n, nedge=ne, max_degree=grid.max_degree,
        coords=f(grid.coords), volume=f(grid.volume),
        edges=i(grid.edges), edge_normal=f(grid.edge_normal),
        edge_area=f(np.linalg.norm(grid.edge_normal, axis=1)),
        node_edges=i(grid.node_edges), node_sign=f(sign),
        n_neighbors=i((grid.node_edges < ne).sum(axis=1)),
        bnd_accum_normal=f(bnd_accum),
        markers={t: (i(grid.bnd_nodes[t]), f(grid.bnd_normal[t]))
                 for t in grid.bnd_nodes},
        marker_nn={t: i(grid.bnd_nn[t]) for t in grid.bnd_nn},
        marker_dense=dense,
        node_edges_t=i(grid.node_edges.T.reshape(-1)),
        node_sign_t=f(sign.T.reshape(-1)),
        node_nbrs=i(grid.node_nbrs),
        nbr_mask=f((grid.node_edges < ne).astype(np.float64)),
        node_edges_sel=i(sel),
        visc_w2=f(w2), **stencil)


def _stencil_fields(grid: DualGrid, stencil_offsets, f, i) -> dict:
    """The stencil and family fields of MeshArrays for a static-stencil
    grid with these signed offsets."""
    from su2_tpu_torch.geometry import stencil as stn
    e_np = np.asarray(grid.edges).astype(np.int64)
    coords_np = np.asarray(grid.coords)
    wls = _stencil_grad_geometry(stencil_offsets, e_np, coords_np,
                                 grid.npoint, grid.ndim)
    sn = _stencil_gg_snormal(stencil_offsets, e_np,
                             np.asarray(grid.edge_normal), grid.npoint,
                             grid.ndim)
    pvec = np.zeros((len(stencil_offsets), grid.npoint))
    for ki, o in enumerate(stencil_offsets):
        dxk = np.roll(coords_np, -o, axis=0) - coords_np
        d2 = (dxk * dxk).sum(axis=1)
        pvec[ki] = (dxk * sn[ki]).sum(axis=1) / np.where(d2 == 0, 1, d2)
    pos = tuple(o for o in stencil_offsets if o > 0)
    fnorm = np.zeros((len(pos), grid.npoint, grid.ndim))
    fevec = np.zeros((len(pos), grid.npoint, grid.ndim))
    diff_e = e_np[:, 1] - e_np[:, 0]
    en_np = np.asarray(grid.edge_normal)
    for ki, o in enumerate(pos):
        sel_e = diff_e == o
        own = e_np[sel_e, 0]
        fnorm[ki, own] = en_np[sel_e]
        fevec[ki, own] = coords_np[e_np[sel_e, 1]] - coords_np[own]
    return dict(
        stencil_sel=i(stn.stencil_select(grid.edges, grid.npoint,
                                         stencil_offsets)),
        stencil_offsets=stencil_offsets, wls_coeff=f(wls),
        gg_snormal=f(sn), stencil_pvec=f(pvec), fam_normal=f(fnorm),
        fam_evec=f(fevec), fam_offsets=pos)
