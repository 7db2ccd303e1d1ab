"""Slope limiters of the MUSCL reconstruction (torch).

Venkatakrishnan and Barth-Jespersen (SetPrimitive_Limiter,
solver_direct_reactive.cpp:1328-1527): per node, the neighbour min/max
deltas and the minimum of the per-half-edge limiter values, one roll per
stencil offset on static-stencil meshes, else gathers over the padded
node-neighbour and node-edge tables (the explicit MUSCL step on meshes
without a stencil).  Only minima and maxima are taken, which are
independent of order, so the result does not depend on how the neighbours
are visited; nothing is scattered.
"""

from __future__ import annotations

import torch

EPS = 1e-16


def _valid(mesh, k):
    """(nP, 1) bool: the node has a neighbour at stencil offset k."""
    return (mesh.stencil_sel[k] != 2 * mesh.edges.shape[0])[:, None]


def _neighbor_minmax(mesh, q):
    """Solution_Min/Max per node: extrema of (q_nbr - q_i) over the
    neighbours, bounded by -/+EPS like the reference (:1348-1350)."""
    if mesh.stencil_sel is None:
        dq = q[mesh.node_nbrs] - q[:, None, :]
        real = (mesh.nbr_mask > 0.5)[:, :, None]
        qmax = torch.where(real, dq, -float("inf")).amax(1)
        qmin = torch.where(real, dq, float("inf")).amin(1)
        return torch.clamp(qmin, max=EPS), torch.clamp(qmax, min=-EPS)
    inf = torch.full_like(q, float("inf"))
    qmax, qmin = -inf, inf
    for k, o in enumerate(mesh.stencil_offsets):
        valid = _valid(mesh, k)
        dq = torch.roll(q, -int(o), dims=0) - q
        qmax = torch.maximum(qmax, torch.where(valid, dq, -inf))
        qmin = torch.minimum(qmin, torch.where(valid, dq, inf))
    return torch.clamp(qmin, max=EPS), torch.clamp(qmax, min=-EPS)


def _half_dot(mesh, o, grad):
    """(nP, nG): the gradient projected on the half edge toward p + o."""
    half = 0.5 * (torch.roll(mesh.coords, -int(o), dims=0) - mesh.coords)
    return (half[:, None, :] * grad).sum(-1)


def _edge_sides_min(mesh, grad, side_val, init: float):
    """Edge-list form of the per-half-edge minimum: side_val(dm, node ids)
    of each edge side, dm the gradient projected on the half edge from
    that side, reduced per node over its node-edge slots with init."""
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    half = 0.5 * (mesh.coords[j] - mesh.coords[i])
    vi = side_val((half[:, None, :] * grad[i]).sum(-1), i)
    vj = side_val(((-half)[:, None, :] * grad[j]).sum(-1), j)
    pad = torch.full((1, vi.shape[1]), float("inf"), dtype=vi.dtype,
                     device=vi.device)
    ext_i = torch.cat([vi, pad])[mesh.node_edges]
    ext_j = torch.cat([vj, pad])[mesh.node_edges]
    sign = mesh.node_sign[:, :, None]
    sel = torch.where(sign > 0.5, ext_i,
                      torch.where(sign < -0.5, ext_j, float("inf")))
    return torch.clamp(sel.amin(1), max=init)


def venkatakrishnan(mesh, q, grad, limiter_coeff: float,
                    ref_elem_length: float):
    """(nP, nG) Venkatakrishnan limiter (:1444-1522), eps2 = (K dave)^3
    with dave = REF_ELEM_LENGTH and K = LIMITER_COEFF."""
    qmin, qmax = _neighbor_minmax(mesh, q)
    eps2 = (limiter_coeff * ref_elem_length) ** 3
    venkat = lambda dm, dp: (dp * dp + 2.0 * dp * dm + eps2) \
        / (dp * dp + dp * dm + 2.0 * dm * dm + eps2)
    if mesh.stencil_sel is None:
        return _edge_sides_min(mesh, grad, lambda dm, nd: venkat(
            dm, torch.where(dm > 0.0, qmax[nd], qmin[nd])), 2.0)
    lim = torch.full_like(q, 2.0)
    for k, o in enumerate(mesh.stencil_offsets):
        dm = _half_dot(mesh, o, grad)
        val = venkat(dm, torch.where(dm > 0.0, qmax, qmin))
        lim = torch.minimum(lim, torch.where(_valid(mesh, k), val,
                                             float("inf")))
    return lim


def barth_jespersen(mesh, q, grad):
    """(nP, nG) Barth-Jespersen with the Venkatakrishnan smoothing
    y -> (y^2 + 2y)/(y^2 + y + 2) (:1384-1441)."""
    qmin, qmax = _neighbor_minmax(mesh, q)
    bj = lambda dm, dp: torch.where(dm < EPS, 2.0,
                                    dp / torch.where(dm == 0.0, 1.0, dm))
    if mesh.stencil_sel is None:
        y = _edge_sides_min(mesh, grad, lambda dm, nd: bj(
            dm, torch.where(dm > EPS, qmax[nd], qmin[nd])), 2.0)
        return (y * y + 2.0 * y) / (y * y + y + 2.0)
    y = torch.full_like(q, 2.0)
    for k, o in enumerate(mesh.stencil_offsets):
        dm = _half_dot(mesh, o, grad)
        val = bj(dm, torch.where(dm > EPS, qmax, qmin))
        y = torch.minimum(y, torch.where(_valid(mesh, k), val, float("inf")))
    return (y * y + 2.0 * y) / (y * y + y + 2.0)
