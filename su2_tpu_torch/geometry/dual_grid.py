"""Median-dual control-volume construction.

Rebuilds the geometry pipeline of the reference
(Common/src/geometry_structure.cpp::SetControlVolume at :10457,
CEdge::SetNodes_Coord / GetVolume in Common/src/dual_grid_structure.cpp:425-530,
boundary-vertex normals at geometry_structure.cpp:9645) as vectorized NumPy
host preprocessing.  Output is a struct-of-arrays :class:`DualGrid` whose
members become static-shape device arrays.

Conventions (identical to the reference so residuals can match bitwise-ish):
  * every edge is stored with node_i < node_j; its dual-face normal points
    from i toward j and its magnitude is the dual-face area,
  * 2D edge-normal contribution per adjacent element:
    rot_cw(Elem_CG - Edge_CG) = (dy, -dx), accumulated over both elements,
  * dual volume: triangle/tet areas (P, Edge_CG, Elem_CG) added per endpoint,
  * boundary vertex normal contribution per boundary line element:
    rot_cw((n0 - n1)/2) added to both endpoints (SU2 inward convention;
    BC code negates it for the outward normal).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from su2_tpu_torch.io.mesh import ELEM_FACES, RawMesh


@dataclass
class DualGrid:
    ndim: int
    coords: np.ndarray          # (nPoint, ndim)
    volume: np.ndarray          # (nPoint,)
    edges: np.ndarray           # (nEdge, 2) int32, i < j
    edge_normal: np.ndarray     # (nEdge, ndim) dual-face area normal i->j
    # Node->edge adjacency (gather-based scatter), padded with edge id nEdge:
    node_edges: np.ndarray      # (nPoint, max_deg) int32
    node_edge_sign: np.ndarray  # (nPoint, max_deg) float, +1 if node is i, -1 if j, 0 pad
    node_nbrs: np.ndarray       # (nPoint, max_deg) int32, other endpoint, self-padded
    # Boundary data per marker tag:
    bnd_nodes: dict[str, np.ndarray] = field(default_factory=dict)    # (nV,) int32
    bnd_normal: dict[str, np.ndarray] = field(default_factory=dict)   # (nV, ndim)
    bnd_nn: dict[str, np.ndarray] = field(default_factory=dict)       # (nV,) int32
    # nearest interior neighbor along the wall normal (SU2's Normal_Neighbor,
    # CPhysicalGeometry::FindNormal_Neighbor)

    @property
    def npoint(self) -> int:
        return self.coords.shape[0]

    @property
    def nedge(self) -> int:
        return self.edges.shape[0]

    @property
    def max_degree(self) -> int:
        return self.node_edges.shape[1]


def _collect_faces_2d(mesh: RawMesh):
    """All element edges (2D faces) as (nFaceTotal, 2) node pairs in winding
    order, plus the owning element id for each."""
    faces, owner = [], []
    for t, fl in ELEM_FACES.items():
        if VTK_IS_3D.get(t, False):
            continue
        sel = np.nonzero(mesh.elem_types == t)[0]
        if sel.size == 0:
            continue
        nodes = mesh.elem_nodes[sel]
        for (a, b) in fl:
            faces.append(np.stack([nodes[:, a], nodes[:, b]], axis=1))
            owner.append(sel)
    return np.concatenate(faces, axis=0), np.concatenate(owner, axis=0)


VTK_IS_3D = {10: True, 12: True, 13: True, 14: True, 5: False, 9: False}


def _element_cg(mesh: RawMesh) -> np.ndarray:
    cg = np.zeros((mesh.nelem, mesh.ndim))
    counts = (mesh.elem_nodes >= 0).sum(axis=1)
    safe = np.where(mesh.elem_nodes >= 0, mesh.elem_nodes, 0)
    pts = mesh.coords[safe]                          # (nE, maxN, ndim)
    pts = pts * (mesh.elem_nodes >= 0)[..., None]
    cg = pts.sum(axis=1) / counts[:, None]
    return cg


def _boundary_data(mesh: RawMesh, edges: np.ndarray, node_nbrs: np.ndarray):
    """Boundary vertex normals (geometry_structure.cpp:9645 for 2D) and
    normal neighbors (FindNormal_Neighbor equivalent)."""
    coords = mesh.coords
    npoint = mesh.npoint
    bnd_nodes: dict[str, np.ndarray] = {}
    bnd_normal: dict[str, np.ndarray] = {}
    for tag, melems in mesh.markers.items():
        lines = melems[:, :2]
        # Both endpoints receive rot_cw((n0 - n1)/2); see module docstring.
        acc = np.zeros((npoint, 2))
        d = (coords[lines[:, 0]] - coords[lines[:, 1]]) * 0.5
        rot = np.stack([d[:, 1], -d[:, 0]], axis=1)
        for side in (0, 1):
            np.add.at(acc, lines[:, side], rot)
        nodes = np.unique(lines)
        bnd_nodes[tag] = nodes.astype(np.int64)
        bnd_normal[tag] = acc[nodes]

    bnd_nn: dict[str, np.ndarray] = {}
    for tag in bnd_nodes:
        nodes = bnd_nodes[tag]
        nn = np.empty(len(nodes), dtype=np.int64)
        for k, p in enumerate(nodes):
            nrm = bnd_normal[tag][k]
            best, best_cos = p, -np.inf
            for q in node_nbrs[p]:
                if q == p:
                    continue
                d = coords[q] - coords[p]
                c = (d @ nrm) / (np.linalg.norm(d) + 1e-300)
                if c > best_cos:
                    best_cos, best = c, q
            nn[k] = best
        bnd_nn[tag] = nn
    return bnd_nodes, bnd_normal, bnd_nn


def _try_native(mesh: RawMesh, max_degree: int | None) -> DualGrid | None:
    """Use the C++ geometry core (native/geometry_core.cpp) when built; the
    boundary vertex data stays in Python (small)."""
    from su2_tpu_torch.geometry import native

    out = native.build_dual_2d(mesh.coords, mesh.elem_types, mesh.elem_nodes)
    if out is None:
        return None
    edges, edge_normal, volume = out
    npoint = mesh.npoint
    deg = np.bincount(edges.ravel(), minlength=npoint)
    maxdeg = int(deg.max()) if max_degree is None else max_degree
    adj = native.adjacency(npoint, edges, maxdeg)
    if adj is None:
        return None
    node_edges, node_sign, node_nbrs = adj
    bnd_nodes, bnd_normal, bnd_nn = _boundary_data(
        mesh, edges, node_nbrs)
    return DualGrid(
        ndim=2, coords=mesh.coords, volume=volume, edges=edges,
        edge_normal=edge_normal, node_edges=node_edges,
        node_edge_sign=node_sign, node_nbrs=node_nbrs,
        bnd_nodes=bnd_nodes, bnd_normal=bnd_normal, bnd_nn=bnd_nn)


def _fix_orientation_2d(mesh: RawMesh) -> RawMesh:
    """Reorient elements the way the reference does before building CVs.

    Interior elements are flipped to CCW winding
    (Check_IntElem_Orientation, geometry_structure.cpp:8542); boundary line
    elements are flipped so the domain lies to their left
    (Check_BoundElem_Orientation, :8825 — it tests against a node of the
    owning domain element; the element CG gives the same sign).
    """
    coords = mesh.coords
    elem_nodes = mesh.elem_nodes.copy()
    counts = (elem_nodes >= 0).sum(axis=1)
    # signed polygon area (shoelace) over valid nodes — all 2D elements here
    # are convex tris/quads, so the sign test matches SU2's corner tests
    area = np.zeros(mesh.nelem)
    maxn = elem_nodes.shape[1]
    for k in range(maxn):
        a = elem_nodes[:, k]
        valid = a >= 0
        b = elem_nodes[np.arange(mesh.nelem), np.where(k + 1 < counts, k + 1, 0)]
        contrib = coords[np.where(valid, a, 0), 0] * coords[np.where(valid, b, 0), 1] \
            - coords[np.where(valid, b, 0), 0] * coords[np.where(valid, a, 0), 1]
        area += np.where(valid, contrib, 0.0)
    flip = area < 0.0
    for k in np.nonzero(flip)[0]:
        nn = counts[k]
        elem_nodes[k, :nn] = elem_nodes[k, :nn][::-1]

    # boundary lines: build an edge -> element CG map from the (now CCW)
    # interior elements, then flip lines whose domain sits on the right
    elem_cg_arr = _element_cg(
        RawMesh(mesh.ndim, coords, mesh.elem_types, elem_nodes,
                mesh.markers, mesh.marker_types))
    edge_owner: dict[tuple[int, int], int] = {}
    for k in range(mesh.nelem):
        t = int(mesh.elem_types[k])
        for (a, b) in ELEM_FACES[t]:
            i, j = int(elem_nodes[k, a]), int(elem_nodes[k, b])
            edge_owner[(min(i, j), max(i, j))] = k
    markers = {}
    for tag, melems in mesh.markers.items():
        lines = melems[:, :2].copy()
        for r in range(lines.shape[0]):
            n0, n1 = int(lines[r, 0]), int(lines[r, 1])
            own = edge_owner[(min(n0, n1), max(n0, n1))]
            cg = elem_cg_arr[own]
            a = 0.5 * (coords[n1] - coords[n0])
            b = cg - coords[n0]
            if a[0] * b[1] - a[1] * b[0] < 0.0:
                lines[r] = (n1, n0)
        full = melems.copy()
        full[:, :2] = lines
        markers[tag] = full
    return RawMesh(mesh.ndim, coords, mesh.elem_types, elem_nodes,
                   markers, mesh.marker_types)


def build_dual_grid(mesh: RawMesh, max_degree: int | None = None,
                    use_native: bool = True) -> DualGrid:
    if mesh.ndim == 3:
        return build_dual_grid_3d(mesh, max_degree)
    mesh = _fix_orientation_2d(mesh)
    coords = mesh.coords
    npoint = mesh.npoint

    if use_native:
        native_out = _try_native(mesh, max_degree)
        if native_out is not None:
            return native_out

    faces, owner = _collect_faces_2d(mesh)           # winding order preserved
    elem_cg = _element_cg(mesh)

    # Canonical edge keys (i<j) and unique edge list
    swapped = faces[:, 0] > faces[:, 1]
    canon = np.where(swapped[:, None], faces[:, ::-1], faces)
    keys = canon[:, 0].astype(np.int64) * npoint + canon[:, 1].astype(np.int64)
    uniq_keys, edge_of_face = np.unique(keys, return_inverse=True)
    edges = np.stack([uniq_keys // npoint, uniq_keys % npoint], axis=1).astype(np.int64)
    nedge = edges.shape[0]

    # --- edge dual-face normals (SU2 2D formula) ---
    edge_cg = 0.5 * (coords[edges[:, 0]] + coords[edges[:, 1]])   # (nEdge,2)
    ecg = elem_cg[owner]                                          # per face
    fcg = edge_cg[edge_of_face]
    # no swap: rot_cw(Elem_CG - Edge_CG); swap: rot_cw(Edge_CG - Elem_CG)
    delta = np.where(swapped[:, None], fcg - ecg, ecg - fcg)
    contrib = np.stack([delta[:, 1], -delta[:, 0]], axis=1)
    edge_normal = np.zeros((nedge, 2))
    np.add.at(edge_normal, edge_of_face, contrib)

    # zero-area guard (geometry_structure.cpp:10553): EPS^2 per component
    area = np.linalg.norm(edge_normal, axis=1)
    edge_normal[area == 0.0] = 1e-32

    # --- dual volumes ---
    # triangle (P, Edge_CG, Elem_CG) area for each face endpoint
    volume = np.zeros(npoint)
    for side in (0, 1):
        p = coords[faces[:, side]]
        va = ecg - p
        vb = fcg - p
        tri = 0.5 * np.abs(va[:, 0] * vb[:, 1] - va[:, 1] * vb[:, 0])
        np.add.at(volume, faces[:, side], tri)

    # --- adjacency (gather-based residual scatter) ---
    deg = np.zeros(npoint, dtype=np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    maxdeg = int(deg.max()) if max_degree is None else max_degree
    node_edges = np.full((npoint, maxdeg), nedge, dtype=np.int64)
    node_sign = np.zeros((npoint, maxdeg))
    node_nbrs = np.tile(np.arange(npoint, dtype=np.int64)[:, None], (1, maxdeg))
    # Vectorized slot assignment: for each side, sort incidences by node and
    # compute each one's position within its node group (deterministic,
    # edge-index order within a node).
    slot = np.zeros(npoint, dtype=np.int64)
    for side, sgn in ((0, 1.0), (1, -1.0)):
        n = edges[:, side]
        idx_sort = np.argsort(n, kind="stable")
        n_sorted = n[idx_sort]
        grp_start = np.searchsorted(n_sorted, np.arange(npoint))
        pos_in_grp = np.arange(len(n_sorted)) - grp_start[n_sorted]
        dest_slot = slot[n_sorted] + pos_in_grp
        node_edges[n_sorted, dest_slot] = idx_sort
        node_sign[n_sorted, dest_slot] = sgn
        node_nbrs[n_sorted, dest_slot] = edges[idx_sort, 1 - side]
        np.add.at(slot, n_sorted, 1)

    bnd_nodes, bnd_normal, bnd_nn = _boundary_data(mesh, edges, node_nbrs)

    return DualGrid(
        ndim=2, coords=coords, volume=volume,
        edges=edges.astype(np.int64), edge_normal=edge_normal,
        node_edges=node_edges, node_edge_sign=node_sign, node_nbrs=node_nbrs,
        bnd_nodes=bnd_nodes, bnd_normal=bnd_normal, bnd_nn=bnd_nn,
    )


# --------------------------------------------------------------------------
# 3D median-dual construction
# --------------------------------------------------------------------------

def _adjacency_tables(npoint: int, edges: np.ndarray,
                      max_degree: int | None):
    """Shared slot-assignment logic (same ordering as the 2D path)."""
    nedge = edges.shape[0]
    deg = np.zeros(npoint, dtype=np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    maxdeg = int(deg.max()) if max_degree is None else max_degree
    node_edges = np.full((npoint, maxdeg), nedge, dtype=np.int64)
    node_sign = np.zeros((npoint, maxdeg))
    node_nbrs = np.tile(np.arange(npoint, dtype=np.int64)[:, None], (1, maxdeg))
    slot = np.zeros(npoint, dtype=np.int64)
    for side, sgn in ((0, 1.0), (1, -1.0)):
        n = edges[:, side]
        idx_sort = np.argsort(n, kind="stable")
        n_sorted = n[idx_sort]
        grp_start = np.searchsorted(n_sorted, np.arange(npoint))
        pos_in_grp = np.arange(len(n_sorted)) - grp_start[n_sorted]
        dest_slot = slot[n_sorted] + pos_in_grp
        node_edges[n_sorted, dest_slot] = idx_sort
        node_sign[n_sorted, dest_slot] = sgn
        node_nbrs[n_sorted, dest_slot] = edges[idx_sort, 1 - side]
        np.add.at(slot, n_sorted, 1)
    return node_edges, node_sign, node_nbrs


def build_dual_grid_3d(mesh: RawMesh, max_degree: int | None = None) -> DualGrid:
    """3D median-dual CVs (SetControlVolume 3D branch,
    geometry_structure.cpp:10538; CEdge 3-arg SetNodes_Coord/GetVolume,
    dual_grid_structure.cpp:425-505; boundary vertex normals :9652 with the
    CVertex 3-arg SetNodes_Coord).

    Orientation checks are not yet applied in 3D — meshes must be
    consistently wound (SU2-exported and synthetic meshes are).
    """
    coords = mesh.coords
    npoint = mesh.npoint
    elem_cg = _element_cg(mesh)

    # collect per (type, face, edge-slot) occurrence lists
    occ_i, occ_j, occ_ecg, occ_fcg = [], [], [], []
    for t, faces in ELEM_FACES.items():
        if not VTK_IS_3D.get(t, False):
            continue
        sel = np.nonzero(mesh.elem_types == t)[0]
        if sel.size == 0:
            continue
        nodes = mesh.elem_nodes[sel]
        for face in faces:
            nf = len(face)
            fcg = coords[nodes[:, list(face)]].mean(axis=1)   # (nSel, 3)
            for k in range(nf):
                a = nodes[:, face[k]]
                b = nodes[:, face[(k + 1) % nf]]
                occ_i.append(a)
                occ_j.append(b)
                occ_ecg.append(elem_cg[sel])
                occ_fcg.append(fcg)
    fi = np.concatenate(occ_i)
    fj = np.concatenate(occ_j)
    ecg = np.concatenate(occ_ecg)
    fcg = np.concatenate(occ_fcg)

    swapped = fi > fj
    canon_i = np.where(swapped, fj, fi)
    canon_j = np.where(swapped, fi, fj)
    keys = canon_i.astype(np.int64) * npoint + canon_j.astype(np.int64)
    uniq_keys, edge_of_face = np.unique(keys, return_inverse=True)
    edges = np.stack([uniq_keys // npoint, uniq_keys % npoint], axis=1)
    nedge = edges.shape[0]

    edge_cg = 0.5 * (coords[fi] + coords[fj])
    # normal: 0.5 (Elem-CG1) x (CG2-CG1) with (CG1, CG2) = (edge, face) or
    # swapped when i > j (CEdge::SetNodes_Coord 3-arg semantics)
    cg1 = np.where(swapped[:, None], fcg, edge_cg)
    cg2 = np.where(swapped[:, None], edge_cg, fcg)
    vec_a = ecg - cg1
    vec_b = cg2 - cg1
    contrib = 0.5 * np.cross(vec_a, vec_b)
    edge_normal = np.zeros((nedge, 3))
    np.add.at(edge_normal, edge_of_face, contrib)
    area = np.linalg.norm(edge_normal, axis=1)
    edge_normal[area == 0.0] = 1e-32

    # dual volumes: tet (P, edge CG, face CG, elem CG) per endpoint
    volume = np.zeros(npoint)
    for endp in (fi, fj):
        p = coords[endp]
        a = edge_cg - p
        b = fcg - p
        c = ecg - p
        vol = np.abs(np.einsum("nd,nd->n", c, np.cross(a, b))) / 6.0
        np.add.at(volume, endp, vol)

    node_edges, node_sign, node_nbrs = _adjacency_tables(
        npoint, edges, max_degree)

    # boundary vertex normals (3D branch of the vertex loop)
    from su2_tpu_torch.io.mesh import BOUND_NEIGHBORS
    bnd_nodes: dict[str, np.ndarray] = {}
    bnd_normal: dict[str, np.ndarray] = {}
    acc_all: dict[str, np.ndarray] = {}
    for tag, melems in mesh.markers.items():
        acc = np.zeros((npoint, 3))
        for t, nbr_tab in BOUND_NEIGHBORS.items():
            rows = np.nonzero(mesh.marker_types[tag] == t)[0]
            if rows.size == 0:
                continue
            els = melems[rows]
            nn = 3 if t == 5 else 4
            bcg = coords[els[:, :nn]].mean(axis=1)
            for inode in range(nn):
                v = els[:, inode]
                for islot, nbr in enumerate(nbr_tab[inode]):
                    q = els[:, nbr]
                    ecg_b = 0.5 * (coords[v] + coords[q])
                    if islot == 0:
                        cg1b, cg2b = bcg, ecg_b
                    else:
                        cg1b, cg2b = ecg_b, bcg
                    va = coords[v] - cg1b
                    vb = cg2b - cg1b
                    # negated so the stored normal points INWARD, matching
                    # the 2D path's convention (BC code negates for outward)
                    np.add.at(acc, v, -0.5 * np.cross(va, vb))
        nodes = np.unique(melems[melems >= 0])
        bnd_nodes[tag] = nodes.astype(np.int64)
        bnd_normal[tag] = acc[nodes]

    # normal neighbors
    bnd_nn: dict[str, np.ndarray] = {}
    for tag in bnd_nodes:
        nodes = bnd_nodes[tag]
        nn_arr = np.empty(len(nodes), dtype=np.int64)
        for k, p in enumerate(nodes):
            nrm = bnd_normal[tag][k]
            best, best_cos = p, -np.inf
            for q in node_nbrs[p]:
                if q == p:
                    continue
                d = coords[q] - coords[p]
                cval = (d @ nrm) / (np.linalg.norm(d) + 1e-300)
                if cval > best_cos:
                    best_cos, best = cval, q
            nn_arr[k] = best
        bnd_nn[tag] = nn_arr

    return DualGrid(
        ndim=3, coords=coords, volume=volume, edges=edges,
        edge_normal=edge_normal, node_edges=node_edges,
        node_edge_sign=node_sign, node_nbrs=node_nbrs,
        bnd_nodes=bnd_nodes, bnd_normal=bnd_normal, bnd_nn=bnd_nn)
