"""CGNS (HDF5 flavor) unstructured-mesh reader — MESH_FORMAT= CGNS.

The reference reads CGNS meshes through libcgns
(Common/src/geometry_structure.cpp, Read_CGNS_Format_* paths): volume
Elements_t sections become the element list, and every section of
boundary-dimension elements becomes one marker named after the section.
This reader implements the same convention directly on the documented
ADF-in-HDF5 node mapping (every CGNS node is an HDF5 group with ``label``
/``type`` attributes and a `` data`` dataset), so no libcgns is needed.

Handles both MIXED sections (inline element-type codes, optional CGNS-4
ElementStartOffset) and uniform-type sections (fixed node stride).
Round-trips the files written by io/cgns_out.py.  A copy of the JAX
package's io/cgns_mesh.py (tests/test_torch_output.py reads one file with
both); h5py is imported by the readers only.
"""

from __future__ import annotations

import numpy as np

from .mesh import RawMesh, VTK_NNODES

# CGNS SIDS ElementType_t codes -> (VTK id, nnodes); NODE/higher-order
# types the solver does not support are rejected explicitly.
_CGNS2VTK = {
    3: (3, 2),    # BAR_2
    5: (5, 3),    # TRI_3
    7: (9, 4),    # QUAD_4
    10: (10, 4),  # TETRA_4
    12: (14, 5),  # PYRA_5
    14: (13, 6),  # PENTA_6
    17: (12, 8),  # HEXA_8
}
_MIXED = 20

# dimensionality of each VTK element type (for volume/boundary split)
_VTK_DIM = {3: 1, 5: 2, 9: 2, 10: 3, 12: 3, 13: 3, 14: 3}


def _label(g) -> str:
    lb = g.attrs.get("label", b"")
    if isinstance(lb, bytes):
        lb = lb.decode("ascii", "ignore")
    return lb.rstrip("\x00").strip()


def _children(g, label: str):
    import h5py
    out = []
    for k in g:
        c = g[k]
        if isinstance(c, h5py.Group) and _label(c) == label:
            out.append((k.rstrip("\x00").strip(), c))
    return out


def _data(g):
    return np.asarray(g[" data"]) if " data" in g else None


def _parse_section(sec):
    """Elements_t group -> (types (n,) VTK ids, nodes (n, maxn) 0-based)."""
    meta = _data(sec)
    etype = int(meta[0])
    conn = None
    for name, c in _children(sec, "DataArray_t"):
        if name == "ElementConnectivity":
            conn = _data(c).astype(np.int64).ravel()
    if conn is None:
        raise ValueError(f"CGNS section without ElementConnectivity")
    if etype == _MIXED:
        types, rows = [], []
        i = 0
        while i < conn.size:
            code = int(conn[i])
            if code not in _CGNS2VTK:
                raise ValueError(f"unsupported CGNS element type {code}")
            vtk, nn = _CGNS2VTK[code]
            types.append(vtk)
            rows.append(conn[i + 1:i + 1 + nn] - 1)
            i += 1 + nn
        maxn = max(len(r) for r in rows)
        nodes = np.full((len(rows), maxn), -1, dtype=np.int64)
        for k, r in enumerate(rows):
            nodes[k, :len(r)] = r
        return np.asarray(types, np.int32), nodes
    if etype not in _CGNS2VTK:
        raise ValueError(f"unsupported CGNS element type {etype}")
    vtk, nn = _CGNS2VTK[etype]
    nodes = conn.reshape(-1, nn) - 1
    return np.full(nodes.shape[0], vtk, np.int32), nodes


def read_cgns_mesh(path: str) -> RawMesh:
    import h5py

    with h5py.File(path, "r") as f:
        bases = _children(f, "CGNSBase_t")
        if not bases:
            raise ValueError(f"{path}: no CGNSBase_t node")
        bname, base = bases[0]
        bmeta = _data(base)
        cell_dim = int(bmeta[0])

        zones = _children(base, "Zone_t")
        if not zones:
            raise ValueError(f"{path}: no Zone_t node")
        zname, zone = zones[0]
        for name, zt in _children(zone, "ZoneType_t"):
            ztype = bytes(_data(zt)).decode("ascii", "ignore")
            if "Unstructured" not in ztype:
                raise ValueError(f"{path}: only Unstructured zones supported")

        gcs = _children(zone, "GridCoordinates_t")
        if not gcs:
            raise ValueError(f"{path}: no GridCoordinates_t node")
        _, gc = gcs[0]
        cols = {}
        for name, c in _children(gc, "DataArray_t"):
            cols[name] = _data(c).astype(np.float64).ravel()
        axes = [cols[k] for k in ("CoordinateX", "CoordinateY", "CoordinateZ")
                if k in cols]
        # a 2D mesh may still carry an all-zero CoordinateZ plane
        if cell_dim == 2 and len(axes) == 3 and not np.any(axes[2]):
            axes = axes[:2]
        coords = np.stack(axes[:max(cell_dim, 2)], axis=1)

        vol_types, vol_nodes = [], []
        markers, marker_types = {}, {}
        for name, sec in _children(zone, "Elements_t"):
            types, nodes = _parse_section(sec)
            dims = np.asarray([_VTK_DIM[t] for t in types])
            if np.all(dims == cell_dim):
                vol_types.append(types)
                vol_nodes.append(nodes)
            elif np.all(dims == cell_dim - 1):
                markers[name] = nodes
                marker_types[name] = types
            else:
                # mixed-dimension section: split it (SU2 treats each
                # element by its own dimension)
                mv = dims == cell_dim
                if mv.any():
                    vol_types.append(types[mv])
                    vol_nodes.append(nodes[mv])
                if (~mv).any():
                    markers[name] = nodes[~mv]
                    marker_types[name] = types[~mv]

        if not vol_types:
            raise ValueError(f"{path}: no volume element section")
        maxn = max(a.shape[1] for a in vol_nodes)
        etypes = np.concatenate(vol_types)
        enodes = np.full((etypes.shape[0], maxn), -1, dtype=np.int64)
        at = 0
        for a in vol_nodes:
            enodes[at:at + a.shape[0], :a.shape[1]] = a
            at += a.shape[0]

    return RawMesh(ndim=cell_dim, coords=coords, elem_types=etypes,
                   elem_nodes=enodes, markers=markers,
                   marker_types=marker_types)


def read_mesh(path: str, mesh_format: str = "SU2") -> RawMesh:
    """Dispatch on MESH_FORMAT (CConfig Mesh_FileFormat)."""
    from .mesh import read_su2_mesh

    if mesh_format.upper() == "CGNS":
        return read_cgns_mesh(path)
    return read_su2_mesh(path)
