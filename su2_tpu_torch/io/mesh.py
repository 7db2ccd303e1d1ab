"""Native SU2 ``.su2`` ASCII mesh reader.

Reference format handling: Common/src/geometry_structure.cpp (CPhysicalGeometry
constructor, Read_SU2_Format_* paths).  VTK element type ids:

  3 = line, 5 = triangle, 9 = quadrilateral, 10 = tetrahedron,
  12 = hexahedron, 13 = prism, 14 = pyramid.

The reader is pure NumPy host code; downstream dual-grid construction turns it
into static-shape device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# number of nodes per VTK element type
VTK_NNODES = {3: 2, 5: 3, 9: 4, 10: 4, 12: 8, 13: 6, 14: 5}

# faces (as local node index tuples) of each 2D/3D element type — the exact
# SU2 tables (Common/src/primal_grid_structure.cpp: CTriangle::Faces :192,
# CQuadrilateral :258, CTetrahedron :327, CHexahedron :395, CPrism :478,
# CPyramid :554; triangular faces of prisms/pyramids are de-duplicated here).
ELEM_FACES = {
    5: ((0, 1), (1, 2), (2, 0)),
    9: ((0, 1), (1, 2), (2, 3), (3, 0)),
    10: ((0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)),
    12: ((0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
         (0, 3, 2, 1), (4, 5, 6, 7)),
    13: ((3, 4, 1, 0), (5, 2, 1, 4), (2, 5, 3, 0), (0, 1, 2), (5, 4, 3)),
    14: ((0, 3, 2, 1), (4, 3, 0), (4, 0, 1), (2, 4, 1), (3, 4, 2)),
}

# boundary-face neighbor-node tables (CTriangle/CQuadrilateral
# ::Neighbor_Nodes, primal_grid_structure.cpp:194/:260)
BOUND_NEIGHBORS = {
    5: ((1, 2), (2, 0), (0, 1)),
    9: ((1, 3), (2, 0), (3, 1), (0, 2)),
}


@dataclass
class RawMesh:
    ndim: int
    coords: np.ndarray                       # (nPoint, ndim) float64
    elem_types: np.ndarray                   # (nElem,) int32 VTK ids
    elem_nodes: np.ndarray                   # (nElem, max_nodes) int64, -1 padded
    markers: dict[str, np.ndarray] = field(default_factory=dict)
    # markers[tag] = (nMarkerElem, max_nodes) int64 node ids, -1 padded
    marker_types: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def npoint(self) -> int:
        return self.coords.shape[0]

    @property
    def nelem(self) -> int:
        return self.elem_types.shape[0]


def _read_elem_block(lines: list[str], start: int, count: int):
    """Parse `count` element lines beginning at lines[start]."""
    types = np.empty(count, dtype=np.int32)
    max_nodes = 0
    rows = []
    for k in range(count):
        toks = lines[start + k].split()
        t = int(toks[0])
        nn = VTK_NNODES[t]
        types[k] = t
        nodes = [int(x) for x in toks[1:1 + nn]]
        rows.append(nodes)
        max_nodes = max(max_nodes, nn)
    out = np.full((count, max_nodes), -1, dtype=np.int64)
    for k, nodes in enumerate(rows):
        out[k, :len(nodes)] = nodes
    return types, out, start + count


def read_su2_mesh(path: str) -> RawMesh:
    with open(path) as f:
        raw_lines = f.read().splitlines()
    # drop comments/empties but keep order
    lines = [ln for ln in (l.split("%", 1)[0].strip() for l in raw_lines) if ln]

    ndim = nelem = npoin = None
    elem_types = elem_nodes = coords = None
    markers: dict[str, np.ndarray] = {}
    marker_types: dict[str, np.ndarray] = {}

    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("NDIME"):
            ndim = int(ln.split("=")[1])
            i += 1
        elif ln.startswith("NELEM"):
            nelem = int(ln.split("=")[1])
            elem_types, elem_nodes, i = _read_elem_block(lines, i + 1, nelem)
        elif ln.startswith("NPOIN"):
            # NPOIN may carry two numbers (global/local); first is the count
            npoin = int(ln.split("=")[1].split()[0])
            coords = np.empty((npoin, ndim), dtype=np.float64)
            for k in range(npoin):
                toks = lines[i + 1 + k].split()
                coords[k] = [float(t) for t in toks[:ndim]]
            i += 1 + npoin
        elif ln.startswith("NMARK"):
            nmark = int(ln.split("=")[1])
            i += 1
            for _ in range(nmark):
                assert lines[i].startswith("MARKER_TAG"), lines[i]
                tag = lines[i].split("=")[1].strip()
                assert lines[i + 1].startswith("MARKER_ELEMS")
                cnt = int(lines[i + 1].split("=")[1])
                mtypes, mnodes, i2 = _read_elem_block(lines, i + 2, cnt)
                markers[tag] = mnodes
                marker_types[tag] = mtypes
                i = i2
        else:
            i += 1

    assert ndim is not None and coords is not None and elem_nodes is not None
    return RawMesh(ndim=ndim, coords=coords, elem_types=elem_types,
                   elem_nodes=elem_nodes, markers=markers, marker_types=marker_types)


def write_su2_mesh(mesh: RawMesh, path: str, coords=None) -> None:
    """ASCII .su2 writer (inverse of the reader; SU2_DEF output format)."""
    c = mesh.coords if coords is None else np.asarray(coords)
    with open(path, "w") as f:
        f.write(f"NDIME= {mesh.ndim}\n")
        f.write(f"NELEM= {mesh.nelem}\n")
        for k in range(mesh.nelem):
            t = int(mesh.elem_types[k])
            nn = VTK_NNODES[t]
            nodes = " ".join(str(int(x)) for x in mesh.elem_nodes[k, :nn])
            f.write(f"{t} {nodes} {k}\n")
        f.write(f"NPOIN= {mesh.npoint}\n")
        for k in range(mesh.npoint):
            xyz = " ".join(f"{x:.16e}" for x in c[k])
            f.write(f"{xyz} {k}\n")
        f.write(f"NMARK= {len(mesh.markers)}\n")
        for tag, melems in mesh.markers.items():
            f.write(f"MARKER_TAG= {tag}\n")
            f.write(f"MARKER_ELEMS= {len(melems)}\n")
            mtypes = mesh.marker_types[tag]
            for k in range(len(melems)):
                t = int(mtypes[k])
                nn = VTK_NNODES[t]
                nodes = " ".join(str(int(x)) for x in melems[k, :nn])
                f.write(f"{t} {nodes}\n")
