"""CGNS (HDF5 flavor) volume writer — output_cgns.cpp capability.

The reference writes CGNS through libcgns (SU2_CFD/src/output_cgns.cpp);
this image has no libcgns, but CGNS files are plain HDF5 trees with a
documented node convention (the ADF-in-HDF5 mapping): every CGNS node is an
HDF5 group carrying string attributes ``name``/``label``/``type`` and a
`` data`` dataset.  We emit a minimal SIDS-conformant tree:

    CGNSLibraryVersion_t
    Base (CGNSBase_t)
      Zone (Zone_t, Unstructured)
        ZoneType
        GridCoordinates/CoordinateX..Z (DataArray_t, R8)
        Elements (Elements_t, MIXED) + ElementRange + ElementConnectivity
        FlowSolution (FlowSolution_t) + one DataArray_t per field

Readable back with h5py and by CGNS-aware tools that accept the HDF5
flavor.  A copy of the JAX package's io/cgns_out.py (the same tree;
tests/test_torch_output.py compares the two); h5py is imported by the
writer only.
"""

from __future__ import annotations

import numpy as np

# CGNS SIDS element type codes
_BAR_2 = 3
_TRI_3, _QUAD_4 = 5, 7
_TETRA_4, _PYRA_5, _PENTA_6, _HEXA_8 = 10, 12, 14, 17
_MIXED = 20
_NVERT = {3: _TRI_3, 4: _QUAD_4}
_NVERT3 = {4: _TETRA_4, 5: _PYRA_5, 6: _PENTA_6, 8: _HEXA_8}


def _node(parent, name, label, dtype_code, data):
    g = parent.create_group(name)
    g.attrs["name"] = np.bytes_(name.ljust(32, "\x00") + "\x00")
    g.attrs["label"] = np.bytes_(label.ljust(32, "\x00") + "\x00")
    g.attrs["type"] = np.bytes_(dtype_code + "\x00")
    g.attrs["flags"] = np.asarray([1], np.int32)
    if data is not None:
        g.create_dataset(" data", data=data)
    return g


def write_cgns_volume(path: str, raw_mesh, fields: dict) -> None:
    import h5py

    coords = raw_mesh.coords
    n = coords.shape[0]
    nd = coords.shape[1]
    elems = raw_mesh.elem_nodes
    ne = elems.shape[0]

    with h5py.File(path, "w") as f:
        f.attrs["name"] = np.bytes_("HDF5 MotherNode".ljust(32, "\x00")
                                    + "\x00")
        f.attrs["label"] = np.bytes_("Root Node of HDF5 File".ljust(32, "\x00")
                                     + "\x00")
        f.attrs["type"] = np.bytes_("MT\x00")
        f.create_dataset(" format", data=np.frombuffer(
            b"IEEE_LITTLE_32\x00", dtype=np.int8))
        f.create_dataset(" hdf5version", data=np.frombuffer(
            h5py.version.hdf5_version.encode().ljust(33, b"\x00"),
            dtype=np.int8))
        _node(f, "CGNSLibraryVersion", "CGNSLibraryVersion_t", "R4",
              np.asarray([3.30], np.float32))

        base = _node(f, "Base", "CGNSBase_t", "I4",
                     np.asarray([nd, nd], np.int32))
        zone = _node(base, "Zone", "Zone_t", "I4",
                     np.asarray([[n], [ne], [0]], np.int32))
        _node(zone, "ZoneType", "ZoneType_t", "C1",
              np.frombuffer(b"Unstructured", dtype=np.int8))

        gc = _node(zone, "GridCoordinates", "GridCoordinates_t", "MT", None)
        for k, nm in enumerate(["CoordinateX", "CoordinateY",
                                "CoordinateZ"][:nd]):
            _node(gc, nm, "DataArray_t", "R8",
                  np.asarray(coords[:, k], np.float64))

        # MIXED element connectivity: [type, n1..nk] per element, 1-based
        table = _NVERT if nd == 2 else _NVERT3
        conn = []
        for row in elems:
            nn = row[row >= 0]
            conn.append(table[len(nn)])
            conn.extend(int(x) + 1 for x in nn)
        el = _node(zone, "Elements", "Elements_t", "I4",
                   np.asarray([_MIXED, 0], np.int32))
        _node(el, "ElementRange", "IndexRange_t", "I4",
              np.asarray([1, ne], np.int32))
        _node(el, "ElementConnectivity", "DataArray_t", "I4",
              np.asarray(conn, np.int32))

        # one boundary Elements_t section per marker (the convention the
        # reference's CGNS reader maps back to markers)
        btable = {2: _BAR_2, **_NVERT} if nd == 3 else {2: _BAR_2}
        at = ne + 1
        for tag, melems in getattr(raw_mesh, "markers", {}).items():
            bconn = []
            for row in np.asarray(melems):
                nn = row[row >= 0]
                bconn.append(btable[len(nn)])
                bconn.extend(int(x) + 1 for x in nn)
            nb = len(np.asarray(melems))
            bel = _node(zone, tag.replace("/", "_")[:32], "Elements_t",
                        "I4", np.asarray([_MIXED, 0], np.int32))
            _node(bel, "ElementRange", "IndexRange_t", "I4",
                  np.asarray([at, at + nb - 1], np.int32))
            _node(bel, "ElementConnectivity", "DataArray_t", "I4",
                  np.asarray(bconn, np.int32))
            at += nb

        sol = _node(zone, "FlowSolution", "FlowSolution_t", "MT", None)
        _node(sol, "GridLocation", "GridLocation_t", "C1",
              np.frombuffer(b"Vertex", dtype=np.int8))
        for nm, col in fields.items():
            safe = nm.replace(" ", "_")[:32]
            _node(sol, safe, "DataArray_t", "R8",
                  np.asarray(col, np.float64))
