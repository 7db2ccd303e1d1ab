"""Solution output: history file, Tecplot/ParaView/FieldView volume files,
surface files and forces_breakdown.dat (COutput equivalent, reference:
SU2_CFD/src/output_structure.cpp and output_{tecplot,paraview,fieldview}
.cpp).  NumPy only: a copy of the JAX package's io/output.py, whose files
it writes byte for byte (tests/test_torch_output.py), except
_volume_fields, which reads the port's tensors.

Species columns are labeled with the mixture's species names, not the
reference's hardcoded 9-species list (output_structure.cpp:10575-10579).
"""

from __future__ import annotations

import time

import numpy as np


HISTORY_HEADER = (
    'TITLE = "SU2 Simulation"\n'
    'VARIABLES = "Iteration","CLift","CDrag","CSideForce","CMx","CMy","CMz",'
    '"CFx","CFy","CFz","CL/CD","HeatFlux_Total","HeatFlux_Maximum",'
    '{res_names},"Linear_Solver_Iterations","CFL_Number","Time(min)"\n'
    'ZONE T= "Convergence history"\n')


class HistoryWriter:
    """Tecplot-style convergence history (SetConvHistory_Body equivalent)."""

    def __init__(self, path: str, nvar_flow: int, nvar_turb: int = 0,
                 cfl: float = 1.0):
        self.path = path
        # the reference prints exactly five flow residual columns
        # (output_structure.cpp:4241) regardless of nVar
        self.nflow = min(nvar_flow, 5)
        self.nturb = nvar_turb
        self.cfl = cfl
        self.t0 = time.time()
        res = [f'"Res_Flow[{k}]"' for k in range(self.nflow)]
        res += [f'"Res_Turb[{k}]"' for k in range(nvar_turb)]
        with open(path, "w") as f:
            f.write(HISTORY_HEADER.format(res_names=",".join(res)))

    def write(self, iteration: int, log_res_flow, log_res_turb=None,
              forces=None, lin_iters: int = 0):
        forces = forces or {}
        cl = forces.get("CL", 0.0)
        cd = forces.get("CD", 0.0)
        vals = [float(iteration), cl, cd, 0.0,
                forces.get("CMx", 0.0), forces.get("CMy", 0.0),
                forces.get("CMz", 0.0),
                forces.get("CFx", 0.0), forces.get("CFy", 0.0),
                forces.get("CFz", 0.0),
                cl / cd if cd != 0 else 0.0,
                forces.get("HF_total", 0.0), forces.get("HF_max", 0.0)]
        vals += [float(x) for x in log_res_flow[:self.nflow]]
        if log_res_turb is not None:
            vals += [float(x) for x in log_res_turb[:self.nturb]]
        vals += [float(lin_iters), self.cfl, (time.time() - self.t0) / 60.0]
        with open(self.path, "a") as f:
            f.write(", ".join(f"{v:.10g}" for v in vals) + "\n")

def _volume_fields(sim, u, v, mu, turb_q=None, mu_t=None):
    """Named output fields (reactive set) as host arrays in the
    Simulation's node order, from the tensors of one node-state pass: the
    clipped conserved state u, the primitives v and the laminar viscosity
    mu (NodeState.mu, which T2 computes on the card); turb_q (k, omega)
    and mu_t where turbulent."""
    lay = sim.lay
    un = u.cpu().numpy()
    vn = v.cpu().numpy()
    fields = {}
    for k in range(lay.nvar):
        fields[f"Conservative_{k+1}"] = un[:, k]
    fields["Pressure"] = vn[:, lay.P]
    fields["Temperature"] = vn[:, lay.T]
    vel = vn[:, lay.VX:lay.VX + lay.ndim]
    fields["Mach"] = np.linalg.norm(vel, axis=1) / vn[:, lay.A]
    for s, name in enumerate(sim.lib.species):
        fields[f"Y_{name}"] = vn[:, lay.YS + s]
    if sim.cfg.viscous:
        fields["Laminar_Viscosity"] = mu.cpu().numpy()
    if turb_q is not None:
        q = turb_q.cpu().numpy()
        fields["Turb_Kin_Energy"] = q[:, 0]
        fields["Omega"] = q[:, 1]
        fields["Eddy_Viscosity"] = mu_t.cpu().numpy()
    return fields


def write_tecplot_volume(path: str, raw_mesh, fields: dict) -> None:
    """ASCII Tecplot FE volume file (output_tecplot.cpp equivalent)."""
    coords = raw_mesh.coords
    n = coords.shape[0]
    names = ['"x"', '"y"'] + [f'"{k}"' for k in fields]
    elems = raw_mesh.elem_nodes
    # triangles written as degenerate quads, like the reference
    with open(path, "w") as f:
        f.write('TITLE = "Visualization of the volume solution"\n')
        f.write("VARIABLES = " + ",".join(names) + "\n")
        f.write(f'ZONE NODES= {n}, ELEMENTS= {elems.shape[0]}, '
                f'DATAPACKING=POINT, ZONETYPE=FEQUADRILATERAL\n')
        cols = [coords[:, 0], coords[:, 1]] + list(fields.values())
        data = np.column_stack(cols)
        for i in range(n):
            f.write("\t".join(f"{x:.6e}" for x in data[i]) + "\n")
        for row, t in zip(elems, raw_mesh.elem_types):
            nn = row[row >= 0] + 1
            if len(nn) == 3:
                nn = np.array([nn[0], nn[1], nn[2], nn[2]])
            f.write("\t".join(str(x) for x in nn) + "\n")


def write_tecplot_binary_volume(path: str, raw_mesh, fields: dict,
                                title: str = "Visualization of the volume "
                                "solution") -> None:
    """Binary Tecplot file, classic TDV112 layout (the capability of
    output_tecplot.cpp's TecIO branch, SetTecplotBinary_DomainSolution,
    written directly — no TecIO in this image).

    2D cells are written as an FEQUADRILATERAL zone (triangles degenerate,
    like the reference's ASCII path); 3D as FEBRICK with the standard
    degenerate-node replication for tet/prism/pyramid.
    """
    import struct

    coords = raw_mesh.coords
    n = coords.shape[0]
    nd = coords.shape[1]
    names = (["x", "y"] + (["z"] if nd == 3 else [])) + list(fields)
    cols = [coords[:, k] for k in range(nd)] + \
        [np.asarray(c, np.float64) for c in fields.values()]
    elems = raw_mesh.elem_nodes
    ne = elems.shape[0]

    def _ints(f, *vals):
        f.write(struct.pack("<" + "i" * len(vals), *vals))

    def _string(f, s):
        # tecplot strings: each char as int32, null-terminated
        f.write(np.asarray([ord(c) for c in s] + [0],
                           np.int32).tobytes())

    # connectivity (zero-based), degenerate padding
    if nd == 2:
        ztype, width = 3, 4                  # FEQUADRILATERAL
    else:
        ztype, width = 5, 8                  # FEBRICK
    conn = np.empty((ne, width), np.int32)
    for k, (row, t) in enumerate(zip(elems, raw_mesh.elem_types)):
        nn = row[row >= 0]
        c = len(nn)
        if nd == 2:
            conn[k] = [nn[0], nn[1], nn[2], nn[2]] if c == 3 else nn[:4]
        else:
            if c == 4:      # tet -> brick
                conn[k] = [nn[0], nn[1], nn[2], nn[2], nn[3], nn[3],
                           nn[3], nn[3]]
            elif c == 5:    # pyramid
                conn[k] = [nn[0], nn[1], nn[2], nn[3], nn[4], nn[4],
                           nn[4], nn[4]]
            elif c == 6:    # prism
                conn[k] = [nn[0], nn[1], nn[2], nn[2], nn[3], nn[4],
                           nn[5], nn[5]]
            else:
                conn[k] = nn[:8]

    with open(path, "wb") as f:
        f.write(b"#!TDV112")
        _ints(f, 1)                          # byte-order magic
        _ints(f, 0)                          # FileType: full
        _string(f, title)
        _ints(f, len(names))
        for nm in names:
            _string(f, nm)
        # --- zone header ---
        f.write(struct.pack("<f", 299.0))
        _string(f, "Zone")
        _ints(f, -1)                         # parent zone
        _ints(f, -2)                         # strand id (static)
        f.write(struct.pack("<d", 0.0))      # solution time
        _ints(f, -1)                         # not used
        _ints(f, ztype)
        _ints(f, 0)                          # var location: all nodal
        _ints(f, 0)                          # raw local face neighbors
        _ints(f, 0)                          # misc face neighbors
        _ints(f, n, ne)
        _ints(f, 0, 0, 0)                    # ICellDim/JCellDim/KCellDim
        _ints(f, 0)                          # no auxiliary data
        f.write(struct.pack("<f", 357.0))    # end of header
        # --- zone data ---
        f.write(struct.pack("<f", 299.0))
        _ints(f, *([2] * len(names)))        # all vars double
        _ints(f, 0)                          # no passive vars
        _ints(f, 0)                          # no var sharing
        _ints(f, -1)                         # no connectivity sharing
        for c in cols:
            f.write(struct.pack("<dd", float(np.min(c)), float(np.max(c))))
        for c in cols:                       # block packing
            f.write(np.asarray(c, "<f8").tobytes())
        f.write(conn.astype("<i4").tobytes())


def write_paraview_volume(path: str, raw_mesh, fields: dict) -> None:
    """Legacy VTK ASCII file (output_paraview.cpp equivalent)."""
    coords = raw_mesh.coords
    n = coords.shape[0]
    elems = raw_mesh.elem_nodes
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("SU2-TPU volume solution\nASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {n} double\n")
        for i in range(n):
            z = coords[i, 2] if coords.shape[1] > 2 else 0.0
            f.write(f"{coords[i,0]:.6e} {coords[i,1]:.6e} {z:.6e}\n")
        counts = (elems >= 0).sum(axis=1)
        total = int((counts + 1).sum())
        f.write(f"CELLS {elems.shape[0]} {total}\n")
        for row, c in zip(elems, counts):
            f.write(str(c) + " " + " ".join(str(x) for x in row[:c]) + "\n")
        f.write(f"CELL_TYPES {elems.shape[0]}\n")
        for t in raw_mesh.elem_types:
            f.write("9\n" if t == 9 else "5\n")
        f.write(f"POINT_DATA {n}\n")
        for name, col in fields.items():
            safe = name.replace(" ", "_")
            f.write(f"SCALARS {safe} double 1\nLOOKUP_TABLE default\n")
            for x in col:
                f.write(f"{x:.6e}\n")


def write_surface_csv(path: str, raw_mesh, fields: dict, marker_nodes,
                      tecplot_header: bool = True) -> None:
    """Surface solution on plotting markers (surface_flow equivalent)."""
    nodes = np.asarray(marker_nodes)
    coords = raw_mesh.coords[nodes]
    names = ['"x"', '"y"'] + [f'"{k}"' for k in fields]
    with open(path, "w") as f:
        if tecplot_header:
            f.write('TITLE = "Visualization of the surface solution"\n')
            f.write("VARIABLES = " + "".join(names) + "\n")
            f.write(f'ZONE NODES= {len(nodes)}, ELEMENTS= 0, '
                    'DATAPACKING=POINT, ZONETYPE=FELINESEG\n')
        cols = [coords[:, 0], coords[:, 1]] + \
            [np.asarray(c)[nodes] for c in fields.values()]
        data = np.column_stack(cols)
        for i in range(len(nodes)):
            f.write("\t".join(f"{x:.6e}" for x in data[i]) + "\n")


def write_fieldview_volume(path: str, raw, fields: dict,
                           ext_iter: int = 0, mach: float = 0.0,
                           aoa: float = 0.0, reynolds: float = 0.0) -> None:
    """FieldView ASCII (.uns) volume writer (SetFieldViewASCII,
    SU2_CFD/src/output_fieldview.cpp:104-420).

    2D meshes are extruded to one layer of prisms/hexes exactly like the
    reference (nodes duplicated at z=0 and z=1; tri -> prism type 3,
    quad -> hex type 2); 3D writes tet(1)/hex(2)/prism(3)/pyramid(4).
    """
    n = raw.npoint
    names = [k for k in fields if k.lower() not in ("x", "y", "z")]
    with open(path, "w") as f:
        f.write("FIELDVIEW 3 0\n")
        f.write("Constants\n")
        f.write(f"{ext_iter}\t{mach}\t{aoa}\t{reynolds}\n")
        f.write("Grids\t1\n")
        f.write("Boundary Table\t1\n")
        f.write("1\t0\t1\tMARKER_PLOTTING\n")
        f.write(f"Variable Names\t{len(names)}\n")
        for nm in names:
            f.write(nm + "\n")
        f.write("Boundary Variable Names\t0\n")

        if raw.ndim == 2:
            f.write(f"Nodes\t{2 * n}\n")
            for z in (0.0, 1.0):
                for p in range(n):
                    f.write(f"{raw.coords[p, 0]:.15e}\t"
                            f"{raw.coords[p, 1]:.15e}\t{z:.1f}\n")
            # boundary faces: extruded marker lines -> quads
            nb = sum(len(m) for m in raw.markers.values())
            f.write(f"Boundary Faces\t{nb}\n")
            for melems in raw.markers.values():
                for row in melems:
                    a, b = int(row[0]) + 1, int(row[1]) + 1
                    f.write(f"1\t4\t{a}\t{b}\t{b + n}\t{a + n}\n")
            f.write("Elements\n")
            for k in range(raw.nelem):
                t = int(raw.elem_types[k])
                nd = raw.elem_nodes[k]
                if t == 5:
                    a, b, c = (int(x) + 1 for x in nd[:3])
                    f.write(f"3\t1\t{a}\t{b}\t{c}\t{a + n}\t{b + n}\t{c + n}\n")
                else:
                    a, b, c, d = (int(x) + 1 for x in nd[:4])
                    f.write(f"2\t1\t{a}\t{b}\t{c}\t{d}\t"
                            f"{a + n}\t{b + n}\t{c + n}\t{d + n}\n")
            f.write(f"Variables\n")
            for nm in names:
                col = np.asarray(fields[nm])
                for _ in range(2):
                    for p in range(n):
                        f.write(f"{col[p]:.15e}\n")
        else:
            f.write(f"Nodes\t{n}\n")
            for p in range(n):
                f.write("\t".join(f"{raw.coords[p, d]:.15e}"
                                  for d in range(3)) + "\n")
            nb = sum(len(m) for m in raw.markers.values())
            f.write(f"Boundary Faces\t{nb}\n")
            for tag, melems in raw.markers.items():
                mtypes = raw.marker_types[tag]
                for k, row in enumerate(melems):
                    nn = 3 if int(mtypes[k]) == 5 else 4
                    nodes = "\t".join(str(int(x) + 1) for x in row[:nn])
                    f.write(f"1\t{nn}\t{nodes}\n")
            f.write("Elements\n")
            fv_type = {10: (1, 4), 12: (2, 8), 13: (3, 6), 14: (4, 5)}
            for k in range(raw.nelem):
                t, nn = fv_type[int(raw.elem_types[k])]
                nodes = "\t".join(str(int(x) + 1)
                                  for x in raw.elem_nodes[k][:nn])
                f.write(f"{t}\t1\t{nodes}\n")
            f.write("Variables\n")
            for nm in names:
                col = np.asarray(fields[nm])
                for p in range(n):
                    f.write(f"{col[p]:.15e}\n")


def write_forces_breakdown(path: str, cfg, forces: dict,
                           freestream: dict | None = None) -> None:
    """forces_breakdown.dat (COutput::SetForces_Breakdown,
    output_structure.cpp): problem definition, free-stream state, then the
    total and per-surface force coefficients decomposed into pressure and
    friction contributions.  Consumes the "splits"/"per_marker" entries of
    solvers/forces.surface_forces."""
    def pct(part, total):
        if total == 0.0:
            return 0
        return int(100.0 * part / total)

    rows = ["CL", "CD", "CL/CD", "CMz", "CFx", "CFy"]
    if freestream and freestream.get("ndim", 2) == 3:
        rows += ["CFz", "CMx", "CMy"]

    def block(f, splits, totals_all=None, label_w=12):
        vals = {k: (p, fr) for k, (p, fr) in splits.items()}
        cl_p, cl_f = vals["CL"]
        cd_p, cd_f = vals["CD"]
        cl, cd = cl_p + cl_f, cd_p + cd_f
        vals["CL/CD"] = ((cl_p / cd if cd else 0.0), (cl_f / cd if cd else 0.0))
        for name in rows:
            p, fr = vals.get(name, (0.0, 0.0))
            tot = p + fr
            lead = f"Total {name}"
            if totals_all is not None:
                share = pct(tot, totals_all.get(name, 0.0))
                lead = f"Total {name:<5s} ({share:5d}%):"
            else:
                lead = f"Total {name}:"
            f.write(f"{lead:<18s} {tot: 12.6g} | "
                    f"Pressure ({pct(p, tot):5d}%): {p: 12.6g} | "
                    f"Friction ({pct(fr, tot):5d}%): {fr: 12.6g} | "
                    f"Momentum (    0%):            0\n")

    splits = forces.get("splits")
    if splits is None:
        return
    totals = {k: p + fr for k, (p, fr) in splits.items()}
    cl, cd = totals.get("CL", 0.0), totals.get("CD", 0.0)
    totals["CL/CD"] = cl / cd if cd else 0.0
    with open(path, "w") as f:
        f.write("-" * 73 + "\n")
        f.write("|  su2_tpu: TPU-native turbulent reactive-flow solver"
                " (SU2-compatible)  |\n")
        f.write("-" * 73 + "\n\n")
        f.write("Problem definition:\n\n")
        if freestream:
            for k, v in freestream.items():
                if k == "ndim":
                    continue
                f.write(f"{k}: {v}\n")
            f.write("\n")
        f.write("\nForces breakdown:\n\n")
        block(f, splits)
        for tag, msp in forces.get("per_marker", {}).items():
            f.write(f"\n\nSurface name: {tag}\n\n")
            block(f, msp, totals_all=totals)
