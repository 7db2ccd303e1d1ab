"""SU2-format ASCII restart files (read/write).

Format (COutput::SetRestart, output_structure.cpp:3858-):
  header line of quoted tab-separated names, then one line per point:
  PointID  x  y [z]  Conservative_1..nVar  [k omega]  extra-vis columns

The flow loader (CReactiveEulerSolver::Load_Restart,
solver_direct_reactive.cpp:566) reads the conservative block; the SST loader
(solver_direct_turbulent.cpp:2839-2855) skips the flow block and reads
(k, omega).  Extra visualization columns are ignored on read.  A copy of
the JAX package's io/restart.py (NumPy only).
"""

from __future__ import annotations

import numpy as np


def write_restart(path: str, coords: np.ndarray, u: np.ndarray,
                  turb: np.ndarray | None = None,
                  extras: dict[str, np.ndarray] | None = None) -> None:
    n, ndim = coords.shape
    nvar = u.shape[1]
    names = ["PointID"] + ["x", "y", "z"][:ndim] + \
        [f"Conservative_{k+1}" for k in range(nvar)]
    cols = [coords[:, d] for d in range(ndim)] + \
        [u[:, k] for k in range(nvar)]
    if turb is not None:
        names += [f"Conservative_{nvar+k+1}" for k in range(turb.shape[1])]
        cols += [turb[:, k] for k in range(turb.shape[1])]
    if extras:
        for name, col in extras.items():
            names.append(name)
            cols.append(col)
    with open(path, "w") as f:
        f.write("\t".join(f'"{nm}"' for nm in names) + "\n")
        data = np.column_stack(cols)
        for i in range(n):
            f.write(str(i) + "\t"
                    + "\t".join(f"{x:.15g}" for x in data[i]) + "\n")
        # metadata block (Read_SU2_Restart_Metadata compatibility)
        f.write("AOA= 0.0\nSIDESLIP_ANGLE= 0.0\n")


def read_restart(path: str, ndim: int, nvar: int, nturb: int = 0):
    """Returns (u (N, nvar), turb (N, nturb) or None).

    Trailing metadata lines (AOA=, EXT_ITER=, ... —
    Read_SU2_Restart_Metadata) are skipped.
    """
    with open(path) as f:
        header = f.readline()
        rows = []
        for ln in f:
            toks = ln.split()
            if not toks or not toks[0].lstrip("-").isdigit():
                continue
            rows.append(toks)
    data = np.array([[float(tok) for tok in row] for row in rows])
    ids = data[:, 0].astype(np.int64)
    order = np.argsort(ids)
    data = data[order]
    u = data[:, 1 + ndim:1 + ndim + nvar]
    turb = None
    if nturb:
        turb = data[:, 1 + ndim + nvar:1 + ndim + nvar + nturb]
    return u, turb
