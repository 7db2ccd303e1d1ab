"""Synthetic structured meshes (as unstructured RawMesh) for tests/dryruns."""

from __future__ import annotations

import numpy as np

from su2_tpu_torch.io.mesh import RawMesh


def channel_mesh(nx: int, ny: int, lx: float = 1.0, ly: float = 0.25) -> RawMesh:
    """(nx x ny)-node quad channel with markers inlet (x=0), outlet (x=lx),
    lower_wall (y=0), upper_wall (y=ly)."""
    xs, ys = np.meshgrid(np.linspace(0, lx, nx), np.linspace(0, ly, ny),
                         indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=1)

    def nid(i, j):
        return i * ny + j

    elems = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            elems.append([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)])
    elems = np.array(elems)

    def line_marker(pairs):
        return np.array(pairs)

    inlet = [[nid(0, j + 1), nid(0, j)] for j in range(ny - 1)]
    outlet = [[nid(nx - 1, j), nid(nx - 1, j + 1)] for j in range(ny - 1)]
    lower = [[nid(i, 0), nid(i + 1, 0)] for i in range(nx - 1)]
    upper = [[nid(i + 1, ny - 1), nid(i, ny - 1)] for i in range(nx - 1)]
    markers = {"inlet": line_marker(inlet), "outlet": line_marker(outlet),
               "lower_wall": line_marker(lower), "upper_wall": line_marker(upper)}
    mtypes = {k: np.full(len(v), 3, dtype=np.int32) for k, v in markers.items()}
    return RawMesh(ndim=2, coords=coords,
                   elem_types=np.full(len(elems), 9, dtype=np.int32),
                   elem_nodes=elems, markers=markers, marker_types=mtypes)


def box_mesh(nx: int, ny: int, nz: int,
             lx: float = 1.0, ly: float = 1.0, lz: float = 1.0) -> RawMesh:
    """(nx x ny x nz)-node hexahedral box with markers inlet (x=0),
    outlet (x=lx), y_min/y_max/z_min/z_max walls.  Hex node ordering follows
    the SU2/VTK convention (bottom quad 0-1-2-3 CCW seen from +z, top 4-7)."""
    xs, ys, zs = np.meshgrid(np.linspace(0, lx, nx), np.linspace(0, ly, ny),
                             np.linspace(0, lz, nz), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1)

    def nid(i, j, k):
        return (i * ny + j) * nz + k

    elems = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                elems.append([
                    nid(i, j, k), nid(i + 1, j, k),
                    nid(i + 1, j + 1, k), nid(i, j + 1, k),
                    nid(i, j, k + 1), nid(i + 1, j, k + 1),
                    nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1)])
    elems = np.array(elems)

    # boundary quads, wound so the outward normal leaves the domain
    inlet, outlet, ymin, ymax, zmin, zmax = [], [], [], [], [], []
    for j in range(ny - 1):
        for k in range(nz - 1):
            inlet.append([nid(0, j, k), nid(0, j, k + 1),
                          nid(0, j + 1, k + 1), nid(0, j + 1, k)])
            outlet.append([nid(nx - 1, j, k), nid(nx - 1, j + 1, k),
                           nid(nx - 1, j + 1, k + 1), nid(nx - 1, j, k + 1)])
    for i in range(nx - 1):
        for k in range(nz - 1):
            ymin.append([nid(i, 0, k), nid(i + 1, 0, k),
                         nid(i + 1, 0, k + 1), nid(i, 0, k + 1)])
            ymax.append([nid(i, ny - 1, k), nid(i, ny - 1, k + 1),
                         nid(i + 1, ny - 1, k + 1), nid(i + 1, ny - 1, k)])
    for i in range(nx - 1):
        for j in range(ny - 1):
            zmin.append([nid(i, j, 0), nid(i, j + 1, 0),
                         nid(i + 1, j + 1, 0), nid(i + 1, j, 0)])
            zmax.append([nid(i, j, nz - 1), nid(i + 1, j, nz - 1),
                         nid(i + 1, j + 1, nz - 1), nid(i, j + 1, nz - 1)])
    markers = {"inlet": np.array(inlet), "outlet": np.array(outlet),
               "y_min": np.array(ymin), "y_max": np.array(ymax),
               "z_min": np.array(zmin), "z_max": np.array(zmax)}
    mtypes = {k: np.full(len(v), 9, dtype=np.int32) for k, v in markers.items()}
    return RawMesh(ndim=3, coords=coords,
                   elem_types=np.full(len(elems), 12, dtype=np.int32),
                   elem_nodes=elems, markers=markers, marker_types=mtypes)


def sector_mesh(nr: int, nt: int, r0: float = 1.0, r1: float = 2.0,
                theta: float = 0.5) -> RawMesh:
    """(nr x nt)-node quad annular sector [r0, r1] x [0, theta] (radians)
    about the origin, with markers inner (r=r0), outer (r=r1),
    side_a (angle 0) and side_b (angle theta)."""
    rs, ts = np.meshgrid(np.linspace(r0, r1, nr), np.linspace(0.0, theta, nt),
                         indexing="ij")
    coords = np.stack([(rs * np.cos(ts)).ravel(),
                       (rs * np.sin(ts)).ravel()], axis=1)

    def nid(i, j):
        return i * nt + j

    elems = []
    for i in range(nr - 1):
        for j in range(nt - 1):
            elems.append([nid(i, j), nid(i + 1, j),
                          nid(i + 1, j + 1), nid(i, j + 1)])
    elems = np.array(elems)
    inner = [[nid(0, j + 1), nid(0, j)] for j in range(nt - 1)]
    outer = [[nid(nr - 1, j), nid(nr - 1, j + 1)] for j in range(nt - 1)]
    side_a = [[nid(i, 0), nid(i + 1, 0)] for i in range(nr - 1)]
    side_b = [[nid(i + 1, nt - 1), nid(i, nt - 1)] for i in range(nr - 1)]
    markers = {"inner": np.array(inner), "outer": np.array(outer),
               "side_a": np.array(side_a), "side_b": np.array(side_b)}
    mtypes = {k: np.full(len(v), 3, dtype=np.int32)
              for k, v in markers.items()}
    return RawMesh(ndim=2, coords=coords,
                   elem_types=np.full(len(elems), 9, dtype=np.int32),
                   elem_nodes=elems, markers=markers, marker_types=mtypes)


def naca_omesh(n_wrap: int = 129, n_rad: int = 81, radius: float = 15.0,
               thickness: float = 0.12, stretch: float = 1.12) -> RawMesh:
    """Algebraic O-mesh around a NACA 00xx airfoil (sharp trailing edge).

    BASELINE.json config 1 fixture (2D inviscid NACA0012, ~10k cells).
    n_wrap points wrap the airfoil (trailing edge duplicated logically —
    the O-grid seam is merged), n_rad points march to a circular far field
    of the given radius with geometric clustering at the wall.  Markers:
    ``airfoil`` (slip wall), ``farfield``.
    """
    nw = n_wrap - 1                       # unique wrap points (seam merged)
    # cosine-clustered chordwise distribution, TE -> lower -> LE -> upper -> TE
    beta = np.linspace(0.0, 2.0 * np.pi, n_wrap)[:-1]
    xc = 0.5 * (1.0 + np.cos(beta))      # 1 -> 0 -> 1
    t = thickness
    yt = 5.0 * t * (0.2969 * np.sqrt(xc) - 0.1260 * xc - 0.3516 * xc ** 2
                    + 0.2843 * xc ** 3 - 0.1036 * xc ** 4)  # closed TE
    side = np.where(beta < np.pi, 1.0, -1.0)               # upper then lower (CCW wrap, domain on the left)
    surf = np.stack([xc, side * yt], axis=1)
    # far-field circle centred at quarter chord, matching wrap parameter
    theta = beta
    far = np.stack([0.25 + radius * np.cos(theta),
                    radius * np.sin(theta)], axis=1)
    # geometric radial clustering
    r = np.zeros(n_rad)
    dr = 1.0
    for j in range(1, n_rad):
        r[j] = r[j - 1] + dr
        dr *= stretch
    r /= r[-1]
    coords = (surf[None, :, :] * (1.0 - r[:, None, None])
              + far[None, :, :] * r[:, None, None])        # (n_rad, nw, 2)
    coords = coords.reshape(-1, 2)

    def nid(j, i):
        return j * nw + (i % nw)

    elems = []
    for j in range(n_rad - 1):
        for i in range(nw):
            elems.append([nid(j, i), nid(j, i + 1),
                          nid(j + 1, i + 1), nid(j + 1, i)])
    elems = np.array(elems)
    airfoil = np.array([[nid(0, i), nid(0, i + 1)] for i in range(nw)])
    farb = np.array([[nid(n_rad - 1, i + 1), nid(n_rad - 1, i)]
                     for i in range(nw)])
    markers = {"airfoil": airfoil, "farfield": farb}
    mtypes = {k: np.full(len(v), 3, dtype=np.int32)
              for k, v in markers.items()}
    return RawMesh(ndim=2, coords=coords,
                   elem_types=np.full(len(elems), 9, dtype=np.int32),
                   elem_nodes=elems, markers=markers, marker_types=mtypes)
