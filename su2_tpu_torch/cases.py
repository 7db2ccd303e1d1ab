"""Synthetic 9-species / 2-reaction REACTIVE_RANS channel case (NumPy only).

``write_case(directory)`` writes the chemistry library of the case — the
manifest, the mixture, the chemistry and one transport and one thermo
table per species — in the file grammar of io/tables.py, and returns the
cfg text.  The JAX package loads the same files through CONFIG_LIB_FILE.

The data are deterministic and physically plausible, not a fit to any
mechanism:
  * cp(T)/R = a + (b - a) x^2/(1 + x^2), x = T/theta, per species; h and s
    are its exact integrals from 298.15 K, offset by the published
    formation enthalpy and standard entropy;
  * Sutherland mu(T) and an Eucken conductivity kappa = mu (cp + 5/4 R_s);
  * Fuller diffusion volumes and the published molar masses.
Reactions (SI units, concentrations in mol/m^3):
  1. C4H6 + 3.5 O2 => 4 CO + 3 H2O, irreversible, exponents 1.15 / 1.65
     (a fuel order below 1, as in Westbrook-Dryer global steps, makes the
     rate non-Lipschitz at Y_fuel = 0: rounding-level traces of fuel then
     switch on finite rates, and two correct implementations drift apart
     by 1e-5 K within three iterations);
  2. CO + 0.5 O2 <=> CO2, reversible; Keq from the tables or, with
     ``backward_rate=True``, an explicit backward Arrhenius rate.
The streams: pure C4H6 at 600 K and 12 m/s enters a channel filled with
O2 at 1200 K, 12 m/s and 101325 Pa, between two isothermal 600 K walls.
At the 6 m/s of the JAX package's tiny cfg, M_inf = 0.009 and the AUSM+-up
pressure-diffusion term (~1/f_a, f_a ~ 2 M_inf) makes the explicit flow
unstable at CFL 0.1 from about iteration 25 in both packages; cooling the
streams enough to raise M_inf would stop the reaction, so the velocity is
doubled instead.

``species_cut(lib, ns)`` and ``shape_inputs(nd, ns, ...)`` give the edge
kernels' inputs at other (dimension, species count) shapes: the case's
library cut to its first ns species and a random reacting state on it.

``tri_channel_mesh(nx, ny, seed)`` is the channel as a mesh generator
would leave it: every quad split into two triangles, the nodes in a
seeded random order, so no static neighbour stencil exists and both
packages take the gather path; ``tet_box_mesh(nx, ny, nz, seed)`` is the
same for box_mesh's hexes, each split into six tetrahedra
(``with_box_markers`` puts the case on its markers).
"""

from __future__ import annotations

import os

import numpy as np

SPECIES = ("C4H6", "H2O", "O2", "CO", "CO2", "H2", "O", "OH", "H")

# name: (M [g/mol], h_f [kJ/mol], s0 [J/(mol K)], Fuller volume,
#        cp/R low, cp/R high, theta [K], mu_ref [Pa s] at 273.15 K,
#        Sutherland S [K])
_DATA = {
    "C4H6": (54.0904, 110.16, 278.74, 77.46, 8.0, 20.0, 900.0, 7.0e-6, 400.0),
    "H2O": (18.01528, -241.826, 188.83, 13.1, 4.0, 7.0, 1500.0, 9.0e-6, 600.0),
    "O2": (31.9988, 0.0, 205.15, 16.3, 3.5, 4.6, 1200.0, 1.92e-5, 127.0),
    "CO": (28.0101, -110.53, 197.66, 18.0, 3.5, 4.4, 1300.0, 1.66e-5, 118.0),
    "CO2": (44.0095, -393.52, 213.79, 26.9, 4.3, 7.5, 900.0, 1.37e-5, 222.0),
    "H2": (2.01588, 0.0, 130.68, 6.12, 3.45, 4.3, 2000.0, 8.4e-6, 97.0),
    "O": (15.9994, 249.18, 161.06, 5.48, 2.55, 2.5, 1000.0, 1.9e-5, 150.0),
    "OH": (17.0073, 37.3, 183.74, 7.79, 3.5, 4.4, 2000.0, 1.9e-5, 150.0),
    "H": (1.00794, 217.999, 114.72, 2.31, 2.5, 2.5, 1000.0, 7.0e-6, 100.0),
}

R_UNGAS = 6.02214129e23 * 1.3806488e-23 * 1.0e3    # J/(kmol K), io/tables
T_REF = 298.15
T_GRID = np.arange(200.0, 6000.0 + 1e-9, 20.0)

# (A, beta, Ta [K]) per reaction, SI; backward rate of reaction 2
_ARR_1 = (2.0e6, 0.0, 15000.0)
_ARR_2 = (1.0e7, 0.0, 20000.0)
_ARR_2B = (5.0e13, 0.0, 52000.0)


def _cp_over_r(t, a, b, theta):
    x = t / theta
    return a + (b - a) * x * x / (1.0 + x * x)


def _h_integral(t, a, b, theta):
    """int cp/R dT from T_REF to t."""
    def prim(tt):
        x = tt / theta
        return a * tt + (b - a) * theta * (x - np.arctan(x))
    return prim(t) - prim(T_REF)


def _s_integral(t, a, b, theta):
    """int cp/(R T) dT from T_REF to t."""
    def prim(tt):
        x = tt / theta
        return a * np.log(tt) + 0.5 * (b - a) * np.log1p(x * x)
    return prim(t) - prim(T_REF)


def _row(values) -> str:
    """Floats written round-trip exact."""
    return " ".join(repr(float(x)) for x in values)


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nSTOP\n")


# the reactions (equation, its species, Arrhenius rate); the species sets
# of write_library keep the reactions whose species they all hold
_REACTIONS = (("C4H6_1.15 + 3.5O2_1.65 => 4CO + 3H2O",
               {"C4H6", "O2", "CO", "H2O"}, _ARR_1),
              ("CO + 0.5O2 <=> CO2_1", {"CO", "O2", "CO2"}, _ARR_2))
# the 3-species mixture of the case: the CO oxidation of reaction 2 alone
# (a flow of nDim + 5 conserved variables, as the flat plate's 3-species
# air)
SPECIES_3 = ("CO", "O2", "CO2")


def write_library(directory: str, backward_rate: bool = False,
                  species=SPECIES) -> str:
    """Write the library files into `directory`; returns the manifest path.
    species: the mixture, SPECIES or a subset of it (SPECIES_3) that keeps
    the reactions whose species it holds."""
    os.makedirs(directory, exist_ok=True)
    names = ["mixture.txt", "chemistry.txt"]
    mix = [f"{len(species)}"]
    for sp in species:
        mm, hf, _, dv = _DATA[sp][:4]
        mix.append(f"{sp} {_row((mm, hf, dv))}")
    _write(os.path.join(directory, "mixture.txt"), mix)

    kept = [r for r in _REACTIONS if r[1] <= set(species)]
    chem = [f"{len(kept)}", "SI"]
    for eq, _, arr in kept:
        chem += [eq, _row(arr)]
    if backward_rate and _REACTIONS[1] in kept:
        chem.append(f"Available Backward Rate reaction "
                    f"{kept.index(_REACTIONS[1]) + 1}: " + _row(_ARR_2B))
    _write(os.path.join(directory, "chemistry.txt"), chem)

    t = T_GRID
    for sp in species:
        mm, hf, s0, _, a, b, theta, mu_ref, s_mu = _DATA[sp]
        cp = R_UNGAS * _cp_over_r(t, a, b, theta)
        h = hf * 1.0e6 + R_UNGAS * _h_integral(t, a, b, theta)
        s = s0 * 1.0e3 + R_UNGAS * _s_integral(t, a, b, theta)
        mu = mu_ref * (t / 273.15) ** 1.5 * (273.15 + s_mu) / (t + s_mu)
        kappa = mu * (cp / mm + 1.25 * R_UNGAS / mm)
        trans = [sp] + ["  " + _row(r) for r in zip(t, mu, kappa)]
        thermo = [sp] + ["  " + _row(r) for r in zip(t, cp, h, s)]
        tn, hn = f"transport_{sp}.txt", f"thermo_{sp}.txt"
        _write(os.path.join(directory, tn), trans)
        _write(os.path.join(directory, hn), thermo)
        names += [tn, hn]
    manifest = os.path.join(directory, "manifest.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(names) + "\n")
    return manifest


def cfg_text(manifest: str, mesh_file: str | None = None,
             species=SPECIES) -> str:
    """cfg of the case: REACTIVE_NAVIER_STOKES + SST + PaSR, AUSM first
    order, explicit flow, implicit SST by FGMRES + LU_SGS (the multicolor
    block-SGS sweep; JACOBI is the test variant that bypasses it).  The
    fuel stream is the mixture's first species (C4H6, or CO of
    SPECIES_3), the oxidizer O2."""
    pure = lambda sp: ", ".join("1.0" if s == sp else "0.0" for s in species)
    fuel, ox = pure(species[0]), pure("O2")
    mesh = f"MESH_FILENAME= {mesh_file}\n" if mesh_file else ""
    return f"""
CONFIG_LIB_FILE = {manifest}
{mesh}SPECIES_ORDER = ({", ".join(species)})
FREESTREAM_MASS_FRAC = ({ox})
PHYSICAL_PROBLEM= REACTIVE_NAVIER_STOKES
KIND_TURB_MODEL= SST
MACH_NUMBER= 0.02
FREESTREAM_TEMPERATURE= 1200.0
FREESTREAM_VELOCITY= (12.0, 0.0, 0.0)
FREESTREAM_PRESSURE= 101325.0
INLET_TYPE = TEMPERATURE_IMPOSE
MARKER_INLET= ( inlet, 600.0, 12.0, 1.0, 0.0, 0.0 )
INLET_MASS_FRAC = (inlet, {fuel})
MARKER_OUTLET= ( outlet, 101325.0)
MARKER_ISOTHERMAL = (upper_wall, 600.0, lower_wall, 600.0)
NUM_METHOD_GRAD= WEIGHTED_LEAST_SQUARES
CFL_NUMBER= 0.1
CONV_NUM_METHOD_FLOW= AUSM
SPATIAL_ORDER_FLOW= 1ST_ORDER
TIME_DISCRE_FLOW= EULER_EXPLICIT
TIME_DISCRE_TURB= EULER_IMPLICIT
LINEAR_SOLVER= FGMRES
LINEAR_SOLVER_PREC= LU_SGS
PASR_LB = 0.2
"""


def write_case(directory: str, backward_rate: bool = False,
               mesh_file: str | None = None, species=SPECIES) -> str:
    """Write the library of the mixture species into `directory` and
    return the cfg text."""
    return cfg_text(write_library(directory, backward_rate, species),
                    mesh_file, species)


def with_total_conditions(text: str) -> str:
    """The cfg text with a TOTAL_CONDITIONS inlet (SU2's default
    INLET_TYPE): T_tot 600 K and P_tot 101404 Pa, about 0.5 rho v^2 of the
    12 m/s fuel stream (rho ~1.10 kg/m^3) above the outlet's 101325 Pa."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("INLET_TYPE", "MARKER_INLET"))]
    return "\n".join(lines + [
        "INLET_TYPE= TOTAL_CONDITIONS",
        "MARKER_INLET= ( inlet, 600.0, 101404.0, 1.0, 0.0, 0.0 )"]) + "\n"


# CFL of the implicit-flow variant (with_implicit_flow): the 9,072-node
# channel runs 20 iterations at CFL 1 in the port and in su2_tpu with the
# port's form of the effective diffusion (tests/test_torch_pure_streams.py)
IMPLICIT_CFL = 1.0


def with_implicit_flow(text: str, muscl: bool = True,
                       limiter: str | None = "VENKATAKRISHNAN",
                       cfl: float = IMPLICIT_CFL, prec: str = "JACOBI") -> str:
    """The cfg text with implicit flow: TIME_DISCRE_FLOW= EULER_IMPLICIT,
    the flow and SST systems solved by FGMRES with LINEAR_SOLVER_PREC= prec
    (JACOBI, or LU_SGS/ILU0: the multicolor block-SGS sweep, as the
    reference's flat plate), CFL_ADAPT= NO and CFL_NUMBER= cfl;
    SPATIAL_ORDER_FLOW= 2ND_ORDER_LIMITER with SLOPE_LIMITER_FLOW= limiter
    (VENKATAKRISHNAN or BARTH_JESPERSEN), 2ND_ORDER with limiter None,
    1ST_ORDER with muscl False."""
    keys = ("TIME_DISCRE_FLOW", "SPATIAL_ORDER_FLOW", "SLOPE_LIMITER_FLOW",
            "LINEAR_SOLVER_PREC", "CFL_NUMBER", "CFL_ADAPT")
    lines = [ln for ln in text.splitlines() if not ln.startswith(keys)]
    order = ("1ST_ORDER" if not muscl else
             "2ND_ORDER" if limiter is None else "2ND_ORDER_LIMITER")
    lines += ["TIME_DISCRE_FLOW= EULER_IMPLICIT",
              f"SPATIAL_ORDER_FLOW= {order}",
              f"LINEAR_SOLVER_PREC= {prec}",
              f"CFL_NUMBER= {cfl}",
              "CFL_ADAPT= NO"]
    if muscl and limiter is not None:
        lines.append(f"SLOPE_LIMITER_FLOW= {limiter}")
    return "\n".join(lines) + "\n"


def with_laminar(text: str) -> str:
    """The cfg text with laminar flow, KIND_TURB_MODEL= NONE
    (REACTIVE_NAVIER_STOKES without SST and PaSR); combine with
    with_implicit_flow for the implicit variants."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith("KIND_TURB_MODEL")]
    return "\n".join(lines + ["KIND_TURB_MODEL= NONE"]) + "\n"


def tri_channel_mesh(nx: int, ny: int, seed: int = 0):
    """channel_mesh(nx, ny) with each quad split into two triangles along
    alternating diagonals ((i + j) even: (i, j)-(i+1, j+1), odd:
    (i+1, j)-(i, j+1)) and the nodes numbered by
    np.random.default_rng(seed).permutation: node perm[k] becomes node k.
    The markers and coordinates are channel_mesh's.  Returns a RawMesh."""
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io.mesh import RawMesh
    quad = channel_mesh(nx, ny)
    q = quad.elem_nodes
    a, b, c, d = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    i, j = np.divmod(np.arange(q.shape[0]), ny - 1)
    even = ((i + j) % 2 == 0)[:, None]
    first = np.where(even, np.stack([a, b, c], 1), np.stack([a, b, d], 1))
    second = np.where(even, np.stack([a, c, d], 1), np.stack([b, c, d], 1))
    tris = np.stack([first, second], 1).reshape(-1, 3)
    perm = np.random.default_rng(seed).permutation(quad.npoint)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return RawMesh(ndim=2, coords=quad.coords[perm],
                   elem_types=np.full(tris.shape[0], 5, dtype=np.int32),
                   elem_nodes=inv[tris],
                   markers={t: inv[m] for t, m in quad.markers.items()},
                   marker_types=dict(quad.marker_types))


def tet_box_mesh(nx: int, ny: int, nz: int, seed: int = 0):
    """geometry.structured.box_mesh(nx, ny, nz) with each hex split into
    the six tetrahedra (VTK 10) of the path from its lowest to its highest
    corner (one per order of the three axes), wound like box_mesh's hexes;
    every face's diagonal joins its lowest and highest corners, so the
    split is conformal across faces, and the boundary quads are split
    along the same diagonals into triangles (VTK 5) in their winding.
    Nodes numbered by np.random.default_rng(seed).permutation as in
    tri_channel_mesh.  Markers inlet, outlet, y_min, y_max, z_min, z_max.
    Returns a RawMesh."""
    from itertools import permutations
    from su2_tpu_torch.geometry.structured import box_mesh
    from su2_tpu_torch.io.mesh import RawMesh
    box = box_mesh(nx, ny, nz)
    hexes = box.elem_nodes
    # hex corner (di, dj, dk) -> its place in box_mesh's node order
    corner = {(0, 0, 0): 0, (1, 0, 0): 1, (1, 1, 0): 2, (0, 1, 0): 3,
              (0, 0, 1): 4, (1, 0, 1): 5, (1, 1, 1): 6, (0, 1, 1): 7}
    tets = []
    for order in permutations(range(3)):
        path, c = [(0, 0, 0)], [0, 0, 0]
        for ax in order:
            c[ax] = 1
            path.append(tuple(c))
        idx = [corner[x] for x in path]
        # the tet's orientation is the parity of the axis order
        odd = sum(order[a] > order[b] for a in range(3)
                  for b in range(a + 1, 3)) % 2
        if odd:
            idx[1], idx[2] = idx[2], idx[1]
        tets.append(hexes[:, idx])
    tets = np.stack(tets, 1).reshape(-1, 4)
    csum = box.coords.sum(1)
    markers = {}
    for tag, quads in box.markers.items():
        lo = np.argmin(csum[quads], axis=1)
        on_ac = (lo % 2 == 0)[:, None]
        a, b, c, d = quads.T
        first = np.where(on_ac, np.stack([a, b, c], 1), np.stack([a, b, d], 1))
        second = np.where(on_ac, np.stack([a, c, d], 1),
                          np.stack([b, c, d], 1))
        markers[tag] = np.stack([first, second], 1).reshape(-1, 3)
    perm = np.random.default_rng(seed).permutation(box.npoint)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return RawMesh(ndim=3, coords=box.coords[perm],
                   elem_types=np.full(tets.shape[0], 10, dtype=np.int32),
                   elem_nodes=inv[tets],
                   markers={t: inv[m] for t, m in markers.items()},
                   marker_types={t: np.full(m.shape[0], 5, dtype=np.int32)
                                 for t, m in markers.items()})


def with_box_markers(text: str) -> str:
    """The cfg text on tet_box_mesh's (or box_mesh's) markers: the fuel
    inlet and the outlet as in the channel, the isothermal 600 K walls at
    y_min and y_max, symmetry (slip) at z_min and z_max."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("MARKER_ISOTHERMAL", "MARKER_SYM"))]
    return "\n".join(lines + [
        "MARKER_ISOTHERMAL = (y_min, 600.0, y_max, 600.0)",
        "MARKER_SYM = (z_min, z_max)"]) + "\n"


def species_cut(lib, ns: int):
    """The loaded library lib (chemistry.library.load_library) cut to ns
    species: its first ns, or past its count its species again in order
    (copies named name_1, name_2, ..., with the same tables), a mixture of
    another species count for the kernels' shape dispatch.  The reactions
    keep their rates and take the kept species' stoichiometry and
    orders."""
    import dataclasses
    import torch
    idx = torch.arange(ns) % lib.nspecies
    kw = {f.name: getattr(lib, f.name) for f in dataclasses.fields(lib)}
    for k in ("mm", "ri", "diff_vol", "h_form", "cp_y", "cp_y2", "h_y",
              "h_y2", "s_y", "s_y2", "mu_y", "mu_y2", "ka_y", "ka_y2",
              "stoich_r", "stoich_p"):
        kw[k] = kw[k][idx.to(kw[k].device)]
    for k in ("exp_f", "exp_b"):
        kw[k] = kw[k][:, idx.to(kw[k].device)]
    names = [lib.species[i % lib.nspecies]
             + ("" if i < lib.nspecies else f"_{i // lib.nspecies}")
             for i in range(ns)]
    kw.update(nspecies=ns, species=type(lib.species)(names))
    return type(lib)(**kw)


def shape_inputs(nd: int, ns: int, directory: str, dtype=None,
                 device="cpu", raw_mesh=None, seed: int = 8) -> dict:
    """The edge kernels' inputs at the (dimension, species count) shape
    (nd, ns): the case's library cut to ns species (species_cut, up to
    kernels.MAX_SPECIES), on
    raw_mesh (default channel_mesh(9, 7), 63 nodes, or box_mesh(6, 5, 4),
    120 nodes), a random reacting state (numpy seed) through the plain node
    state, random gradients and SST fields.  Returns a dict: mesh, lib,
    lay; explicit, the arguments of T3/K8/K13 before the geometry (lib,
    lay, species consts, consts, stack); implicit, K10's before the
    geometry (with a random limiter); and faces, K11's first-order face
    states of the family slots (v_i, v_j, normal, s_i, s_j, feature-major;
    pad slots with zero normals)."""
    import torch
    from su2_tpu_torch import state as st
    from su2_tpu_torch.chemistry import library as cl
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays
    from su2_tpu_torch.geometry.structured import box_mesh, channel_mesh
    from su2_tpu_torch.ops import edge_flux as ef, edge_implicit as ei
    from su2_tpu_torch.ops import viscous as vis
    dtype = torch.float64 if dtype is None else dtype
    lib = species_cut(cl.load_library(write_library(str(directory)), None,
                                      dtype), ns).to(device)
    if raw_mesh is None:
        raw_mesh = channel_mesh(9, 7) if nd == 2 else box_mesh(6, 5, 4)
    mesh = mesh_arrays(build_dual_grid(raw_mesh), dtype, device)
    lay, n = st.Layout(nd, ns), mesh.npoint
    dev = lambda a: torch.as_tensor(a).to(device, dtype)
    rng = np.random.default_rng(seed)
    t = rng.uniform(500.0, 2500.0, n)
    p = rng.uniform(0.9e5, 1.2e5, n)
    vel = rng.normal(0.0, 20.0, (n, nd))
    ys = rng.dirichlet(np.ones(ns), n)
    h = cl.mixture_enthalpy_plain(lib, dev(t), dev(ys)).cpu().numpy()
    rgas = cl.mixture_rgas(lib, dev(ys)).cpu().numpy()
    rho = p / (rgas * t)
    e = h - rgas * t + 0.5 * (vel * vel).sum(1)
    u = np.concatenate([rho[:, None], rho[:, None] * vel, (rho * e)[:, None],
                        rho[:, None] * ys], axis=1)
    nsd = st.node_state_plain(lib, lay, dev(u), dev(t * 1.01),
                              st.TSolveParams(tmin=200.0, tmax=5000.0))
    scale = np.r_[100.0, [10.0] * nd, 1e3, [1.0] * ns]
    grad = dev(rng.normal(0.0, 1.0, (n, 2 + nd + ns, nd))
               * scale[None, :, None])
    turb = vis.TurbFlowData(tke=dev(rng.uniform(0.0, 5.0, n)),
                            mu_t=dev(rng.uniform(1e-5, 1e-3, n)),
                            grad_tke=dev(rng.normal(0.0, 1.0, (n, nd))),
                            sigma_k=dev(rng.uniform(0.85, 1.0, n)))
    trans = vis.Transport(nsd.mu, nsd.kappa)
    sc = ef.species_consts_of(lib)
    out = dict(mesh=mesh, lib=lib, lay=lay, explicit=(
        lib, lay, sc, (0.1, 0.72, 0.9, 1.0),
        ef.stack_inputs(lay, nsd.v, grad, trans, turb, turb.sigma_k,
                        nsd.dpdu[:, lay.RHOE])))
    lim = dev(rng.uniform(0.0, 1.0, (n, 2 + nd)))
    out["implicit"] = (lib, lay, sc, (0.1, 0.9, 1.0), ei.stack_inputs(
        lay, nsd.v, grad, lim, trans, turb, turb.sigma_k, nsd.dtdu,
        nsd.dpdu))
    vt, st_ = nsd.v.T, nsd.dpdu.T
    out["faces"] = tuple(x.contiguous() for x in (
        mesh.fam_gather_i(vt, -1), mesh.fam_gather_j(vt, -1),
        mesh.fam_normal_flat.T, mesh.fam_gather_i(st_, -1),
        mesh.fam_gather_j(st_, -1)))
    return out
