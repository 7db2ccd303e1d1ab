"""Shared helpers of the su2_tpu_torch tests: the only module that touches
both packages.  Data cross between them as numpy arrays.  JAX is imported
only inside the helpers that build su2_tpu objects, so the card tests
(test_torch_cuda.py) run where JAX is not installed."""

import os

import numpy as np
import torch

from su2_tpu_torch import cases
from su2_tpu_torch.chemistry.library import _TABLE_FIELDS

META = ("t0", "dt", "nt", "nspecies", "nreactions", "species")
CHANNEL = (17, 9)        # 153 nodes


def write_case(directory, backward_rate=False, mesh_file=None):
    """The synthetic 9-species case in `directory`; returns the cfg text."""
    os.makedirs(directory, exist_ok=True)
    return cases.write_case(str(directory), backward_rate=backward_rate,
                            mesh_file=mesh_file)


def case_variant(text, name):
    """The case, or a variant: "slip_heatflux_mass_flow" (a slip lower
    wall, a heat-flux upper wall and a MASS_FLOW inlet, fuel at 1.1
    kg/m^3); "total_conditions" (a TOTAL_CONDITIONS inlet at 600 K with
    P_tot about 0.5 rho v^2 of the 12 m/s fuel stream above the outlet's
    101325 Pa); "shared_corners" (the lower wall a second outlet, so its
    two end nodes sit in two weak flux markers each)."""
    if name == "isothermal":
        return text
    if name == "total_conditions":
        return cases.with_total_conditions(text)
    if name == "shared_corners":
        lines = [ln for ln in text.splitlines()
                 if not ln.startswith(("MARKER_ISOTHERMAL", "MARKER_OUTLET"))]
        return "\n".join(lines + [
            "MARKER_ISOTHERMAL = (upper_wall, 600.0)",
            "MARKER_OUTLET= ( outlet, 101325.0, lower_wall, 101325.0)"])
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("MARKER_ISOTHERMAL", "INLET_TYPE",
                                   "MARKER_INLET"))]
    return "\n".join(lines + [
        "MARKER_HEATFLUX = (upper_wall, 2500.0)",
        "MARKER_EULER = (lower_wall)",
        "INLET_TYPE = MASS_FLOW",
        "MARKER_INLET= ( inlet, 1.1, 12.0, 1.0, 0.0, 0.0 )"])


def jax_sim(text, shape=CHANNEL):
    import jax.numpy as jnp
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation
    from su2_tpu.geometry.structured import channel_mesh
    return Simulation(Config(text=text), dtype=jnp.float64,
                      raw_mesh=channel_mesh(*shape))


def torch_sim(text, shape=CHANNEL):
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    return Simulation(Config(text=text), raw_mesh=channel_mesh(*shape),
                      dtype=torch.float64, device="cpu")


def jax_raw(raw):
    """The port's RawMesh raw as a copy in su2_tpu's RawMesh."""
    from su2_tpu.io.mesh import RawMesh
    return RawMesh(ndim=raw.ndim, coords=raw.coords.copy(),
                   elem_types=raw.elem_types.copy(),
                   elem_nodes=raw.elem_nodes.copy(),
                   markers={t: m.copy() for t, m in raw.markers.items()},
                   marker_types={t: m.copy()
                                 for t, m in raw.marker_types.items()})


def tri_meshes(shape=CHANNEL, seed=0):
    """(JAX RawMesh, port RawMesh) of cases.tri_channel_mesh(*shape, seed):
    the channel split into triangles, nodes in a seeded random order."""
    raw = cases.tri_channel_mesh(*shape, seed=seed)
    return jax_raw(raw), raw


def force_scale(sim):
    """The scale of the port Simulation sim's force coefficients over
    MARKER_MONITORING: the coefficient of the freestream pressure on every
    monitored vertex (the markers' summed |normal|, times the largest
    moment arm over the reference length where above 1).  A coefficient
    differences pressures of ~1e5 Pa down to O(1), so a state's atol
    ATOL_FRAC*max|p| carries over to it as ATOL_FRAC times this scale."""
    cfg, grid = sim.cfg, sim.grid
    _, _, p_inf, rho_inf, vel_inf, _ = sim.freestream_primitives()
    q_dyn = 0.5 * rho_inf * float(np.dot(vel_inf, vel_inf)) \
        * (cfg.ref_area if cfg.ref_area > 0 else 1.0)
    tags = cfg.marker_monitoring
    arm = max(np.abs(grid.coords[grid.bnd_nodes[t]]
                     - cfg.ref_origin_moment_x).max() for t in tags)
    area = sum(np.abs(grid.bnd_normal[t]).sum() for t in tags)
    return p_inf * area * max(1.0, arm / cfg.ref_length) / q_dyn


def with_lines(text, **settings):
    """The cfg text with each KEY= value of settings (replacing the
    text's own)."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(tuple(settings))]
    return "\n".join(lines + [f"{k}= {v}" for k, v in settings.items()])


def tri_sims(text, shape=CHANNEL, seed=0):
    """(su2_tpu Simulation, port Simulation on the CPU) of the case text on
    the scrambled triangle channel, both in float64."""
    import jax.numpy as jnp
    from su2_tpu.config import Config as JConfig
    from su2_tpu.driver import Simulation as JSimulation
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    jraw, raw = tri_meshes(shape, seed)
    return (JSimulation(JConfig(text=text), dtype=jnp.float64,
                        raw_mesh=jraw),
            Simulation(Config(text=text), raw_mesh=raw, dtype=torch.float64,
                       device="cpu"))


def with_prec(text, prec):
    """The case text with LINEAR_SOLVER_PREC= prec."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith("LINEAR_SOLVER_PREC")]
    return "\n".join(lines + [f"LINEAR_SOLVER_PREC= {prec}"])


def with_implicit(text, muscl=True, limiter="VENKATAKRISHNAN",
                  cfl=cases.IMPLICIT_CFL, prec="JACOBI"):
    """The case text with implicit flow (cases.with_implicit_flow): prec
    (JACOBI, LU_SGS or ILU0) for both systems, MUSCL with the limiter
    (None: unlimited), first order with muscl False."""
    return cases.with_implicit_flow(text, muscl=muscl, limiter=limiter,
                                    cfl=cfl, prec=prec)


def mixed_state(ts, ys=None, seed=None):
    """A conserved state (N, nVar) in numpy of the port's Simulation ts: the
    freestream's T, P and velocity (each perturbed by 2 % per node when a
    seed is given) and the composition ys, or per node a Dirichlet draw
    with every species present when ys is None; the energy is the
    composition's own, so the state keeps its temperature."""
    from su2_tpu_torch.chemistry import library as cl
    lay, n = ts.lay, ts.mesh.npoint
    _, t_inf, p_inf, _, vel_inf, _ = ts.freestream_primitives()
    rng = np.random.default_rng(seed)
    jit = (lambda shape: 1.0 + 0.02 * rng.standard_normal(shape)) \
        if seed is not None else (lambda shape: np.ones(shape))
    t = t_inf * jit(n)
    p = p_inf * jit(n)
    vel = vel_inf[None] * jit((n, lay.ndim)) \
        + (0.2 * rng.standard_normal((n, lay.ndim)) if seed is not None
           else 0.0)
    if ys is None:
        alpha = np.array([1.0] * 5 + [0.05] * (lay.ns - 5))
        ys = rng.dirichlet(alpha, n)
    ys = np.broadcast_to(np.asarray(ys, np.float64), (n, lay.ns))
    lib = ts.lib_host
    h = tt(cl.mixture_enthalpy_plain(lib, tt(t), tt(ys)))
    rgas = tt(cl.mixture_rgas(lib, tt(ys)))
    h, rgas = npy(h), npy(rgas)
    rho = p / (rgas * t)
    e = h - rgas * t + 0.5 * (vel * vel).sum(1)
    return np.concatenate([rho[:, None], rho[:, None] * vel,
                           (rho * e)[:, None], rho[:, None] * ys], axis=1)


def jacobian_from_jax(jac):
    """A JAX StencilJacobianT as the port's linalg.blockcsr.StencilJacobianT
    (CPU tensors; the same diag (nP, v, v) and lane-layout sel_t
    (K*v*v, nP))."""
    from su2_tpu_torch.linalg.blockcsr import StencilJacobianT
    return StencilJacobianT(diag=tt(jac.diag), sel_t=tt(jac.sel_t))


def chemlib_numpy(jlib) -> dict:
    """The JAX ChemLib's leaves as numpy plus its metadata."""
    d = {k: np.asarray(getattr(jlib, k)) for k in _TABLE_FIELDS}
    d.update({k: getattr(jlib, k) for k in META})
    return d


def jax_species_cut(jlib, ns):
    """su2_tpu's ChemLib jlib cut to ns species as cases.species_cut cuts
    the port's library: its first ns, or past its count its species again
    in order (copies named name_1, ...); the reactions keep their rates and
    take the kept species' stoichiometry and orders."""
    import dataclasses
    idx = np.arange(ns) % jlib.nspecies
    kw = {k: getattr(jlib, k)[idx] for k in (
        "mm", "ri", "diff_vol", "h_form", "cp_y", "cp_y2", "h_y", "h_y2",
        "s_y", "s_y2", "mu_y", "mu_y2", "ka_y", "ka_y2", "stoich_r",
        "stoich_p")}
    kw.update({k: getattr(jlib, k)[:, idx] for k in ("exp_f", "exp_b")})
    names = tuple(jlib.species[i % jlib.nspecies]
                  + ("" if i < jlib.nspecies else f"_{i // jlib.nspecies}")
                  for i in range(ns))
    return dataclasses.replace(jlib, nspecies=ns, species=names, **kw)


def tt(x, dtype=torch.float64):
    """numpy / JAX array -> CPU tensor (a copy)."""
    return torch.as_tensor(np.array(x)).to(dtype)


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def random_gas(ns, n, seed, t_range=(300.0, 2500.0)):
    """Random (T, rho, Y) in numpy, with vanishing species."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(*t_range, n)
    rho = rng.uniform(0.2, 2.0, n)
    ys = rng.dirichlet(np.ones(ns), size=n)
    ys[: n // 4, 0] = 0.0
    ys[n // 4: n // 2, 2] = 1e-16
    omt = rng.uniform(1.0, 1e4, n)
    return t, rho, ys, omt


def random_conserved(h_rgas, ns, nd, n, seed):
    """A random conserved state u (N, nVar), a perturbed temperature guess
    and a turbulent kinetic energy, in numpy float64, from random T, P,
    velocity and a mixing-layer composition; h_rgas(t, ys) returns the
    mixture enthalpy and gas constant."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(500.0, 2500.0, n)
    p = rng.uniform(0.9e5, 1.2e5, n)
    vel = rng.normal(0.0, 20.0, (n, nd))
    # fuel, water, oxygen and the carbon oxides; radicals and H2 at traces
    # (a mixture of fewer species: its first ns of those)
    alpha = np.array(([1.0] * 5 + [0.05] * max(ns - 5, 0))[:ns])
    ys = rng.dirichlet(alpha, n)
    h, rgas = h_rgas(t, ys)
    rho = p / (rgas * t)
    e = h - rgas * t + 0.5 * (vel * vel).sum(1)
    u = np.concatenate([rho[:, None], rho[:, None] * vel, (rho * e)[:, None],
                        rho[:, None] * ys], axis=1)
    t_guess = t * (1.0 + 0.02 * rng.standard_normal(n))
    tke = rng.uniform(0.0, 5.0, n)
    return u, t_guess, tke


def assert_fields_close(got, want, rtol, atol_frac, names):
    """Every field: |got - want| <= rtol |want| + atol_frac max|want|."""
    for name, g, w in zip(names, got, want):
        g, w = npy(g), npy(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_frac * np.abs(w).max(), err_msg=name)


def band_system(n, v, offsets, ncolor, seed=0):
    """Random band block system in su2_tpu's padded lane layout (numpy),
    with its invariants (zero blocks for out-of-range neighbours, zero pad
    lanes) and round-robin masks, which are not a proper coloring for
    offsets like +-7..9 (built as tests/test_stencil_tiled.py builds its
    systems)."""
    rng = np.random.default_rng(seed)
    npad = -(-n // 128) * 128
    k = len(offsets)
    sel = rng.standard_normal((k, v, v, npad)) * 0.1
    for kk, o in enumerate(offsets):
        p = np.arange(npad)
        sel[kk, :, :, (p + o < 0) | (p + o >= n) | (p >= n)] = 0.0
    diag = rng.standard_normal((npad, v, v)) * 0.1 + 3.0 * np.eye(v)
    diag[n:] = 0.0
    dinv = np.zeros_like(diag)
    dinv[:n] = np.linalg.inv(diag[:n])
    lanes = lambda b: b.transpose(1, 2, 0).reshape(v * v, npad)
    colors = np.arange(npad) % ncolor
    masks = np.stack([(colors == c) & (np.arange(npad) < n)
                      for c in range(ncolor)]).astype(np.float64)
    r = rng.standard_normal((v, npad))
    r[:, n:] = 0.0
    return dict(n=n, v=v, offsets=tuple(offsets), ncolor=ncolor,
                sel_t=sel.reshape(k * v * v, npad), dinv_t=lanes(dinv),
                diag_t=lanes(diag), masks_t=masks, r_t=r)


def recolor(s, colors, ncolor):
    """The band/quad system dict s with the node colors (n,) int array
    (ncolor of them; a color may have no node) in place of its masks."""
    npad = s["masks_t"].shape[1]
    c = np.full(npad, -1)
    c[:s["n"]] = colors
    return dict(s, ncolor=ncolor, masks_t=np.stack(
        [c == k for k in range(ncolor)]).astype(np.float64))


# Band systems (width, offsets, colors p mod ncolor) whose colors are a
# proper coloring (no offset a multiple of ncolor) with 2, 3 and 4 colors,
# and one that is not (offsets +-8 with 4 colors)
COLORINGS = {"proper2": ((-9, -1, 1, 9), 2), "proper3": ((-4, -1, 1, 4), 3),
             "proper4": ((-9, -1, 1, 9), 4),
             "roundrobin4": ((-8, -1, 1, 8), 4)}


def stencil_args(s, dtype, mixed=False, device="cpu"):
    """The port's operands of a band/quad system dict: unpadded, blocks
    lane-major, r node-major, int8 colors from the masks (which partition
    the nodes); mixed rounds the sweep blocks to bf16.  Returns (kwargs of
    sgs_matvec_plain / fgmres, r)."""
    n = s["n"]
    cut = lambda x: tt(x[..., :n], dtype).to(device).contiguous()
    sel = cut(s["sel_t"])
    masks = s["masks_t"][:, :n] > 0.5
    assert (masks.sum(0) == 1).all()
    colors = torch.as_tensor(masks.argmax(0).astype(np.int8)).to(device)
    return dict(selp_t=sel.to(torch.bfloat16) if mixed else sel, selm_t=sel,
                dinv_t=cut(s["dinv_t"]), diag_t=cut(s["diag_t"]),
                colors=colors, offsets=s["offsets"],
                ncolor=s["ncolor"]), cut(s["r_t"]).T.contiguous()


def color_major_sgs_matvec(selp_t, selm_t, dinv_t, diag_t, colors, order, r,
                           offsets, ncolor, matvec=True):
    """The tests' model of K5's sweep over the color-major lane layout
    (stencil_solve.color_order / to_color_major): each pass runs over the
    lanes of its color only, lane i updating node order[i] from its own
    blocks selp_t[:, i], dinv_t[:, i] and the previous pass's z at
    order[i] + o_k; the other nodes keep their z.  The block products are
    the plain version's (_bapply); w as sgs_matvec_plain's."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    n, v = r.shape
    vv, idx = v * v, order.long()
    z = torch.zeros_like(r)
    for c in list(range(ncolor)) + list(range(ncolor - 2, -1, -1)):
        lanes = torch.nonzero(colors[idx] == c).flatten()
        p = idx[lanes]
        od = 0
        for k, off in enumerate(offsets):
            od = od + ts._bapply(selp_t[k * vv:(k + 1) * vv, lanes],
                                 z[(p + int(off)) % n], v)
        z = z.clone()
        z[p] = ts._bapply(dinv_t[:, lanes], r[p] - od, v)
    w = None
    if matvec:
        w = ts._bapply(diag_t, z, v) + ts.offdiag_plain(selm_t, z, offsets, v)
    return z, w


def edge_shape_inputs(nd, ns, directory, dtype=torch.float64, device="cpu",
                      seed=8):
    """(mesh, (lib, lay, species consts, consts, f_all)): the explicit edge
    kernels' inputs at the (dimension, species count) shape: the case's
    9-species library cut to its first ns species, on channel_mesh(9, 7)
    (63 nodes) or box_mesh(6, 5, 4) (120 nodes), a random reacting state
    (numpy seed) through the plain node state, random gradients
    (cases.shape_inputs)."""
    x = cases.shape_inputs(nd, ns, str(directory), dtype, device, seed=seed)
    return x["mesh"], x["explicit"]


def implicit_shape_inputs(ns, directory, dtype=torch.float64, device="cpu",
                          seed=8):
    """(mesh, K10's arguments (lib, lay, species consts, consts, f_all,
    offsets, normals, edge vectors, muscl, limiter)): the inputs of
    cases.shape_inputs at (2, ns), MUSCL with the limiter."""
    x = cases.shape_inputs(2, ns, str(directory), dtype, device, seed=seed)
    mesh = x["mesh"]
    return mesh, x["implicit"] + (mesh.fam_offsets, mesh.fam_normal,
                                  mesh.fam_evec, True, True)


def ausm_edge_inputs(lay, n=300, seed=5):
    """Random face states (numpy, edge-major) for the AUSM+-up flux and
    Jacobians: v_i, v_j (E, nPrim) with subsonic and supersonic normal Mach
    numbers, dP/dU rows s_i, s_j (E, nVar) and normals (E, 2), every tenth
    one zero (a pad slot)."""
    rng = np.random.default_rng(seed)

    def prim():
        t = rng.uniform(300.0, 2500.0, n)
        a = rng.uniform(300.0, 900.0, n)
        vel = rng.normal(0.0, 20.0, (n, lay.ndim))
        vel[::7] *= 40.0                      # |M| > 1 on some faces
        p = rng.uniform(0.9e5, 1.2e5, n)
        rho = rng.uniform(0.2, 1.5, n)
        h = rng.normal(0.0, 1e6, n)
        ys = rng.dirichlet(np.ones(lay.ns), n)
        return np.concatenate([t[:, None], vel, p[:, None], rho[:, None],
                               h[:, None], a[:, None], ys], axis=1)

    normal = rng.normal(0.0, 0.01, (n, lay.ndim))
    normal[::10] = 0.0
    s = lambda: rng.normal(0.0, 1.0, (n, lay.nvar)) * np.r_[
        1e2, np.full(lay.ndim, 10.0), 0.4, np.full(lay.ns, 1e5)]
    return dict(v_i=prim(), v_j=prim(), normal=normal, s_i=s(), s_j=s())
