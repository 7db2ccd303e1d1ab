"""The 3D implicit flow's kernels' plain versions against su2_tpu in
float64: the viscous flux and its approximate Jacobians in 3D (RANS with
the reference's 3D SST closure branch, and laminar), K10's plain version
(ops/edge_implicit.edge_implicit_plain) against fused_edge_implicit_pallas
in interpret mode on the 80-node box (first order, MUSCL, MUSCL +
Venkatakrishnan's limiter values; 9 and 3 species), K11's (ops/ausm_t) in
3D against ausm_flux_jac_pallas_t in interpret mode, the plain K5 sweep
and matvec and the one-launch K6 cycle at the 3D flow's block widths 8
and 14 with the box's 6 stencil offsets against su2_tpu's stencil kernels
and make_solver_ops, and the solve tiers at those widths against su2_tpu's.
Tolerances as tests/test_torch_edge_implicit.py and
tests/test_torch_stencil_solve.py state them."""

import functools
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

BOX = (5, 4, 4)                 # 80 nodes, 12 interior
BOX_OFFSETS = (-16, -4, -1, 1, 4, 16)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """(su2_tpu, port) Simulations of the implicit case on box_mesh(*BOX)
    with cases.with_box_markers' walls."""
    from su2_tpu.config import Config as JConfig
    from su2_tpu.driver import Simulation as JSimulation
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import box_mesh
    d = tmp_path_factory.mktemp("box3d")
    text = th.cases.with_box_markers(th.write_case(d))
    text = th.with_implicit(text, prec="LU_SGS")
    raw = box_mesh(*BOX)
    return (JSimulation(JConfig(text=text), dtype=jnp.float64,
                        raw_mesh=th.jax_raw(raw)),
            Simulation(Config(text=text), raw_mesh=raw, dtype=torch.float64,
                       device="cpu"))


def _rows(js, ts, n=64, seed=3):
    """Random 3D edge rows (numpy) of the box case: node states of a
    perturbed mixed state with their dT/dU rows, random normals and edge
    vectors, the NS gradients and random SST fields; the first row a
    padded slot (zero normal)."""
    from su2_tpu import state as st
    from su2_tpu.ops import viscous as vis
    from su2_tpu.solvers import euler as es
    lib, lay, mesh, prm = js.lib, js.lay, js.mesh, js.params
    rng = np.random.default_rng(seed)
    u = th.mixed_state(ts, seed=seed)
    _, v, _ = st.cons2prim(lib, lay, jnp.asarray(u), js.t0, js.tparams)
    grad = np.asarray(es.compute_gradients(
        mesh, prm, vis.ns_gradient_vars(lib, lay, v)))
    tr = vis.node_transport(lib, lay, v)
    v = np.asarray(v)
    idx = rng.choice(mesh.npoint, size=(2, n))
    tdu = np.asarray(st.dtdu(lib, lay, jnp.asarray(v)))
    out = dict(v_i=v[idx[0]], v_j=v[idx[1]], t_i=tdu[idx[0]],
               t_j=tdu[idx[1]], g_i=grad[idx[0]], g_j=grad[idx[1]],
               normal=rng.normal(0.0, 0.01, (n, 3)),
               evec=rng.normal(0.0, 0.02, (n, 3)),
               mu_i=np.asarray(tr.mu)[idx[0]], mu_j=np.asarray(tr.mu)[idx[1]],
               ka_i=np.asarray(tr.kappa)[idx[0]],
               ka_j=np.asarray(tr.kappa)[idx[1]],
               mut_i=rng.uniform(1e-5, 1e-3, n),
               mut_j=rng.uniform(1e-5, 1e-3, n),
               tke_i=rng.uniform(0.0, 5.0, n), tke_j=rng.uniform(0.0, 5.0, n),
               gk_i=rng.normal(0.0, 0.1, (n, 3)),
               gk_j=rng.normal(0.0, 0.1, (n, 3)), sk=rng.uniform(0.85, 1.0, n))
    out["normal"][0] = 0.0
    return out


@pytest.mark.parametrize("turb", ["rans", "laminar"])
def test_viscous_flux_3d_matches_jax(box, turb):
    """ops/viscous_t.viscous_flux_t with its approximate Jacobians on 64
    random 3D edge rows: RANS against su2_tpu's viscous_t.viscous_flux_t
    (the 3D thin-shear tensor and the reference's 3D SST closure branch:
    the species mass-closure diagonal, the energy-species entry without
    Y_k), laminar (mu_t None) against su2_tpu's node-major
    viscous.viscous_flux with turb None, corrected along the edge; flux
    and both Jacobians at 1e-12 x max, the zero-normal row exactly 0."""
    from su2_tpu.chemistry import library as jcl
    from su2_tpu.ops import viscous as jvis, viscous_t as jvt
    from su2_tpu_torch.chemistry import library as cl
    from su2_tpu_torch.ops import edge_flux, viscous_t
    js, ts = box
    r = _rows(js, ts)
    lay, n = ts.lay, r["v_i"].shape[0]
    sel = [0, 1, 2, 3] + list(range(5, 5 + lay.ns))
    T = lambda k: th.tt(r[k])
    J = lambda k: jnp.asarray(r[k])
    g = lambda k: th.tt(r[k][:, sel].transpose(1, 2, 0))
    tmean = 0.5 * (r["v_i"][:, 0] + r["v_j"][:, 0])
    hs = cl.species_enthalpy(ts.lib, th.tt(tmean)).T
    cps = cl.species_cp(ts.lib, th.tt(tmean)).T
    pr_t, le_t = ts.params.prandtl_turb, ts.params.lewis_turb
    rans = turb == "rans"
    opt = lambda k: T(k) if rans else None
    got = viscous_t.viscous_flux_t(
        lay, edge_flux.species_consts_of(ts.lib), T("v_i").T, T("v_j").T,
        g("g_i"), g("g_j"), T("normal").T, T("evec").T, T("mu_i"),
        T("mu_j"), T("ka_i"), T("ka_j"), opt("mut_i"), opt("mut_j"),
        opt("tke_i"), opt("tke_j"), T("gk_i").T, T("gk_j").T, T("sk"), hs,
        cps, pr_t, le_t, s_i=T("t_i").T, s_j=T("t_j").T)
    if rans:
        jsc = jvt.species_consts(np.asarray(js.lib.mm),
                                 np.asarray(js.lib.diff_vol), jnp.float64)
        jg = lambda k: jnp.asarray(r[k][:, sel].transpose(1, 2, 0))
        want = jvt.viscous_flux_t(
            js.lay, jsc, J("v_i").T, J("v_j").T, jg("g_i"), jg("g_j"),
            J("normal").T, J("evec").T, J("mu_i"), J("mu_j"), J("ka_i"),
            J("ka_j"), J("mut_i"), J("mut_j"), J("tke_i"), J("tke_j"),
            J("gk_i").T, J("gk_j").T, J("sk"), jnp.asarray(th.npy(hs)),
            jnp.asarray(th.npy(cps)), pr_t, le_t, s_i=J("t_i").T,
            s_j=J("t_j").T)
    else:
        dij = lambda k: jcl.binary_diffusion(
            js.lib, J(k)[:, 0], J(k)[:, 4] / 101325.0) / 1e4
        tr = lambda s: {"mu": J(f"mu_{s}"), "kappa": J(f"ka_{s}"),
                        "dij": dij(f"v_{s}")}
        coords = np.zeros((n, 3))
        want = jvis.viscous_flux(
            js.lib, js.lay, J("v_i"), J("v_j"), J("g_i"), J("g_j"),
            J("normal"), tr("i"), tr("j"), coord_i=jnp.asarray(coords),
            coord_j=jnp.asarray(coords + r["evec"]), corrected=True,
            s_i=J("t_i"), s_j=J("t_j"))
        want = (want[0].T, jnp.moveaxis(want[1], 0, -1),
                jnp.moveaxis(want[2], 0, -1))
    for name, gg, ww in zip(("flux", "jac_i", "jac_j"), got, want):
        gg, ww = th.npy(gg), np.asarray(ww)
        assert gg.shape == ww.shape
        np.testing.assert_allclose(gg[..., 1:], ww[..., 1:], rtol=0.0,
                                   atol=1e-12 * np.abs(ww).max(),
                                   err_msg=name)
        assert (gg[..., 0] == 0.0).all()


# (muscl, limiter) variants of K10
VARIANTS = {"first_order": (False, False), "muscl": (True, False),
            "venkatakrishnan": (True, True)}
K10_CASES = [(ns, v) for ns in (9, 3) for v in VARIANTS]


@pytest.mark.parametrize("ns,variant", K10_CASES,
                         ids=[f"{ns}-{v}" for ns, v in K10_CASES])
def test_k10_plain_3d_matches_pallas(tmp_path, ns, variant):
    """K10's plain version in 3D on the 80-node box (cases.shape_inputs
    at (3, ns): a random reacting state, random gradients and limiter
    values) against fused_edge_implicit_pallas in interpret mode on each
    of the box's 3 families: flux, j_i and j_j to 1e-11 x max|output|,
    the pad slots exactly 0.  On the card K10 runs (3, 9) and (3, 3)
    through compiled instances."""
    from su2_tpu.ops import viscous_t
    from su2_tpu.pallas import edge_fused as ef
    from su2_tpu.state import Layout as JLayout
    from su2_tpu_torch.geometry.structured import box_mesh
    from su2_tpu_torch.ops import edge_implicit as ei
    muscl, limiter = VARIANTS[variant]
    mesh, args = th.implicit_shape_inputs(ns, tmp_path, nd=3,
                                          raw_mesh=box_mesh(*BOX))
    args = args[:8] + (muscl, limiter)
    lib, consts, f_all = args[0], args[3], args[4]
    assert tuple(mesh.stencil_offsets) == BOX_OFFSETS
    flux, j_i, j_j = ei.edge_implicit_plain(*args)
    npl = th.npy
    jlib = SimpleNamespace(**{k: jnp.asarray(npl(getattr(lib, k)))
                              for k in ("h_y", "h_y2", "cp_y", "cp_y2")})
    sc = viscous_t.species_consts(npl(lib.mm), npl(lib.diff_vol),
                                  jnp.float64)
    call = jax.jit(functools.partial(
        ef.fused_edge_implicit_pallas, JLayout(3, ns), *consts, muscl,
        limiter, (float(lib.t0), float(lib.dt), int(lib.nt)), sc))
    tabs = (ef._hcp_tables(jlib, jnp.float64),
            jnp.asarray(npl(lib.mm))[:, None],
            jnp.asarray(npl(lib.ri))[:, None])
    f = npl(f_all)
    assert len(mesh.fam_offsets) == 3
    for k, o in enumerate(mesh.fam_offsets):
        want = call(jnp.asarray(f), jnp.asarray(np.roll(f, -o, axis=1)),
                    jnp.asarray(npl(mesh.fam_normal[k]).T),
                    jnp.asarray(npl(mesh.fam_evec[k]).T), *tabs)
        pad = npl((mesh.fam_normal[k] == 0).all(-1))
        assert pad.any()
        for name, got, w in zip(("flux", "j_i", "j_j"),
                                (flux[k], j_i[k], j_j[k]), want):
            g, w = npl(got), np.asarray(w)
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g, w, rtol=0.0,
                                       atol=1e-11 * np.abs(w).max(),
                                       err_msg=f"{name} family {k}")
            assert (g[:, pad] == 0.0).all(), f"{name} pad slots"


@pytest.mark.parametrize("ns", [9, 3])
def test_ausm_t_3d_matches_pallas(ns):
    """K11's plain version (ops/edge_kernels.ausm_flux_jac_t) in 3D on
    random face states (subsonic and supersonic normal Mach numbers)
    against ausm_flux_jac_pallas_t in interpret mode, f64, at 1e-12 x max
    over the valid slots; the pad slots exactly 0."""
    from su2_tpu.pallas import edge_kernels as jek
    from su2_tpu.state import Layout as JLayout
    from su2_tpu_torch.ops import edge_kernels as ek
    from su2_tpu_torch.state import Layout
    lay = Layout(3, ns)
    r = th.ausm_edge_inputs(lay)
    m_inf = 0.0251
    J = lambda k: jnp.asarray(r[k])
    want = jek.ausm_flux_jac_pallas_t(JLayout(3, ns), J("v_i"), J("v_j"),
                                      J("normal"), m_inf, J("s_i"),
                                      J("s_j"))
    got = ek.ausm_flux_jac_t(lay, *(th.tt(r[k].T) for k in
                                    ("v_i", "v_j", "normal")), m_inf,
                             th.tt(r["s_i"].T), th.tt(r["s_j"].T))
    got = (got[0].T, got[1].permute(2, 0, 1), got[2].permute(2, 0, 1))
    valid = (r["normal"] != 0.0).any(1)
    for g, w in zip(got, want):
        g, w = th.npy(g), np.asarray(w)
        assert g.shape == w.shape and g.shape[-1] == lay.nvar
        np.testing.assert_allclose(g[valid], w[valid], rtol=0.0,
                                   atol=1e-12 * np.abs(w[valid]).max())
        assert (g[~valid] == 0.0).all()


def _box_system(v, seed):
    """A random system at block width v on box_mesh(*BOX)'s stencil
    (th.band_system with the box's offsets, the greedy coloring of the
    box's node graph as colors), and the JAX mesh stand-in."""
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid
    from su2_tpu_torch.geometry.structured import box_mesh
    from su2_tpu_torch.linalg import blockcsr
    grid = build_dual_grid(box_mesh(*BOX))
    colors = blockcsr.greedy_coloring(grid.node_nbrs)
    s = th.recolor(th.band_system(grid.npoint, v, BOX_OFFSETS, 2, seed=seed),
                   colors, int(colors.max()) + 1)
    return s, colors


@pytest.mark.parametrize("v", [8, 14])
def test_stencil_3d_widths_match_jax(v):
    """K5's plain version at the 3D flow's block width v with the box's 6
    offsets and node coloring against su2_tpu's kernels in interpret mode
    (v = 8: the sweep + matvec; v = 14: the matvec; f64 rtol 1e-12, atol
    1e-14 x max), and the port's make_solver_ops_stencil_t (LU_SGS, f64:
    the one-launch K6 tier here) against su2_tpu's make_solver_ops_stencil_t
    on its XLA ops (allow_pallas False: the same multicolor sweep and
    FGMRES): matvec and sweep at rtol 1e-12, one FGMRES(3) solve at the
    FGMRES pins (x rtol 1e-9, atol 1e-12; equal iterations)."""
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu.linalg import krylov as jk
    from su2_tpu.pallas import stencil_solve as stks
    from su2_tpu_torch.linalg import blockcsr as tb
    from su2_tpu_torch.linalg import stencil_solve as ts
    s, colors = _box_system(v, seed=v)
    n, ncolor = s["n"], s["ncolor"]
    j = {k: jnp.asarray(s[k]) for k in ("sel_t", "dinv_t", "diag_t",
                                        "masks_t", "r_t")}
    args, r = th.stencil_args(s, torch.float64)
    if v == 8:
        want = stks._sgs_matvec_call(j["sel_t"], j["dinv_t"], j["diag_t"],
                                     j["masks_t"], j["r_t"],
                                     offsets=BOX_OFFSETS, v=v, ncolor=ncolor,
                                     interpret=True)
        got = ts.sgs_matvec_plain(**args, r=r)
    else:
        want = [stks._matvec_call(j["sel_t"], j["diag_t"], j["r_t"],
                                  offsets=BOX_OFFSETS, v=v, interpret=True)]
        got = [ts.sgs_matvec_plain(**args, r=r, sweep=False)[1]]
    for g, w in zip(got, want):
        w = np.asarray(w)[:, :n].T
        np.testing.assert_allclose(th.npy(g), w, rtol=1e-12,
                                   atol=1e-14 * np.abs(w).max())
    # make_solver_ops on the same blocks, both packages
    sel_t = s["sel_t"][:, :n]
    diag = s["diag_t"][:, :n].reshape(v, v, n).transpose(2, 0, 1)
    masks = [jnp.asarray(colors == c) for c in range(ncolor)]
    jmesh = SimpleNamespace(npoint=n, stencil_offsets=BOX_OFFSETS,
                            n_shards=1)
    jops = jb.make_solver_ops_stencil_t(jmesh, jnp.asarray(diag),
                                        jnp.asarray(sel_t), "LU_SGS", masks,
                                        linear_iter=3, allow_pallas=False)
    tops = tb.make_solver_ops_stencil_t(
        jmesh, th.tt(diag), th.tt(sel_t), "LU_SGS",
        torch.as_tensor(colors.astype(np.int8)), ncolor, linear_iter=3)
    assert ts.solve_tier(n, BOX_OFFSETS, v, torch.float64, ncolor, 3)[1]
    assert tops[3] is not None
    b = np.random.default_rng(v + 1).normal(0, 1, (n, v))
    for jf, tf in zip(jops[:2], tops[:2]):
        np.testing.assert_allclose(th.npy(tf(th.tt(b))),
                                   np.asarray(jf(jnp.asarray(b))),
                                   rtol=1e-12, atol=1e-14)
    tx, _, tit = tops[3](th.tt(b), 3, 1e-12)
    jx, _, jit_ = jk.fgmres(jops[0], jops[1], jnp.asarray(b), max_iter=3,
                            tol=1e-12)
    np.testing.assert_allclose(th.npy(tx), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)
    assert int(tit) == int(jit_) == 3


TIER_PREDICATES = ("supported", "fgmres_supported",
                   "sgs_matvec_mixed_supported", "fgmres_mixed_supported",
                   "solve_tier")


@pytest.mark.parametrize("pred", TIER_PREDICATES)
def test_tier_gates_at_3d_widths_match_jax(pred):
    """The port's tier gates at the 3D flow's block widths 8 and 14 with
    6 stencil offsets (the box's) equal su2_tpu's over a table of sizes,
    dtypes, colors and Krylov budgets; solve_tier's (sweep dtype, one
    launch) against the branch su2_tpu's make_solver_ops_stencil_t takes
    (its predicates and tile_plan, pallas/stencil_solve.py)."""
    from su2_tpu.pallas import stencil_solve as stks
    from su2_tpu_torch.linalg import stencil_solve as ts
    dts = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
    sizes = (1000, 3000, 3500, 8000, 8400, 9072, 10260, 12288, 12289,
             49152, 136161, 262701, 565000)
    seen = set()
    for n in sizes:
        for nx in (20, 41, 51):
            offsets = (-nx * nx, -nx, -1, 1, nx, nx * nx)
            mesh = SimpleNamespace(npoint=n, n_shards=1,
                                   stencil_offsets=offsets)
            for v in (8, 14):
                for nc in (2, 3):
                    for m in (5, 10):
                        for jd, td in dts:
                            if pred == "solve_tier":
                                w = _jax_tier(stks, mesh, v, jd, nc, m)
                                g = ts.solve_tier(n, offsets, v, td, nc, m)
                                g = (str(g[0]).split(".")[-1], g[1])
                            elif pred == "supported":
                                w = stks.supported(mesh, v, jd, nc)
                                g = ts.supported(n, 6, v, td, nc)
                            elif pred == "fgmres_supported":
                                w = stks.fgmres_supported(mesh, v, jd, nc, m)
                                g = ts.fgmres_supported(n, 6, v, td, nc, m)
                            elif pred == "sgs_matvec_mixed_supported":
                                w = stks.sgs_matvec_mixed_supported(mesh, v,
                                                                    nc)
                                g = ts.sgs_matvec_mixed_supported(n, 6, v,
                                                                  nc)
                            else:
                                w = stks.fgmres_mixed_supported(mesh, v, nc,
                                                                m)
                                g = ts.fgmres_mixed_supported(n, 6, v, nc, m)
                            assert g == w, (pred, n, nx, v, nc, m, jd)
                            seen.add(g)
    assert len(seen) > 1


def _jax_tier(stks, mesh, v, jdtype, nc, m):
    """(sweep dtype name, one launch) of su2_tpu's make_solver_ops_stencil_t
    branch for an SGS solve (blockcsr.py:555-574)."""
    if stks.supported(mesh, v, jdtype, nc):
        return (jnp.dtype(jdtype).name,
                stks.fgmres_supported(mesh, v, jdtype, nc, m))
    if jdtype == jnp.float32 and stks.supported(mesh, v, jnp.bfloat16, nc):
        return "bfloat16", stks.fgmres_mixed_supported(mesh, v, nc, m)
    if jdtype == jnp.float32 and stks.tile_plan(mesh, v, nc, 2, True):
        return "bfloat16", False
    return jnp.dtype(jdtype).name, False


def test_3d_kernel_lists_match_the_sources():
    """kernels.STENCIL_WIDTHS lists the widths SU2K_BY_WIDTH instantiates
    in csrc/stencil_solve.cu (8 and 14, the 3D flow's, among them), and
    K10 and K11 take the dimensions of IMPLICIT_DIMS and AUSM_DIMS (2 and
    3): a 4D layout raises a ValueError that names them, before any
    launch."""
    import os
    import re
    from su2_tpu_torch import kernels
    with open(os.path.join(kernels.CSRC, "stencil_solve.cu")) as fh:
        src = fh.read()
    block = src[src.index("#define SU2K_BY_WIDTH"):]
    block = block[:block.index("default:")]
    widths = tuple(int(w) for w in re.findall(r"case (\d+):", block))
    assert widths == kernels.STENCIL_WIDTHS
    assert {8, 14} <= set(widths)
    assert kernels.IMPLICIT_DIMS == kernels.AUSM_DIMS == (2, 3)
    lay = SimpleNamespace(ndim=4, ns=9)
    x = torch.zeros((1, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"edge_implicit: 4D.*\(2, 3\)"):
        kernels.edge_implicit(None, lay, None, (0, 0, 0), x, (1,), x, x,
                              True, True)
    with pytest.raises(ValueError, match=r"ausm_flux_jac: 4D.*\(2, 3\)"):
        kernels.ausm_flux_jac(lay, x, x, x, 0.0, x, x)
