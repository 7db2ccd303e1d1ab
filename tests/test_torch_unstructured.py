"""The explicit REACTIVE_RANS step of su2_tpu_torch on a mesh without a
static stencil (the gather path) against su2_tpu, on the 153-node
scrambled triangle channel (cases.tri_channel_mesh(17, 9)): the mesh
arrays, the edge-to-node sums, the gradients, kernel K13's plain version
against su2_tpu's fused_edge_flux_pallas (interpret mode), ns_assemble,
the edge-list SST step and its BlockJacobian solve, three coupled
iterations of the step and the CLI (implicit flow, laminar runs and 3D
there: tests/test_torch_unstructured_implicit.py)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_edge_flux as tef
import torch_helpers as th

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("u", "t_guess", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
         "turb_rms", "nonphys", "min_dt")


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.write_case(tmp_path_factory.mktemp("tri"))


@pytest.fixture(scope="module")
def sims(text):
    return th.tri_sims(text)


@pytest.mark.parametrize("shape,npoint,nedge",
                         [((17, 9), 153, 408), ((189, 48), 9072, 26743)])
def test_tri_channel_sizes(shape, npoint, nedge):
    """The scrambled triangle channels of the tests and of the flagship
    class: node and edge counts, no static stencil, and no structured
    renumbering (structured_order rejects triangles)."""
    from su2_tpu_torch.geometry import stencil as stn
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid
    from su2_tpu_torch import cases
    raw = cases.tri_channel_mesh(*shape)
    grid = build_dual_grid(raw)
    assert (grid.npoint, grid.nedge, grid.max_degree) == (npoint, nedge, 8)
    assert len(stn.edge_offsets(grid.edges)) > stn.MAX_OFFSETS
    assert stn.structured_order(raw) is None
    np.testing.assert_allclose(grid.volume.sum(), 0.25, rtol=1e-12)


def test_mesh_arrays_equal_jax(sims):
    """The port's mesh arrays equal su2_tpu's exactly, with every stencil
    and family field None on both sides; convert.mesh_from_numpy carries
    su2_tpu's mesh to the same arrays; greedy_coloring gives the same
    colors; neither Simulation renumbers."""
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu_torch.convert import mesh_from_numpy
    from su2_tpu_torch.linalg import blockcsr as tb
    js, ts = sims
    jm, tm = js.mesh, ts.mesh
    assert (jm.npoint, jm.nedge, jm.max_degree) == (153, 408, 8)
    assert (tm.npoint, tm.nedge, tm.max_degree) == (153, 408, 8)
    assert ts.perm is None
    for k in ("stencil_sel", "stencil_offsets", "wls_coeff", "gg_snormal",
              "stencil_pvec", "fam_normal", "fam_evec", "fam_offsets"):
        assert getattr(jm, k) is None and getattr(tm, k) is None, k
    fields = ("coords", "volume", "edges", "edge_normal", "edge_area",
              "node_edges", "node_sign", "node_nbrs", "nbr_mask",
              "n_neighbors", "bnd_accum_normal", "node_edges_sel",
              "node_edges_t", "node_sign_t")
    for k in fields:
        assert np.array_equal(th.npy(getattr(tm, k)),
                              np.asarray(getattr(jm, k))), k
    assert set(tm.markers) == set(jm.markers)
    for t in jm.markers:
        for a, b in zip(tm.markers[t], jm.markers[t]):
            assert np.array_equal(th.npy(a), np.asarray(b)), t
        assert np.array_equal(th.npy(tm.marker_nn[t]),
                              np.asarray(jm.marker_nn[t])), t
    d = {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in vars(jm).items() if k not in ("markers", "marker_nn")}
    d["markers"] = {t: (np.asarray(a), np.asarray(b))
                    for t, (a, b) in jm.markers.items()}
    d["marker_nn"] = {t: np.asarray(a) for t, a in jm.marker_nn.items()}
    got = mesh_from_numpy(d)
    for k, v in vars(tm).items():
        g = getattr(got, k)
        if isinstance(v, torch.Tensor):
            assert torch.equal(g, v), k
        elif not isinstance(v, dict):
            assert g == v, k
    colors = tb.greedy_coloring(th.npy(tm.node_nbrs))
    assert np.array_equal(colors, jb.greedy_coloring(np.asarray(jm.node_nbrs)))
    assert np.array_equal(th.npy(ts.colors), colors)
    assert ts.ncolor == int(colors.max()) + 1


def test_edge_node_sums_match_jax(sims):
    """scatter_edges, scatter_edges_mixed, accumulate_sides and
    sum_edges_abs on random edge values: rtol 1e-13."""
    js, ts = sims
    jm, tm = js.mesh, ts.mesh
    rng = np.random.default_rng(3)
    a = rng.standard_normal((tm.nedge, 13))
    b = rng.standard_normal((tm.nedge, 2))
    c = rng.standard_normal((tm.nedge, 2, 2))
    pairs = [
        (tm.scatter_edges(th.tt(c)), jm.scatter_edges(jnp.asarray(c))),
        (tm.sum_edges_abs(th.tt(a)), jm.sum_edges_abs(jnp.asarray(a))),
        (tm.accumulate_sides(th.tt(a), th.tt(a[:, ::-1].copy())),
         jm.accumulate_sides(jnp.asarray(a), jnp.asarray(a[:, ::-1]))),
    ]
    pairs += list(zip(tm.scatter_edges_mixed(th.tt(a), th.tt(b)),
                      jm.scatter_edges_mixed(jnp.asarray(a), jnp.asarray(b))))
    for got, want in pairs:
        np.testing.assert_allclose(th.npy(got), np.asarray(want),
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("method", ["GREEN_GAUSS", "WEIGHTED_LEAST_SQUARES"])
def test_gradients_match_jax(sims, method):
    """The gather Green-Gauss and 2D WLS gradients of a smooth field plus
    noise: rtol 1e-12, atol 1e-12 of the gradient's max."""
    from su2_tpu.ops import gradients as jg
    from su2_tpu_torch.ops import gradients as tg
    js, ts = sims
    x = th.npy(ts.mesh.coords)
    rng = np.random.default_rng(4)
    q = np.stack([np.sin(3 * x[:, 0]) + x[:, 1] ** 2,
                  np.exp(x[:, 0] * x[:, 1]), x[:, 0] - 2 * x[:, 1]], 1) \
        + 1e-3 * rng.standard_normal((x.shape[0], 3))
    if method == "GREEN_GAUSS":
        got, want = tg.green_gauss(ts.mesh, th.tt(q)), \
            jg.green_gauss(js.mesh, jnp.asarray(q))
    else:
        got, want = tg.weighted_least_squares(ts.mesh, th.tt(q)), \
            jg.weighted_least_squares(js.mesh, jnp.asarray(q))
    want = np.asarray(want)
    np.testing.assert_allclose(th.npy(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.fixture(scope="module")
def pair(sims):
    """A mixed, reacting state on the triangle channel, as
    test_torch_edge_flux builds it: (js, ts, u, t_guess, turb, omega_t)."""
    js, ts = sims
    n, nd = js.mesh.npoint, js.lay.ndim
    rng = np.random.default_rng(7)
    lay = js.lay
    u = np.asarray(js.u0) * (1.0 + 0.02 * rng.standard_normal(
        np.asarray(js.u0).shape))
    alpha = np.array([1.0, 1.0, 1.0, 1.0, 1.0] + [0.05] * (lay.ns - 5))
    u[:, lay.RHOS:] = u[:, :1] * rng.dirichlet(alpha, n)
    q = np.asarray(js.initial_turb_state()[0])
    turb = dict(tke=q[:, 0] * rng.uniform(0.5, 1.5, n),
                mu_t=rng.uniform(1e-5, 1e-3, n),
                grad_tke=rng.normal(0.0, 1e-1, (n, nd)),
                sigma_k=rng.uniform(0.85, 1.0, n))
    omega_t = q[:, 1] * rng.uniform(0.5, 1.5, n)
    return js, ts, u, np.asarray(js.t0), turb, omega_t


def test_k13_plain_matches_pallas(pair):
    """edge_list_flux_plain (K13's plain version) against su2_tpu's
    fused_edge_flux_pallas in interpret mode on the same stack, gathered
    to the edge endpoints as su2_tpu's fused_interior_terms gathers it:
    T3's tolerances (flux per row rtol 1e-12, atol 1e-12 of the row's
    max; lc rtol 1e-12; lv rtol 1e-10)."""
    from su2_tpu.ops import viscous_t as jvt
    from su2_tpu.pallas import edge_fused as jef
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    js, ts, u, t_guess, turb, _ = pair
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    t = {k: th.tt(v) for k, v in turb.items()}
    nsd = st.node_state(lib, lay, th.tt(u), th.tt(t_guess), ts.tparams,
                        turb_ke=t["tke"])
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(
        lib, lay, nsd.v, xs=nsd.xs))
    tfd = vis.TurbFlowData(tke=t["tke"], mu_t=t["mu_t"],
                           grad_tke=t["grad_tke"], sigma_k=t["sigma_k"])
    f_all = ef.stack_inputs(lay, nsd.v, grad, vis.Transport(nsd.mu,
                                                            nsd.kappa),
                            tfd, t["sigma_k"], nsd.dpdu[:, lay.RHOE])
    consts = (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb,
              prm.lewis_turb)
    got = ef.edge_list_flux_plain(lib, lay, ef.species_consts_of(lib),
                                  consts, f_all, mesh.edges,
                                  mesh.edge_normal, mesh.coords)
    jlib, jm = js.lib, js.mesh
    fa = jnp.asarray(th.npy(f_all))
    i, j = jm.edges[:, 0], jm.edges[:, 1]
    sc = jvt.species_consts(np.asarray(jlib.mm), np.asarray(jlib.diff_vol),
                            jnp.float64)
    want = jef.fused_edge_flux_pallas(
        js.lay, prm.m_infty, prm.prandtl_turb, prm.lewis_turb,
        prm.prandtl_lam, (float(jlib.t0), float(jlib.dt), int(jlib.nt)), sc,
        fa[:, i], fa[:, j], jm.edge_normal.T,
        (jm.coords[j] - jm.coords[i]).T, jef._hcp_tables(jlib, jnp.float64),
        jnp.asarray(jlib.mm, jnp.float64)[:, None])
    flux, lc, lv = (th.npy(x) for x in got)
    wf, wlc, wlv = (np.asarray(x) for x in want)
    assert flux.shape == (lay.nvar, mesh.nedge) == wf.shape
    for r in range(lay.nvar):
        np.testing.assert_allclose(flux[r], wf[r], rtol=1e-12,
                                   atol=1e-12 * np.abs(wf[r]).max(),
                                   err_msg=str(r))
    np.testing.assert_allclose(lc, wlc, rtol=1e-12)
    np.testing.assert_allclose(lv, wlv, rtol=1e-10)


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas"])
def test_ns_assemble_matches_jax(pair, fused):
    """The port's ns_assemble (the edge-list branch of
    fused_interior_terms, one scatter_edges_mixed) against su2_tpu's with
    the fused edge mode off (its XLA edge chain) and on (its
    fused_edge_flux_pallas in interpret mode): the residual at 1e-12 of
    each variable's max, the radii at rtol 1e-12 / 1e-10
    (test_torch_edge_flux's checks)."""
    tef._check_terms(tef._jax_terms(pair, fused), tef._port_terms(pair))


def _sst_inputs(js, ts, prec):
    """The SST step's inputs of both packages from one reacting state of
    the port (numpy in between): the flow phase's ghost states, the
    (k, omega) gradients, a perturbed previous-step gradient and eddy
    viscosity, a time step of the case's scale."""
    from su2_tpu.turbulence import sst as jsst
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import euler as es
    from su2_tpu_torch.turbulence import sst as tsst
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    rng = np.random.default_rng(11)
    n = mesh.npoint
    u = th.mixed_state(ts, seed=5)
    q0 = th.npy(ts.initial_turb_state()[0])
    q = q0 * rng.uniform(0.5, 1.5, q0.shape)
    nsd = st.node_state(lib, lay, th.tt(u), ts.t0, ts.tparams,
                        turb_ke=th.tt(q[:, 0]))
    v = nsd.v
    qg = vis.ns_gradient_vars(lib, lay, v, xs=nsd.xs)
    gall = es.compute_gradients(mesh, prm, torch.cat([qg, th.tt(q)], 1))
    grad, gq = gall[:, :qg.shape[1]], gall[:, qg.shape[1]:]
    strain, _ = tsst.strain_and_vorticity(lay, grad)
    dt = rng.uniform(5e-7, 2e-6, n)
    fb = es.flux_bc_batch(lib, lay, ts.bcs, v, nsd.dpdu, prm.tke_inf)
    gq_prev = th.npy(gq) * rng.uniform(0.8, 1.2, tuple(gq.shape))
    mu_t = rng.uniform(1e-5, 1e-3, n)
    rho_old = th.npy(v[:, lay.PRHO]) * (1.0 + 1e-3 * rng.standard_normal(n))
    common = dict(v=v, mu=nsd.mu, mu_t=mu_t, strain=strain, rho_old=rho_old,
                  dt=dt, gq=gq, gq_prev=gq_prev, q=q)
    targs = {k: (x if isinstance(x, torch.Tensor) else th.tt(x))
             for k, x in common.items()}
    jargs = {k: jnp.asarray(th.npy(x) if isinstance(x, torch.Tensor) else x)
             for k, x in common.items()}
    tcfg = dataclasses.replace(ts.scfg, linear_prec=prec)
    jcfg = dataclasses.replace(js.scfg, linear_prec=prec)
    if prec == "JACOBI":
        tcfg = dataclasses.replace(tcfg, colors=None, ncolor=0)
        jcfg = dataclasses.replace(jcfg, color_masks=None)
    out_t = tsst.sst_step(
        lay, mesh, tcfg, ts.bcs, targs["q"], targs["v"], targs["mu"],
        targs["mu_t"], targs["strain"], ts.wall_dist, targs["rho_old"],
        targs["dt"], ts.kine_inf, ts.omega_inf, targs["gq"],
        grad[:, 1:1 + lay.ndim, :], flow_fb=fb, gq_prev=targs["gq_prev"])
    jfb = (None, None, None, jnp.asarray(th.npy(fb.v_ghost)))
    out_j = jsst.sst_step(
        js.lay, js.mesh, jcfg, js.bcs, jargs["q"], jargs["v"],
        jnp.asarray(th.npy(grad)), jargs["mu"], jargs["mu_t"],
        jargs["strain"], js.wall_dist, jargs["rho_old"], jargs["dt"],
        js.kine_inf, js.omega_inf, gq=jargs["gq"], flow_fb=jfb,
        gq_prev=jargs["gq_prev"])
    return out_t, out_j


@pytest.mark.parametrize("prec", ["LU_SGS", "JACOBI"])
def test_sst_step_matches_jax(sims, prec):
    """The edge-list SST assembly (one scatter_edges, one
    accumulate_sides, the wall rows of off_ij/off_ji) and its
    BlockJacobian solve by FGMRES with the multicolor sweep (LU_SGS) or
    JACOBI against su2_tpu's sst_step on the same inputs: q, the residual
    RMS, mu_t and sigma_k at rtol 1e-9, atol 1e-12 (the fused-step
    checks of test_torch_sst_assemble)."""
    js, ts = sims
    got, want = _sst_inputs(js, ts, prec)
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        np.testing.assert_allclose(th.npy(g), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)
    for key in ("mu_t", "sigma_k"):
        np.testing.assert_allclose(th.npy(got[2][key]),
                                   np.asarray(want[2][key]), rtol=1e-9,
                                   atol=1e-12)


def test_sst_fused_mode_takes_the_unfused_path(sims):
    """With the fused SST assembly switched on (what
    SU2_TPU_SST_ASSEMBLE=pallas selects) a mesh without a stencil runs
    the unfused step, as su2_tpu's gate does: the same result bitwise and
    no K12 call."""
    from su2_tpu_torch.turbulence import sst as tsst, sst_assemble as sa
    js, ts = sims
    want, _ = _sst_inputs(js, ts, "LU_SGS")
    calls = []
    orig = sa.sst_assemble
    sa.sst_assemble = lambda *a: calls.append(1) or orig(*a)
    tsst.set_assemble_mode("fused")
    try:
        got, _ = _sst_inputs(js, ts, "LU_SGS")
    finally:
        tsst.set_assemble_mode("unfused")
        sa.sst_assemble = orig
    assert not calls
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("v", [2, 13])
def test_block_jacobian_ops_match_jax(sims, v):
    """matvec, block_diag_inv and multicolor_sgs_apply of a random
    BlockJacobian (v = 2, the SST's, and 13, the flow's) against su2_tpu's
    matvec, block_jacobi_factor and multicolor_sgs_apply: rtol 1e-13."""
    from su2_tpu.linalg import blockcsr as jb
    from su2_tpu_torch.linalg import blockcsr as tb
    js, ts = sims
    rng = np.random.default_rng(9)
    n, ne = ts.mesh.npoint, ts.mesh.nedge
    colors = th.npy(ts.colors).astype(np.int64)
    masks = tuple(jnp.asarray(colors == c) for c in range(ts.ncolor))
    diag = rng.standard_normal((n, v, v)) * 0.1 + 4.0 * np.eye(v)
    oij = rng.standard_normal((ne, v, v)) * 0.1
    oji = rng.standard_normal((ne, v, v)) * 0.1
    x = rng.standard_normal((n, v))
    tj = tb.BlockJacobian(th.tt(diag), th.tt(oij), th.tt(oji))
    jj = jb.BlockJacobian(jnp.asarray(diag), jnp.asarray(oij),
                          jnp.asarray(oji))
    sel = tb.gather_offdiag(ts.mesh, tj)
    np.testing.assert_allclose(
        th.npy(tb.matvec(ts.mesh, tj, sel, th.tt(x))),
        np.asarray(jb.matvec(js.mesh, jj, jnp.asarray(x))), rtol=1e-13,
        atol=1e-13)
    dinv = tb.block_diag_inv(tj.diag)
    np.testing.assert_allclose(th.npy(dinv),
                               np.asarray(jb.block_jacobi_factor(jj)),
                               rtol=1e-13, atol=1e-13)
    got = tb.multicolor_sgs_apply(ts.mesh, sel, dinv, ts.colors, ts.ncolor,
                                  th.tt(x))
    want = jb.multicolor_sgs_apply(js.mesh, jj, jnp.asarray(th.npy(dinv)),
                                   masks, jnp.asarray(x))
    np.testing.assert_allclose(th.npy(got), np.asarray(want), rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("variant,prec", [
    ("isothermal", "LU_SGS"), ("isothermal", "JACOBI"),
    ("slip_heatflux_mass_flow", "LU_SGS")],
    ids=["lusgs", "jacobi", "slip_heatflux_mass_flow"])
def test_three_coupled_iterations_match_jax(tmp_path, variant, prec):
    """Three coupled iterations of the port's Simulation._step on the
    triangle channel against su2_tpu's jitted _make_rans_step with its
    fused edge mode on (fused_edge_flux_pallas in interpret mode): every
    output field at rtol 1e-9, atol 1e-12 max|field|
    (test_torch_slice's tolerance); the mixing layer reacts."""
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu_torch.convert import state_from_numpy
    text = th.with_prec(th.case_variant(th.write_case(tmp_path), variant),
                        prec)
    js, ts = th.tri_sims(text)
    assert js.mesh.stencil_offsets is None
    assert (ts.colors is None) == (prec == "JACOBI")
    ek.set_edge_kernel_mode(True)
    try:
        step = jax.jit(js._make_rans_step())
        j_state = (js.u0, js.t0) + tuple(js.initial_turb_state())
        t_state = state_from_numpy(*(np.asarray(x) for x in j_state))
        for _ in range(3):
            jo = step(*j_state, jnp.asarray(False))
            to = ts._step(*t_state)
            th.assert_fields_close(to, jo, 1e-9, 1e-12, NAMES)
            j_state, t_state = tuple(jo[:6]), tuple(to[:6])
    finally:
        ek.set_edge_kernel_mode(False)
    from su2_tpu_torch import state as st
    from su2_tpu_torch.solvers import euler as es
    lay = ts.lay
    v = st.node_state(ts.lib, lay, t_state[0], t_state[1], ts.tparams,
                      turb_ke=t_state[2][:, 0]).v
    om = es.chemistry_source_plain(ts.lib, ts.params, v[:, lay.T],
                                   v[:, lay.PRHO], v[:, lay.YS:],
                                   t_state[2][:, 1])
    assert float(om.abs().max()) > 1e-2


def test_cli_tri_two_iterations(tmp_path):
    """python -m su2_tpu_torch --cpu on the triangle channel written as
    .su2: exits 0 and writes 2 finite history rows."""
    from su2_tpu_torch import cases
    from su2_tpu_torch.io.mesh import write_su2_mesh
    write_su2_mesh(cases.tri_channel_mesh(17, 9), str(tmp_path / "tri.su2"))
    text = th.write_case(tmp_path / "lib", mesh_file="tri.su2")
    cfg = tmp_path / "case.cfg"
    cfg.write_text(text)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(cfg), "2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "history.dat") as f:
        rows = [ln for ln in f.read().splitlines()
                if ln and ln[0].isdigit()]
    assert len(rows) == 2 and "nan" not in " ".join(rows).lower()
