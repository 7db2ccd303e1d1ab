"""Implicit flow and laminar runs of su2_tpu_torch on meshes without a
static stencil, and the 3D weighted least squares there, against su2_tpu
in float64: on the 153-node scrambled triangle channel
(cases.tri_channel_mesh(17, 9)) the edge-list convective system (K11's
plain version against su2_tpu's ausm_flux_jac_pallas_t in interpret
mode), ns_assemble's implicit BlockJacobian (RANS and laminar), the
laminar edge-list spectral radius, LINELET's edge-form preconditioner and
coupled iterations of the implicit RANS step (LU_SGS, ILU0, JACOBI,
LINELET, BCGSTAB, dual time BDF2) and of the laminar steps; on the
180-node scrambled tet box (cases.tet_box_mesh(6, 6, 5)) the mesh, the 3D
gather WLS and the explicit RANS step, and the refusal of 3D implicit
flow; the port alone: IGNITION, CFL_ADAPT and the CLI's output on the
implicit triangle channel.  su2_tpu runs with its edge kernel mode on
(its Pallas kernels in interpret mode).  Tolerances: the system parts
|port - su2_tpu| <= 1e-10 |su2_tpu| + 1e-12 max|su2_tpu|, the steps 1e-9
|su2_tpu| + 1e-12 max|field| (BCGSTAB: its rounding floor, see
BCGSTAB_FLOOR); implicit and laminar checks start from th.mixed_state
(every species present, ROADMAP Queue 3 item 1)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

SYS_RTOL, SYS_ATOL = 1e-10, 1e-12
STEP_RTOL, STEP_ATOL = 1e-9, 1e-12
TET = (6, 6, 5)          # 180 nodes
NAMES = ("u", "t_guess", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
         "turb_rms", "nonphys", "min_dt")
# the composition of the implicit and laminar step checks' start state
# (th.mixed_state), as in tests/test_torch_laminar.py
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.write_case(tmp_path_factory.mktemp("tri_implicit"))


@pytest.fixture(scope="module")
def rans_systems(text):
    """(su2_tpu, port) Simulations of the implicit case (MUSCL +
    Venkatakrishnan, LU_SGS) on the triangle channel and both packages'
    implicit RANS systems (_systems)."""
    js, ts = th.tri_sims(th.with_implicit(text, prec="LU_SGS"))
    return js, ts, _systems(js, ts, False)


def tet_sims(text):
    """(su2_tpu, port) Simulations of the case on tet_box_mesh(*TET)'s
    markers."""
    import jax.numpy as jnp
    from su2_tpu.config import Config as JConfig
    from su2_tpu.driver import Simulation as JSimulation
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    t = cases.with_box_markers(text)
    raw = cases.tet_box_mesh(*TET)
    return (JSimulation(JConfig(text=t), dtype=jnp.float64,
                        raw_mesh=th.jax_raw(raw)),
            Simulation(Config(text=t), raw_mesh=raw, dtype=torch.float64,
                       device="cpu"))


@pytest.fixture(scope="module")
def tets(text):
    return tet_sims(text)


def close(got, want, names, rtol=SYS_RTOL, atol=SYS_ATOL):
    th.assert_fields_close(got, [np.asarray(w) for w in want], rtol, atol,
                           names)


# ----------------------------------------------------------------------
# the tet box and the 3D gather WLS

def test_tet_box_mesh(tets):
    """tet_box_mesh(6, 6, 5): 180 nodes, 909 edges, conformal (the dual
    volumes sum to the box's 1, every control volume closes, each marker's
    normals sum to its face's area vector as on box_mesh), no static
    stencil in either package, and su2_tpu's mesh arrays equal the port's
    exactly."""
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid
    from su2_tpu_torch.geometry.structured import box_mesh
    js, ts = tets
    jm, tm = js.mesh, ts.mesh
    assert (tm.npoint, tm.nedge) == (180, 909) == (jm.npoint, jm.nedge)
    assert jm.stencil_offsets is None and tm.stencil_offsets is None
    assert ts.perm is None
    g = ts.grid
    np.testing.assert_allclose(g.volume.sum(), 1.0, rtol=1e-13)
    assert (g.volume > 0).all()
    acc = np.zeros((g.npoint, 3))
    np.add.at(acc, g.edges[:, 0], g.edge_normal)
    np.add.at(acc, g.edges[:, 1], -g.edge_normal)
    for t in g.bnd_nodes:
        np.add.at(acc, g.bnd_nodes[t], -g.bnd_normal[t])
    assert np.abs(acc).max() < 1e-15
    hexes = build_dual_grid(box_mesh(*TET))
    for t in hexes.bnd_nodes:
        np.testing.assert_allclose(g.bnd_normal[t].sum(0),
                                   hexes.bnd_normal[t].sum(0), atol=1e-14)
    for k in ("coords", "volume", "edges", "edge_normal", "node_nbrs",
              "nbr_mask", "node_edges_sel", "bnd_accum_normal"):
        np.testing.assert_array_equal(th.npy(getattr(tm, k)),
                                      np.asarray(getattr(jm, k)), err_msg=k)


def test_wls_3d_matches_jax(tets):
    """The 3D gather WLS (normal equations, adjugate inverse) of a smooth
    field plus noise against su2_tpu's _wls_3d: rtol 1e-12, atol 1e-12 of
    the gradient's max; a node whose neighbours all lie on a line (det ~
    0) gets the gradient 0 in both."""
    from su2_tpu.ops import gradients as jg
    from su2_tpu_torch.ops import gradients as tg
    js, ts = tets
    x = th.npy(ts.mesh.coords)
    rng = np.random.default_rng(4)
    q = np.stack([np.sin(3 * x[:, 0]) + x[:, 1] ** 2 - x[:, 2],
                  np.exp(x[:, 0] * x[:, 1] * x[:, 2]),
                  x[:, 0] - 2 * x[:, 1] + 3 * x[:, 2]], 1) \
        + 1e-3 * rng.standard_normal((x.shape[0], 3))
    got = tg.weighted_least_squares(ts.mesh, th.tt(q))
    want = np.asarray(jg.weighted_least_squares(js.mesh, jnp.asarray(q)))
    np.testing.assert_allclose(th.npy(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # the exact gradient of the linear field
    np.testing.assert_allclose(
        th.npy(tg.weighted_least_squares(ts.mesh, th.tt(x @ [1.0, -2.0,
                                                              3.0])[:, None])
               )[:, 0], np.broadcast_to([1.0, -2.0, 3.0], x.shape),
        atol=1e-12)
    # node 0 with its neighbours moved onto the x axis through it
    import dataclasses
    nb = th.npy(ts.mesh.node_nbrs[0])
    xs = x.copy()
    xs[nb[nb != 0]] = xs[0] + np.outer(np.arange(1, (nb != 0).sum() + 1),
                                       [0.1, 0.0, 0.0])
    m1 = dataclasses.replace(ts.mesh, coords=th.tt(xs))
    m0 = dataclasses.replace(js.mesh, coords=jnp.asarray(xs))
    g1 = th.npy(tg.weighted_least_squares(m1, th.tt(q)))
    g0 = np.asarray(jg.weighted_least_squares(m0, jnp.asarray(q)))
    assert (g1[0] == 0.0).all() and (g0[0] == 0.0).all()
    np.testing.assert_allclose(g1, g0, rtol=1e-12,
                               atol=1e-12 * np.abs(g0).max())


def test_implicit_3d_tet_box_raises(text):
    """3D implicit flow on the tet box is still refused before any step,
    naming the su2_tpu module with the 3D viscous Jacobians."""
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    t = th.with_implicit(cases.with_box_markers(text), prec="LU_SGS")
    with pytest.raises(NotImplementedError,
                       match=r"su2_tpu\.ops\.viscous_t"):
        Simulation(Config(text=t), raw_mesh=cases.tet_box_mesh(3, 3, 3),
                   dtype=torch.float64, device="cpu")


# ----------------------------------------------------------------------
# the implicit system over the edge list

def _fields(js, ts, u):
    """The node fields both packages' assemblies read, from the port's
    node state of u (numpy): v, the NS gradient set, the limiter, dP/dU;
    (torch tensors, jax arrays)."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    nsd = st.node_state(lib, lay, th.tt(u), ts.t0, ts.tparams)
    v = nsd.v
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(
        lib, lay, v, xs=nsd.xs))
    lim = limiters.venkatakrishnan(mesh, es.gradient_vars(lay, v),
                                   grad[:, :2 + lay.ndim],
                                   prm.limiter_coeff, prm.ref_elem_length)
    tf = (v, grad, lim, nsd.dpdu)
    return tf, tuple(jnp.asarray(th.npy(x)) for x in tf)


ORDERS = {"first_order": (False, None), "muscl": (True, None),
          "muscl_venkatakrishnan": (True, "VENKATAKRISHNAN")}


@pytest.mark.parametrize("order", list(ORDERS))
def test_convective_system_matches_jax(text, order):
    """euler.convective_system (the edge-list system: K11's plain version
    between the endpoint rows or the MUSCL face states) against su2_tpu's
    with ausm_flux_jac_pallas_t in interpret mode: res, diag, off_ij and
    off_ji (edge-major)."""
    import dataclasses
    from su2_tpu.pallas import edge_kernels as jek
    from su2_tpu.solvers import euler as jes
    from su2_tpu_torch.solvers import euler as es
    muscl, limiter = ORDERS[order]
    js, ts = th.tri_sims(th.with_implicit(text, muscl=muscl,
                                          limiter=limiter))
    assert ts.params.muscl == muscl
    assert ts.params.use_limiter == (limiter is not None)
    (v, grad, lim, dpdu), (jv, jgrad, jlim, jdpdu) = _fields(
        js, ts, th.mixed_state(ts, seed=3))
    nd = ts.lay.ndim
    jlim = jlim if ts.params.use_limiter else jnp.ones_like(jlim)
    jek.set_edge_kernel_mode(True)
    try:
        jres, jjac = jes.convective_system(js.lib, js.lay, js.mesh,
                                           js.params, jv, jgrad[:, :2 + nd],
                                           jlim, jdpdu)
    finally:
        jek.set_edge_kernel_mode(False)
    res, jac = es.convective_system(ts.lib, ts.lay, ts.mesh, ts.params, v,
                                    grad, lim if ts.params.use_limiter
                                    else None, dpdu)
    close([res] + [getattr(jac, f.name) for f in dataclasses.fields(jac)],
          [jres] + [getattr(jjac, f) for f in ("diag", "off_ij", "off_ji")],
          ("res", "diag", "off_ij", "off_ji"))


def _systems(js, ts, laminar, seed=7):
    """Both packages' implicit ns_assemble on one perturbed mixed state
    with random SST fields (RANS) and a random local time step."""
    from su2_tpu import state as jst
    from su2_tpu.ops import viscous as jvis
    from su2_tpu.pallas import edge_kernels as jek
    from su2_tpu.solvers import ns as jns
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import ns
    n, nd = ts.mesh.npoint, ts.lay.ndim
    rng = np.random.default_rng(seed)
    s = dict(u=th.mixed_state(ts, seed=seed), t=th.npy(ts.t0),
             dt=rng.uniform(0.5, 1.5, n) * 1e-5)
    if not laminar:
        q = th.npy(ts.initial_turb_state()[0])
        s.update(tke=q[:, 0] * rng.uniform(0.5, 1.5, n),
                 mu_t=rng.uniform(1e-5, 1e-3, n),
                 grad_tke=rng.normal(0.0, 1e-1, (n, nd)),
                 sigma_k=rng.uniform(0.85, 1.0, n),
                 omega_t=q[:, 1] * rng.uniform(0.5, 1.5, n))
    out = []
    for mod, conv, fstate, tfd, sim in (
            (jns, jnp.asarray, jst, jvis.TurbFlowData, js),
            (ns, th.tt, st, vis.TurbFlowData, ts)):
        c = {k: conv(x) for k, x in s.items()}
        nsd = fstate.node_state(sim.lib, sim.lay, c["u"], c["t"],
                                sim.tparams,
                                turb_ke=None if laminar else c["tke"])
        turb = None if laminar else tfd(
            tke=c["tke"], mu_t=c["mu_t"], grad_tke=c["grad_tke"],
            sigma_k=c["sigma_k"])
        omega = None if laminar else c["omega_t"]
        if sim is js:
            def assemble(nsd, dt, turb, omega):
                return jns.ns_assemble(
                    js.lib, js.lay, js.mesh, js.params, js.bcs, nsd.v, dt,
                    implicit=True, turb=turb, omega_turb=omega,
                    sigma_k_edge=None if laminar
                    else turb.sigma_k[js.mesh.edges[:, 0]], nsd=nsd)

            jek.set_edge_kernel_mode(True)
            try:
                res, wm, _, _, jac = jax.jit(assemble)(nsd, c["dt"], turb,
                                                       omega)
            finally:
                jek.set_edge_kernel_mode(False)
        else:
            res, wm, _, _, jac, _ = ns.ns_assemble(
                ts.lib, ts.lay, ts.mesh, ts.params, ts.bcs, nsd.v, nsd,
                turb, omega, dt=c["dt"])
        out.append((res, wm, jac))
    return out


@pytest.mark.parametrize("laminar", [False, True], ids=["rans", "laminar"])
def test_ns_assemble_edge_list_matches_jax(text, rans_systems, laminar):
    """ns_assemble's implicit system on the triangle channel (MUSCL +
    Venkatakrishnan): the edge-list convective system, the edge viscous
    flux and Jacobians, the boundary, source and wall Jacobians, the wall
    rows of the edge-major blocks and the time diagonal, as a
    BlockJacobian: res, diag, off_ij and off_ji, and the wall mask
    exactly, RANS (with the SST coupling) and laminar."""
    from su2_tpu_torch.linalg.blockcsr import BlockJacobian
    if laminar:
        js, ts = th.tri_sims(th.cases.with_laminar(
            th.with_implicit(text, prec="LU_SGS")))
        (jres, jwm, jjac), (res, wm, jac) = _systems(js, ts, True)
    else:
        (jres, jwm, jjac), (res, wm, jac) = rans_systems[2]
    assert isinstance(jac, BlockJacobian)
    np.testing.assert_array_equal(th.npy(wm), np.asarray(jwm))
    assert np.asarray(jwm).any()
    close([res, jac.diag, jac.off_ij, jac.off_ji],
          [jres, jjac.diag, jjac.off_ij, jjac.off_ji],
          ("res", "diag", "off_ij", "off_ji"))


def test_viscous_lambda_laminar_edge_list_matches_jax(text):
    """The laminar viscous spectral radius over the edge list (lam2 =
    kappa/Cv with the edge mean of Cp/gamma, gamma of node i) with the
    boundary vertices, against su2_tpu's viscous_lambda with turb None."""
    from su2_tpu import state as jst
    from su2_tpu.ops import viscous as jvis
    from su2_tpu.solvers import ns as jns
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import ns
    js, ts = th.tri_sims(th.cases.with_laminar(text))
    assert ts.mesh.fam_offsets is None and not ts.turbulent
    u = th.mixed_state(ts, seed=5)
    nsd = st.node_state(ts.lib, ts.lay, th.tt(u), ts.t0, ts.tparams)
    jnsd = jst.node_state(js.lib, js.lay, jnp.asarray(u), js.t0,
                          js.tparams)
    got = ns.viscous_lambda(ts.lib, ts.mesh, ts.lay, ts.params, nsd.v,
                            vis.Transport(nsd.mu, nsd.kappa), nsd.dpdu,
                            None)
    want = jns.viscous_lambda(js.lib, js.mesh, js.lay, js.params, jnsd.v,
                              jvis.Transport(mu=jnsd.mu, kappa=jnsd.kappa,
                                             dij=None),
                              jnsd.dpdu, None)
    close([got], [want], ["lam_visc"])


def test_linelet_block_jacobian_matches_jax(rans_systems):
    """LINELET on the implicit case's BlockJacobian of the triangle
    channel: make_solver_ops' preconditioner with the edge list's lines
    (line_maps family=False; the line Thomas solve over the edge-major
    blocks) and its matvec match su2_tpu's make_solver_ops with the same
    lines (family=False) at rtol 1e-12; the preconditioner differs from
    the multicolor sweep of LU_SGS; a stencil system's lines are
    refused."""
    from su2_tpu.linalg import blockcsr as jb, linelet as jll
    from su2_tpu_torch.linalg import blockcsr as tb, linelet
    js, ts, ((_, _, jjac), (_, _, jac)) = rans_systems
    lines = linelet.build_linelets(ts.mesh, ts.bcs)
    assert np.array_equal(lines, jll.build_linelets(js.mesh, bcs=js.bcs))
    assert lines.shape[1] > 2
    maps = linelet.line_maps(ts.mesh, lines, family=False)
    ops = tb.make_solver_ops(ts.mesh, jac, "LINELET", ts.colors, ts.ncolor,
                             lines=maps)
    masks = tuple(jnp.asarray(th.npy(ts.colors) == c)
                  for c in range(ts.ncolor))
    jops = jb.make_solver_ops(js.mesh, jjac, "LINELET", masks,
                              linelets=lines)
    r = np.random.default_rng(3).normal(0.0, 1.0, (ts.mesh.npoint, 13))
    for f, jf, name in ((ops[0], jops[0], "matvec"),
                        (ops[1], jops[1], "linelet")):
        want = np.asarray(jf(jnp.asarray(r)))
        np.testing.assert_allclose(th.npy(f(th.tt(r))), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)
    sgs = tb.make_solver_ops(ts.mesh, jac, "LU_SGS", ts.colors, ts.ncolor)
    z, zs = th.npy(ops[1](th.tt(r))), th.npy(sgs[1](th.tt(r)))
    assert np.abs(z - zs).max() > 1e-3 * np.abs(zs).max()
    import dataclasses
    with pytest.raises(ValueError, match="family"):
        tb.make_solver_ops(ts.mesh, jac, "LINELET", ts.colors, ts.ncolor,
                           lines=dataclasses.replace(maps, family=True))


# ----------------------------------------------------------------------
# coupled iterations

def coupled(js, ts, u, niter=3, rtol=STEP_RTOL):
    """niter iterations of su2_tpu's jitted RANS step (edge kernel mode on)
    and the port's Simulation._step from the state u (numpy): every field
    within rtol, STEP_ATOL max|field|."""
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu_torch.convert import state_from_numpy
    assert ts.mesh.stencil_offsets is None
    assert js.mesh.stencil_offsets is None
    j_state = (jnp.asarray(u), js.t0) + tuple(js.initial_turb_state())
    t_state = state_from_numpy(*(np.asarray(x) for x in j_state))
    ek.set_edge_kernel_mode(True)
    try:
        step = jax.jit(js._make_rans_step())
        for _ in range(niter):
            jo = step(*j_state, jnp.asarray(False))
            to = ts._step(*t_state)
            th.assert_fields_close(to, jo, rtol, STEP_ATOL, NAMES)
            j_state, t_state = tuple(jo[:6]), tuple(to[:6])
    finally:
        ek.set_edge_kernel_mode(False)
    return t_state


@pytest.mark.parametrize("prec", ["LU_SGS", "JACOBI", "LINELET"])
def test_implicit_rans_steps_match_jax(text, prec):
    """Three coupled iterations of the implicit RANS step (MUSCL +
    Venkatakrishnan) on the triangle channel from th.mixed_state: the
    BlockJacobian solved by FGMRES with the multicolor sweep (LU_SGS),
    JACOBI or the lines along the walls (LINELET)."""
    js, ts = th.tri_sims(th.with_implicit(text, prec=prec))
    if prec == "LINELET":
        assert ts.lines is not None and not ts.lines.family
    coupled(js, ts, th.mixed_state(ts, ys=MIXED_YS))


def test_implicit_ilu0_steps_equal_lusgs(text):
    """ILU0 runs the multicolor sweep of LU_SGS, as su2_tpu maps it (and
    LINELET without lines): three implicit RANS iterations on the triangle
    channel with ILU0 equal those with LU_SGS bit for bit, which
    test_implicit_rans_steps_match_jax holds against su2_tpu."""
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch import cases
    out = []
    for prec in ("ILU0", "LU_SGS"):
        ts = Simulation(Config(text=th.with_implicit(text, prec=prec)),
                        raw_mesh=cases.tri_channel_mesh(*th.CHANNEL),
                        dtype=torch.float64, device="cpu")
        state = (th.tt(th.mixed_state(ts, ys=MIXED_YS)), ts.t0) \
            + tuple(ts.initial_turb_state())
        for _ in range(3):
            state = ts._step(*state)[:6]
        out.append(state)
    for a, b in zip(*out):
        assert torch.equal(a, b)


# BCGSTAB on the triangle channel's flow system is at the mercy of
# rounding: a 1e-15 relative change of the Jacobian's diagonal moves the
# solution of its 10 BCGSTAB iterations by ~1e-6 of its largest entry
# (FGMRES's by ~1e-12), the state after one step by ~1e-9 of its largest
# entry and after three by ~3e-7; no two implementations agree within
# STEP_RTOL there.  The test holds the port against su2_tpu within
# BCGSTAB_FLOOR times that floor, measured in the test.
BCGSTAB_FLOOR = 10.0


def test_implicit_bcgstab_steps_match_jax(text, monkeypatch):
    """Three coupled iterations of the implicit LU_SGS case with
    LINEAR_SOLVER= BCGSTAB (the flow's BlockJacobian and the SST's system)
    on the triangle channel from th.mixed_state: per iteration and field,
    max|port - su2_tpu| within BCGSTAB_FLOOR times max|port - port'|, port'
    the port's own iterations with every flow Jacobian's diagonal scaled
    by 1 + 1e-15 x noise (or within STEP_RTOL, STEP_ATOL where that is
    wider); the floor of u exceeds STEP_RTOL max|u| (the stricter check
    cannot hold)."""
    import dataclasses
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu_torch.convert import state_from_numpy
    from su2_tpu_torch.solvers import ns
    t = th.with_lines(th.with_implicit(text, prec="LU_SGS"),
                      LINEAR_SOLVER="BCGSTAB")
    js, ts = th.tri_sims(t)
    u = th.mixed_state(ts, ys=MIXED_YS)
    j_state = (jnp.asarray(u), js.t0) + tuple(js.initial_turb_state())
    ek.set_edge_kernel_mode(True)
    try:
        step = jax.jit(js._make_rans_step())
        want = []
        for _ in range(3):
            jo = step(*j_state, jnp.asarray(False))
            want.append([np.asarray(x) for x in jo])
            j_state = tuple(jo[:6])
    finally:
        ek.set_edge_kernel_mode(False)

    def port_run():
        state = state_from_numpy(*(np.asarray(x) for x in
                                   (u, js.t0) + tuple(
                                       js.initial_turb_state())))
        out = []
        for _ in range(3):
            to = ts._step(*state)
            out.append([th.npy(x) for x in to])
            state = tuple(to[:6])
        return out

    got = port_run()
    gen = torch.Generator().manual_seed(0)
    assemble = ns.ns_assemble

    def perturbed(*a, **k):
        out = assemble(*a, **k)
        jac = out[4]
        noise = torch.randn(jac.diag.shape, generator=gen,
                            dtype=jac.diag.dtype)
        return out[:4] + (dataclasses.replace(
            jac, diag=jac.diag * (1.0 + 1e-15 * noise)),) + out[5:]

    monkeypatch.setattr(ns, "ns_assemble", perturbed)
    moved = port_run()
    for it in range(3):
        for name, g, w, m in zip(NAMES, got[it], want[it], moved[it]):
            scale = np.abs(w).max()
            floor = np.abs(g - m).max()
            bound = max(BCGSTAB_FLOOR * floor,
                        STEP_RTOL * scale + STEP_ATOL * scale)
            assert np.abs(g - w).max() <= bound, (it, name)
            if name == "u":
                assert floor > STEP_RTOL * scale, it


def test_dual_time_bdf2_implicit_matches_jax(text):
    """Dual time BDF2 with the implicit LU_SGS step on the triangle
    channel: run_unsteady of both packages, 2 physical steps of 2 inner
    iterations from th.mixed_state: the state, the per-step history and
    the turbulence state."""
    from su2_tpu.pallas import edge_kernels as ek
    t = th.with_lines(th.with_implicit(text, prec="LU_SGS"),
                      UNSTEADY_SIMULATION="DUAL_TIME_STEPPING-2ND_ORDER",
                      UNST_TIMESTEP="2e-5", UNST_INT_ITER="2")
    js, ts = th.tri_sims(t)
    u = th.mixed_state(ts, ys=MIXED_YS)
    js.u0, ts.u0 = jnp.asarray(u), th.tt(u)
    ek.set_edge_kernel_mode(True)
    try:
        want = js.run_unsteady(2, quiet=True)
    finally:
        ek.set_edge_kernel_mode(False)
    got = ts.run_unsteady(2, quiet=True)
    close(got[:3], want[:3], ("u", "t", "hist"), STEP_RTOL, STEP_ATOL)
    close(got[3], want[3], ("q", "mu_t", "grad_k", "sigma_k"), STEP_RTOL,
          STEP_ATOL)


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_laminar_run_matches_jax(text, implicit):
    """Simulation.run(3) of the laminar case (KIND_TURB_MODEL= NONE) on
    the triangle channel, both packages: explicit (edge_list_interior, the
    edge-list spectral radii, T4 without PaSR) from a perturbed mixed
    state, and implicit (MUSCL + Venkatakrishnan, JACOBI: the edge-list
    system with turb None) from th.mixed_state's uniform one; u, T and
    the RMS residual history (10**hist: the implicit start's y-momentum
    residual is rounding noise, ~1e-13, whose log10 no two
    implementations share)."""
    from su2_tpu.pallas import edge_kernels as ek
    t = th.cases.with_laminar(text)
    if implicit:
        t = th.with_implicit(t, prec="JACOBI")
    js, ts = th.tri_sims(t)
    assert not ts.turbulent and ts.mesh.stencil_offsets is None
    u = (th.mixed_state(ts, ys=MIXED_YS) if implicit
         else th.mixed_state(ts, seed=4))
    js.u0, ts.u0 = jnp.asarray(u), th.tt(u)
    ek.set_edge_kernel_mode(True)
    try:
        want = js.run(3, quiet=True)
    finally:
        ek.set_edge_kernel_mode(False)
    got = ts.run(3, quiet=True)
    close(got[:2] + (10.0 ** got[2],),
          tuple(want[:2]) + (10.0 ** np.asarray(want[2]),),
          ("u", "t_guess", "rms"), STEP_RTOL, STEP_ATOL)


def test_tet_box_explicit_rans_matches_jax(tets):
    """Three coupled iterations of the explicit RANS step (LU_SGS for the
    SST) on the tet box from a perturbed mixed state: the 3D gather WLS,
    K13's plain version at (3, 9) against su2_tpu's
    fused_edge_flux_pallas in interpret mode, the edge-list spectral
    radii, slip walls and the SST's gather solve."""
    js, ts = tets
    assert ts.lay.ndim == 3 and ts.colors is not None
    coupled(js, ts, th.mixed_state(ts, seed=6))


# ----------------------------------------------------------------------
# the run loop's options on the implicit triangle channel (the port)

def test_implicit_ignition_and_cfl_adapt_on_triangles(text):
    """The implicit LU_SGS step on the triangle channel under the run
    loop's options: IGNITION (a window of 2 iterations) run(4, chunk=3)
    equals the per-iteration run(4, chunk=1) bit for bit; CFL_ADAPT
    moves the CFL within CFL_ADAPT_PARAM's bounds over 3 finite
    iterations."""
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation

    def sim(t):
        return Simulation(Config(text=t),
                          raw_mesh=cases.tri_channel_mesh(*th.CHANNEL),
                          dtype=torch.float64, device="cpu")

    t = th.with_implicit(text, prec="LU_SGS")
    itext = th.with_lines(t, IGNITION="YES", IGNITION_ITER=2,
                          IGNITION_TEMPERATURE=1700.0, FUEL_INDEX=0,
                          OXIDIZER_INDEX=2)
    u = th.tt(th.mixed_state(sim(itext), ys=(0.45, 0.05, 0.3, 0.04, 0.08,
                                              0.02, 0.02, 0.02, 0.02)))
    a = sim(itext).run(4, u=u, quiet=True, chunk=3)
    b = sim(itext).run(4, u=u, quiet=True, chunk=1)
    assert torch.equal(a[0], b[0]) and np.array_equal(a[2], b[2])
    plain = sim(t).run(4, u=u, quiet=True)
    assert not torch.equal(a[0], plain[0])
    atext = th.with_lines(t, CFL_ADAPT="YES",
                          CFL_ADAPT_PARAM="( 1.5, 0.5, 0.5, 1.5 )")
    s = sim(atext)
    out = s.run(3, u=u, quiet=True)
    assert np.isfinite(out[2]).all() and torch.isfinite(out[0]).all()
    assert s.cfl_now != s.cfg.cfl_number and 0.5 < s.cfl_now < 1.5


def test_cli_tri_implicit_writes_output(text, tmp_path):
    """python -m su2_tpu_torch --cpu with the implicit LU_SGS case on the
    triangle channel written as .su2, both walls monitored: exits 0 and
    writes 2 finite history rows, the restart and
    forces_breakdown.dat."""
    import os
    import subprocess
    import sys
    from su2_tpu_torch import cases
    from su2_tpu_torch.io.mesh import write_su2_mesh
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    write_su2_mesh(cases.tri_channel_mesh(*th.CHANNEL),
                   str(tmp_path / "tri.su2"))
    t = th.with_lines(th.with_implicit(th.write_case(
        tmp_path / "lib", mesh_file="tri.su2"), prec="LU_SGS"),
        MARKER_MONITORING="( lower_wall, upper_wall )")
    (tmp_path / "case.cfg").write_text(t)
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(tmp_path / "case.cfg"), "2"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = [ln for ln in (tmp_path / "history.dat").read_text().splitlines()
            if ln and ln[0].isdigit()]
    assert len(rows) == 2 and "nan" not in " ".join(rows).lower()
    assert (tmp_path / "restart_flow.dat").exists()
    assert (tmp_path / "forces_breakdown.dat").exists()
