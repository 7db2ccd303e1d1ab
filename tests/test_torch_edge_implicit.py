"""The implicit edge terms of su2_tpu_torch (the plain version of kernel
K10, ops/edge_implicit.py) and the modules under them against su2_tpu:
fused_edge_implicit_pallas in interpret mode, fused_implicit_family_terms,
the Jacobian branches of ausm_t/viscous_t against their node-major twins,
the limiters, ghost_dpdu, euler_wall_jacobian and source_jacobian; on the
153-node synthetic channel with the state perturbed by 2 %."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

# (muscl, limiter) variants: the cfg spellings of cases.with_implicit_flow
VARIANTS = {"first_order": (False, None), "muscl": (True, None),
            "venkatakrishnan": (True, "VENKATAKRISHNAN"),
            "barth_jespersen": (True, "BARTH_JESPERSEN")}


def _state(js, ts, seed=7):
    """A perturbed, mixed, reacting state and random SST fields (numpy)."""
    n, lay = js.mesh.npoint, js.lay
    rng = np.random.default_rng(seed)
    q = np.asarray(js.initial_turb_state()[0])
    return dict(u=th.mixed_state(ts, seed=seed), t_guess=np.asarray(js.t0),
                tke=q[:, 0] * rng.uniform(0.5, 1.5, n),
                mu_t=rng.uniform(1e-5, 1e-3, n),
                grad_tke=rng.normal(0.0, 1e-1, (n, lay.ndim)),
                sigma_k=rng.uniform(0.85, 1.0, n))


def _jax_fields(js, s):
    """JAX node fields of the state: v, grad, lim, dP/dU, dT/dU, transport
    and SST data (numpy dict) for the case's limiter."""
    from su2_tpu import state as st
    from su2_tpu.ops import limiters, viscous as vis
    from su2_tpu.solvers import euler as es
    lib, lay, mesh, prm = js.lib, js.lay, js.mesh, js.params
    _, v, _ = st.cons2prim(lib, lay, jnp.asarray(s["u"]),
                           jnp.asarray(s["t_guess"]), js.tparams,
                           turb_ke=jnp.asarray(s["tke"]))
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(lib, lay, v))
    qlim = es.gradient_vars(lay, v)
    glim = grad[:, :2 + lay.ndim, :]
    lim = None
    if prm.use_limiter:
        lim = (limiters.barth_jespersen(mesh, qlim, glim)
               if prm.limiter_kind == "BARTH_JESPERSEN" else
               limiters.venkatakrishnan(mesh, qlim, glim, prm.limiter_coeff,
                                        prm.ref_elem_length))
    trans = vis.node_transport(lib, lay, v)
    out = dict(v=v, grad=grad, lim=lim, dpdu=st.dpdu(lib, lay, v),
               dtdu=st.dtdu(lib, lay, v), mu=trans.mu, kappa=trans.kappa,
               qlim=qlim, glim=glim)
    return {k: (None if x is None else np.asarray(x)) for k, x in out.items()}


_CASES = {}


def _make_case(variant, tmp_factory):
    """(js, ts, state, JAX node fields) of a variant, built once."""
    if variant not in _CASES:
        muscl, limiter = VARIANTS[variant]
        text = th.with_implicit(th.write_case(tmp_factory.mktemp("imp")),
                                muscl=muscl, limiter=limiter)
        js, ts = th.jax_sim(text), th.torch_sim(text)
        s = _state(js, ts)
        _CASES[variant] = (js, ts, s, _jax_fields(js, s))
    return _CASES[variant]


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request, tmp_path_factory):
    return _make_case(request.param, tmp_path_factory)


def _jax_family(js, s, f):
    """JAX fused_implicit_family_terms and its per-family kernel outputs."""
    from su2_tpu.ops import viscous as vis
    from su2_tpu.pallas import edge_fused as ef
    from su2_tpu.ops import viscous_t
    lib, lay, mesh, prm = js.lib, js.lay, js.mesh, js.params
    turb = vis.TurbFlowData(tke=jnp.asarray(s["tke"]),
                            mu_t=jnp.asarray(s["mu_t"]),
                            grad_tke=jnp.asarray(s["grad_tke"]),
                            sigma_k=jnp.asarray(s["sigma_k"]))
    trans = vis.Transport(mu=jnp.asarray(f["mu"]),
                          kappa=jnp.asarray(f["kappa"]), dij=None)
    j = lambda k: None if f[k] is None else jnp.asarray(f[k])
    terms = ef.fused_implicit_family_terms(
        lib, lay, mesh, prm, j("v"), j("grad"), j("lim"), j("dpdu"),
        j("dtdu"), trans, turb, turb.sigma_k)
    # the kernel on each family, as fused_implicit_family_terms calls it
    n = mesh.npoint
    lim = j("lim") if f["lim"] is not None else jnp.ones((n, 2 + lay.ndim))
    f_all = jnp.concatenate([
        j("v"), j("grad").reshape(n, -1), lim, trans.mu[:, None],
        trans.kappa[:, None], turb.mu_t[:, None], turb.tke[:, None],
        turb.grad_tke, turb.sigma_k[:, None], j("dtdu"), j("dpdu")],
        axis=1).T
    sc = viscous_t.species_consts(np.asarray(lib.mm),
                                  np.asarray(lib.diff_vol), jnp.float64)
    kargs = (lay, prm.m_infty, prm.prandtl_turb, prm.lewis_turb,
             bool(prm.muscl), bool(prm.use_limiter),
             (float(lib.t0), float(lib.dt), int(lib.nt)), sc)
    tabs = (ef._hcp_tables(lib, jnp.float64),
            jnp.asarray(lib.mm)[:, None], jnp.asarray(lib.ri)[:, None])
    fam = []
    for k, o in enumerate(mesh.fam_offsets):
        fam.append([np.asarray(x) for x in ef.fused_edge_implicit_pallas(
            *kargs, f_all, jnp.roll(f_all, -o, axis=1),
            mesh.fam_normal[k].T, mesh.fam_evec[k].T, *tabs)])
    return [np.asarray(x) for x in terms], fam, np.asarray(f_all)


def _port_inputs(ts, s, f):
    from su2_tpu_torch.ops import edge_implicit as ei, viscous as vis
    t = lambda k: None if f[k] is None else th.tt(f[k])
    turb = vis.TurbFlowData(tke=th.tt(s["tke"]), mu_t=th.tt(s["mu_t"]),
                            grad_tke=th.tt(s["grad_tke"]),
                            sigma_k=th.tt(s["sigma_k"]))
    trans = vis.Transport(mu=t("mu"), kappa=t("kappa"))
    return turb, trans, ei.stack_inputs(ts.lay, t("v"), t("grad"), t("lim"),
                                        trans, turb, turb.sigma_k, t("dtdu"),
                                        t("dpdu"))


def test_k10_plain_matches_fused_edge_implicit_pallas(case):
    """flux, j_i and j_j of every family to 1e-11 x max|output|, and the
    padded slots (zero normal) exactly 0."""
    from su2_tpu_torch.ops import edge_flux, edge_implicit as ei
    js, ts, s, f = case
    _, fam, f_all_j = _jax_family(js, s, f)
    _, _, f_all = _port_inputs(ts, s, f)
    np.testing.assert_array_equal(th.npy(f_all), f_all_j)
    prm, mesh = ts.params, ts.mesh
    flux, j_i, j_j = ei.edge_implicit_plain(
        ts.lib, ts.lay, edge_flux.species_consts_of(ts.lib),
        (prm.m_infty, prm.prandtl_turb, prm.lewis_turb), f_all,
        mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec, prm.muscl,
        prm.use_limiter)
    assert len(fam) == len(mesh.fam_offsets) == 2
    for k, want in enumerate(fam):
        pad = th.npy((mesh.fam_normal[k] == 0).all(-1))
        assert pad.any()
        for name, got, w in zip(("flux", "j_i", "j_j"),
                                (flux[k], j_i[k], j_j[k]), want):
            g = th.npy(got)
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g, w, rtol=0.0,
                                       atol=1e-11 * np.abs(w).max(),
                                       err_msg=f"{name} family {k}")
            assert (g[:, pad] == 0.0).all(), f"{name} pad slots"


@pytest.mark.parametrize("ns", [3, 5])
def test_k10_plain_matches_pallas_at_other_species_counts(tmp_path, ns):
    """K10's plain version at a cut of the case's library to its first ns
    species (cases.shape_inputs: a random reacting state, MUSCL with a
    random limiter) against fused_edge_implicit_pallas in interpret mode on
    every family: flux, j_i and j_j to 1e-11 x max|output|, the pad slots
    exactly 0.  On the card K10 runs 3 species through a compiled
    instance and 5 through its run-time-count one."""
    from types import SimpleNamespace
    from su2_tpu.ops import viscous_t
    from su2_tpu.pallas import edge_fused as ef
    from su2_tpu.state import Layout as JLayout
    from su2_tpu_torch.ops import edge_implicit as ei
    mesh, args = th.implicit_shape_inputs(ns, tmp_path)
    lib, lay, _, consts, f_all = args[:5]
    flux, j_i, j_j = ei.edge_implicit_plain(*args)
    f = th.npy(f_all)
    npl = lambda x: th.npy(x)
    jlib = SimpleNamespace(**{k: jnp.asarray(npl(getattr(lib, k))) for k in
                              ("h_y", "h_y2", "cp_y", "cp_y2")})
    sc = viscous_t.species_consts(npl(lib.mm), npl(lib.diff_vol),
                                  jnp.float64)
    kargs = (JLayout(2, ns), *consts, True, True,
             (float(lib.t0), float(lib.dt), int(lib.nt)), sc)
    tabs = (ef._hcp_tables(jlib, jnp.float64), jnp.asarray(npl(lib.mm))[:, None],
            jnp.asarray(npl(lib.ri))[:, None])
    for k, o in enumerate(mesh.fam_offsets):
        want = ef.fused_edge_implicit_pallas(
            *kargs, jnp.asarray(f), jnp.asarray(np.roll(f, -o, axis=1)),
            jnp.asarray(npl(mesh.fam_normal[k]).T),
            jnp.asarray(npl(mesh.fam_evec[k]).T), *tabs)
        pad = th.npy((mesh.fam_normal[k] == 0).all(-1))
        assert pad.any()
        for name, got, w in zip(("flux", "j_i", "j_j"),
                                (flux[k], j_i[k], j_j[k]), want):
            g, w = th.npy(got), np.asarray(w)
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g, w, rtol=0.0,
                                       atol=1e-11 * np.abs(w).max(),
                                       err_msg=f"{name} family {k}")
            assert (g[:, pad] == 0.0).all(), f"{name} pad slots"


def test_family_terms_match_jax(case):
    """res, diag and sel_t of fused_implicit_family_terms to 1e-10 x max,
    from node-major gradients and from the same gradients as feature-major
    rows (the >= 200k-node tier's input; the JAX package reads them in the
    same order)."""
    from su2_tpu.ops import viscous as vis
    from su2_tpu.pallas import edge_fused as ef
    from su2_tpu_torch.ops import edge_implicit as ei
    js, ts, s, f = case
    want, _, _ = _jax_family(js, s, f)
    turb, trans, _ = _port_inputs(ts, s, f)
    t = lambda k: None if f[k] is None else th.tt(f[k])
    n = ts.mesh.npoint
    rows = th.tt(f["grad"].reshape(n, -1).T)
    jturb = vis.TurbFlowData(tke=jnp.asarray(s["tke"]),
                             mu_t=jnp.asarray(s["mu_t"]),
                             grad_tke=jnp.asarray(s["grad_tke"]),
                             sigma_k=jnp.asarray(s["sigma_k"]))
    j = lambda k: None if f[k] is None else jnp.asarray(f[k])
    want_rows = ef.fused_implicit_family_terms(
        js.lib, js.lay, js.mesh, js.params, j("v"), None, j("lim"),
        j("dpdu"), j("dtdu"),
        vis.Transport(mu=j("mu"), kappa=j("kappa"), dij=None), jturb,
        jturb.sigma_k, grad_rows=jnp.asarray(f["grad"].reshape(n, -1).T))
    for grad, grad_rows, ref in ((t("grad"), None, want),
                                 (None, rows, want_rows)):
        got = ei.fused_implicit_family_terms(
            ts.lib, ts.lay, ts.mesh, ts.params, t("v"), grad, t("lim"),
            t("dpdu"), t("dtdu"), trans, turb, turb.sigma_k,
            grad_rows=grad_rows)
        for name, g, w in zip(("res", "diag", "sel_t"), got, ref):
            w = np.asarray(w)
            np.testing.assert_allclose(th.npy(g), w, rtol=0.0,
                                       atol=1e-10 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("kind", ["VENKATAKRISHNAN", "BARTH_JESPERSEN"])
def test_limiters_match_jax(tmp_path_factory, kind):
    """Venkatakrishnan and Barth-Jespersen at 1e-12 relative on the MUSCL
    case's node fields."""
    from su2_tpu.ops import limiters as jl
    from su2_tpu_torch.ops import limiters
    js, ts, s, f = _make_case("venkatakrishnan", tmp_path_factory)
    qlim, glim = th.tt(f["qlim"]), th.tt(f["glim"])
    jq, jg = jnp.asarray(f["qlim"]), jnp.asarray(f["glim"])
    if kind == "VENKATAKRISHNAN":
        got = limiters.venkatakrishnan(ts.mesh, qlim, glim, 0.5, 0.1)
        want = jl.venkatakrishnan(js.mesh, jq, jg, 0.5, 0.1)
    else:
        got = limiters.barth_jespersen(ts.mesh, qlim, glim)
        want = jl.barth_jespersen(js.mesh, jq, jg)
    want = np.asarray(want)
    assert (want < 1.0).any()          # the limiter acts somewhere
    np.testing.assert_allclose(th.npy(got), want, rtol=1e-12)


def _gas_rows(tmp_path_factory, n=64, seed=3):
    """Random primitive rows (numpy) of the case's mixture: v_i, v_j
    (nV, nPrim), their dP/dU and dT/dU rows from the JAX package, normals,
    the edge vectors and node gradients; every species present."""
    from su2_tpu import state as st
    js, ts, s, f = _make_case("venkatakrishnan", tmp_path_factory)
    rng = np.random.default_rng(seed)
    idx = rng.choice(js.mesh.npoint, size=(2, n))
    v = f["v"]
    out = dict(v_i=v[idx[0]], v_j=v[idx[1]],
               s_i=np.asarray(st.dpdu(js.lib, js.lay, jnp.asarray(v[idx[0]]))),
               s_j=np.asarray(st.dpdu(js.lib, js.lay, jnp.asarray(v[idx[1]]))),
               t_i=np.asarray(st.dtdu(js.lib, js.lay, jnp.asarray(v[idx[0]]))),
               t_j=np.asarray(st.dtdu(js.lib, js.lay, jnp.asarray(v[idx[1]]))),
               normal=rng.normal(0.0, 0.01, (n, 2)),
               evec=rng.normal(0.0, 0.02, (n, 2)),
               g_i=f["grad"][idx[0]], g_j=f["grad"][idx[1]],
               mu_i=f["mu"][idx[0]], mu_j=f["mu"][idx[1]],
               ka_i=f["kappa"][idx[0]], ka_j=f["kappa"][idx[1]],
               mut_i=s["mu_t"][idx[0]], mut_j=s["mu_t"][idx[1]],
               tke_i=s["tke"][idx[0]], tke_j=s["tke"][idx[1]],
               gk_i=s["grad_tke"][idx[0]], gk_j=s["grad_tke"][idx[1]],
               sk=s["sigma_k"][idx[0]])
    out["normal"][0] = 0.0                    # a padded slot
    return js, ts, out


def test_ausm_jacobians_match_jax(tmp_path_factory):
    """The s_i/s_j branch of ausm_flux_t against su2_tpu's ausm_t and the
    node-major ausm.ausm_flux (the boundary Jacobians) at 1e-12 x max; the
    zero-normal slot gives exactly 0."""
    from su2_tpu.ops import ausm as jausm, ausm_t as jausm_t
    from su2_tpu_torch.ops import ausm_t
    js, ts, r = _gas_rows(tmp_path_factory)
    m_inf = ts.params.m_infty
    got = ausm_t.ausm_flux_t(ts.lay, th.tt(r["v_i"].T), th.tt(r["v_j"].T),
                             th.tt(r["normal"].T), m_inf,
                             th.tt(r["s_i"].T), th.tt(r["s_j"].T))
    J = lambda k: jnp.asarray(r[k])
    fm = jausm_t.ausm_flux_t(js.lay, J("v_i").T, J("v_j").T, J("normal").T,
                             m_inf, J("s_i").T, J("s_j").T)
    nm = jausm.ausm_flux(js.lay, J("v_i"), J("v_j"), J("normal"), m_inf,
                         J("s_i"), J("s_j"))
    nm = (nm[0].T, jnp.moveaxis(nm[1], 0, -1), jnp.moveaxis(nm[2], 0, -1))
    for ref in (fm, nm):
        for g, w in zip(got, ref):
            g, w = th.npy(g), np.asarray(w)
            np.testing.assert_allclose(g[..., 1:], w[..., 1:], rtol=0.0,
                                       atol=1e-12 * np.abs(w).max())
            assert (g[..., 0] == 0.0).all()


def test_viscous_jacobians_match_jax(tmp_path_factory):
    """The s_i/s_j branch of viscous_flux_t against su2_tpu's viscous_t
    (interior form) and the node-major viscous.viscous_flux (the boundary
    form: uncorrected, the domain node's transport on both sides) at
    1e-12 x max; the zero-normal slot gives exactly 0."""
    from su2_tpu.chemistry import library as jcl
    from su2_tpu.ops import viscous as jvis, viscous_t as jvt
    from su2_tpu_torch.chemistry import library as cl
    from su2_tpu_torch.ops import edge_flux, viscous_t
    js, ts, r = _gas_rows(tmp_path_factory)
    lay, n = ts.lay, r["v_i"].shape[0]
    sel = [0, 1, 2] + list(range(4, 4 + lay.ns))
    T = lambda k: th.tt(r[k])
    J = lambda k: jnp.asarray(r[k])
    g = lambda k: th.tt(r[k][:, sel].transpose(1, 2, 0))
    tmean = 0.5 * (r["v_i"][:, 0] + r["v_j"][:, 0])
    hs = cl.species_enthalpy(ts.lib, th.tt(tmean)).T
    cps = cl.species_cp(ts.lib, th.tt(tmean)).T
    pr_t, le_t = ts.params.prandtl_turb, ts.params.lewis_turb
    sc = edge_flux.species_consts_of(ts.lib)
    # interior form
    got = viscous_t.viscous_flux_t(
        lay, sc, T("v_i").T, T("v_j").T, g("g_i"), g("g_j"), T("normal").T,
        T("evec").T, T("mu_i"), T("mu_j"), T("ka_i"), T("ka_j"), T("mut_i"),
        T("mut_j"), T("tke_i"), T("tke_j"), T("gk_i").T, T("gk_j").T,
        T("sk"), hs, cps, pr_t, le_t, s_i=T("t_i").T, s_j=T("t_j").T)
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
    # boundary form: node i on both sides of the transport, x_j = x_i + e
    coords_i = np.zeros((n, 2))
    got_b = viscous_t.viscous_flux_t(
        lay, sc, T("v_i").T, T("v_j").T, g("g_i"), g("g_i"), T("normal").T,
        T("evec").T, T("mu_i"), T("mu_i"), T("ka_i"), T("ka_i"), T("mut_i"),
        T("mut_i"), T("tke_i"), T("tke_i"), T("gk_i").T, T("gk_i").T,
        T("sk"), hs, cps, pr_t, le_t, corrected=False,
        v_fuller_j=T("v_i").T, s_i=T("t_i").T, s_j=T("t_i").T)
    v_i = J("v_i")
    dij = jcl.binary_diffusion(js.lib, v_i[:, 0], v_i[:, 3] / 101325.0) / 1e4
    tr = {"mu": J("mu_i"), "kappa": J("ka_i"), "dij": dij}
    tu = {"mu_t": J("mut_i"), "tke": J("tke_i"), "grad_tke": J("gk_i")}
    want_b = jvis.viscous_flux(
        js.lib, js.lay, v_i, J("v_j"), J("g_i"), J("g_i"), J("normal"), tr,
        tr, coord_i=jnp.asarray(coords_i),
        coord_j=jnp.asarray(coords_i + r["evec"]), corrected=False,
        turb_i=tu, turb_j=tu, sigma_k=J("sk"), prandtl_turb=pr_t,
        lewis_turb=le_t, s_i=J("t_i"), s_j=J("t_i"))
    want_b = (want_b[0].T, jnp.moveaxis(want_b[1], 0, -1),
              jnp.moveaxis(want_b[2], 0, -1))
    for gg, ww in ((got, want), (got_b, want_b)):
        for g_, w in zip(gg, ww):
            g_, w = th.npy(g_), np.asarray(w)
            np.testing.assert_allclose(g_[..., 1:], w[..., 1:], rtol=0.0,
                                       atol=1e-12 * np.abs(w).max())
            assert (g_[..., 0] == 0.0).all()


def test_ghost_dpdu_and_wall_jacobian_match_jax(tmp_path_factory):
    """euler.ghost_dpdu (with row_gamma_vel2) and euler_wall_jacobian at
    1e-12 relative."""
    from su2_tpu.solvers import euler as jes
    from su2_tpu_torch.solvers import euler as es
    js, ts, r = _gas_rows(tmp_path_factory)
    v = r["v_j"]
    gam, vel2 = es.row_gamma_vel2(ts.lay, th.tt(v))
    jgam, jvel2 = jes._row_gamma_vel2(js.lay, jnp.asarray(v))
    np.testing.assert_allclose(th.npy(gam), np.asarray(jgam), rtol=1e-12)
    got = es.ghost_dpdu(ts.lib, ts.lay, th.tt(v), gam, vel2)
    want = np.asarray(jes.ghost_dpdu(js.lib, js.lay, jnp.asarray(v), jgam,
                                     jvel2))
    np.testing.assert_allclose(th.npy(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    nodes = np.arange(r["v_i"].shape[0])
    normal = r["normal"][1:]
    dpdu = r["s_i"][1:]
    got = es.euler_wall_jacobian(ts.lay, th.tt(normal), th.tt(dpdu))
    want = np.asarray(jes.euler_wall_jacobian(
        js.lib, js.lay, nodes[1:] - 1, jnp.asarray(normal),
        jnp.asarray(r["v_i"][1:]), jnp.asarray(dpdu)))
    np.testing.assert_allclose(th.npy(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("pasr", [True, False], ids=["pasr", "laminar"])
def test_source_jacobian_matches_jax(tmp_path, pasr):
    """chemistry/library.source_jacobian (GetTurbSourceJacobian with the
    PaSR constants, GetSourceJacobian without) at 1e-12 relative, and the
    implicit source system of euler.chemistry_source_system."""
    from su2_tpu.chemistry import library as jcl
    from su2_tpu.chemistry.library import load_library
    from su2_tpu_torch.chemistry import library as cl
    manifest = th.cases.write_library(str(tmp_path))
    jlib = load_library(manifest, None, jnp.float64)
    lib = cl.load_library(manifest)
    t, rho, ys, omt = th.random_gas(lib.nspecies, 200, seed=11)
    J, T = jnp.asarray, th.tt
    jrf, jrb, jkc = jcl.reaction_rates(jlib, J(t), J(rho), J(ys))
    rf, rb, kc = cl.reaction_rates(lib, T(t), T(rho), T(ys))
    jk = k = None
    if pasr:
        jk = jcl.pasr_constants(jlib, jcl.dfr_drho(jlib, jrf, jrb, J(rho),
                                                   J(ys)), J(omt), 0.09, 0.2)
        k = cl.pasr_constants(lib, cl.dfr_drho(lib, rf, rb, T(rho), T(ys)),
                              T(omt), 0.09, 0.2)
    want = np.asarray(jcl.source_jacobian(jlib, J(t), J(rho), J(ys), jrf,
                                          jrb, jkc, jk))
    got = th.npy(cl.source_jacobian(lib, T(t), T(rho), T(ys), rf, rb, kc, k))
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
