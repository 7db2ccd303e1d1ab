"""Kernel K11's plain path and the laminar implicit assembly around it
against su2_tpu: ops/edge_kernels.ausm_flux_jac_t and ausm_flux_jac
against pallas/edge_kernels.ausm_flux_jac_pallas_t and ausm_flux_jac_pallas
in interpret mode; euler.convective_system_fam; blockcsr.family_sel and
make_solver_ops_fam against su2_tpu's make_solver_ops on one
FamilyJacobian; the MeshArrays family helpers.  f64 on the CPU, 153-node
synthetic channel."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)


def _layouts(ns=9):
    from su2_tpu.state import Layout as JLayout
    from su2_tpu_torch.state import Layout
    return JLayout(2, ns), Layout(2, ns)


# (layout, species count): the case's 9 (ids as before), then the 3-species
# air of the flat plate and a 5-species mixture, which K11 runs through its
# run-time-count instance on the card
AUSM_CASES = [(lay, ns) for ns in (9, 3, 5)
              for lay in ("feature_major", "edge_major")]


@pytest.mark.parametrize("layout,ns", AUSM_CASES,
                         ids=[lay if ns == 9 else f"{lay}-{ns}"
                              for lay, ns in AUSM_CASES])
def test_ausm_flux_jac_matches_pallas(layout, ns):
    """The port's dispatchers on CPU tensors (ops/ausm_t.py, K11's plain
    version) against ausm_flux_jac_pallas_t (:91) and ausm_flux_jac_pallas
    (:34) in interpret mode, f64, at 1e-12 x max over the valid slots, at
    9, 3 and 5 species; the port's pad slots are exactly 0."""
    from su2_tpu.pallas import edge_kernels as jek
    from su2_tpu_torch.ops import edge_kernels as ek
    jlay, lay = _layouts(ns)
    r = th.ausm_edge_inputs(lay)
    m_inf = 0.0251
    J = lambda k: jnp.asarray(r[k])
    ins = ("v_i", "v_j", "normal", "s_i", "s_j")
    if layout == "feature_major":
        want = jek.ausm_flux_jac_pallas_t(jlay, *(J(k) for k in ins[:3]),
                                          m_inf, J("s_i"), J("s_j"))
        got = ek.ausm_flux_jac_t(lay, *(th.tt(r[k].T) for k in ins[:3]),
                                 m_inf, th.tt(r["s_i"].T), th.tt(r["s_j"].T))
        # feature-major -> the edge-major layout the JAX entry returns
        got = (got[0].T, got[1].permute(2, 0, 1), got[2].permute(2, 0, 1))
    else:
        want = jek.ausm_flux_jac_pallas(jlay, *(J(k) for k in ins[:3]),
                                        m_inf, J("s_i"), J("s_j"))
        got = ek.ausm_flux_jac(lay, *(th.tt(r[k]) for k in ins[:3]), m_inf,
                               th.tt(r["s_i"]), th.tt(r["s_j"]))
    valid = (r["normal"] != 0.0).any(1)
    for g, w in zip(got, want):
        g, w = th.npy(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g[valid], w[valid], rtol=0.0,
                                   atol=1e-12 * np.abs(w[valid]).max())
        assert (g[~valid] == 0.0).all()


def _laminar_case(tmp_path, muscl, limiter="VENKATAKRISHNAN",
                  prec="JACOBI"):
    text = th.with_implicit(th.cases.with_laminar(th.write_case(tmp_path)),
                            muscl=muscl, limiter=limiter, prec=prec)
    return th.jax_sim(text), th.torch_sim(text)


def _jax_fields(js, u):
    """v, gradients of the NS set, the limiter (or None), dP/dU of the JAX
    package on the state u (numpy)."""
    from su2_tpu import state as st
    from su2_tpu.ops import limiters, viscous as vis
    from su2_tpu.solvers import euler as es
    lib, lay, mesh, prm = js.lib, js.lay, js.mesh, js.params
    _, v, _ = st.cons2prim(lib, lay, jnp.asarray(u), js.t0, js.tparams)
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(lib, lay, v))
    glim = grad[:, :2 + lay.ndim, :]
    lim = jnp.ones((v.shape[0], 2 + lay.ndim), v.dtype)
    if prm.use_limiter:
        lim = limiters.venkatakrishnan(mesh, es.gradient_vars(lay, v), glim,
                                       prm.limiter_coeff,
                                       prm.ref_elem_length)
    return v, grad, lim, st.dpdu(lib, lay, v)


@pytest.mark.parametrize("muscl", [False, True],
                         ids=["first_order", "muscl_venkatakrishnan"])
def test_convective_system_fam_matches_jax(tmp_path, muscl):
    """euler.convective_system_fam against su2_tpu's (its K11 pallas kernel
    in interpret mode) on the same node fields: res, diag and both
    off-diagonal block sets (the port's lane layout read edge-major), f64,
    1e-12 x max."""
    from su2_tpu.pallas import edge_kernels as jek
    from su2_tpu.solvers import euler as jes
    from su2_tpu_torch.solvers import euler as es
    js, ts = _laminar_case(tmp_path, muscl)
    u = th.mixed_state(ts, seed=3)
    v, grad, lim, dpdu = _jax_fields(js, u)
    jek.set_edge_kernel_mode(True)
    try:
        want = jes.convective_system_fam(js.lib, js.lay, js.mesh, js.params,
                                         v, grad[:, :2 + js.lay.ndim], lim,
                                         dpdu)
    finally:
        jek.set_edge_kernel_mode(False)
    got = es.convective_system_fam(
        ts.lib, ts.lay, ts.mesh, ts.params, th.tt(v), th.tt(grad),
        th.tt(lim) if muscl else None, th.tt(dpdu))
    nv = ts.lay.nvar
    got = (got[0], got[1]) + tuple(x.T.reshape(-1, nv, nv) for x in got[2:])
    for name, g, w in zip(("res", "diag", "off_ij", "off_ji"), got, want):
        g, w = th.npy(g), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0.0,
                                   atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)


def test_family_helpers_match_jax(tmp_path):
    """fam_normal_flat, fam_valid_flat, fam_gather_i/j, fam_scatter and
    fam_accum of the port's MeshArrays against su2_tpu's, node-major
    (bitwise) and on feature-major arrays (dim=-1)."""
    js, ts = _laminar_case(tmp_path, False)
    jm, tm = js.mesh, ts.mesh
    rng = np.random.default_rng(1)
    n, kh = tm.npoint, len(tm.fam_offsets)
    x = rng.normal(size=(n, 3))
    ev = rng.normal(size=(kh * n, 3)) * np.asarray(jm.fam_valid_flat)[:, None]
    ev2 = rng.normal(size=(kh * n, 3))
    np.testing.assert_array_equal(th.npy(tm.fam_normal_flat),
                                  np.asarray(jm.fam_normal_flat))
    np.testing.assert_array_equal(th.npy(tm.fam_valid_flat),
                                  np.asarray(jm.fam_valid_flat))
    J, T = jnp.asarray, th.tt
    pairs = [(tm.fam_gather_i(T(x)), jm.fam_gather_i(J(x))),
             (tm.fam_gather_j(T(x)), jm.fam_gather_j(J(x))),
             (tm.fam_scatter(T(ev)), jm.fam_scatter(J(ev))),
             (tm.fam_accum(T(ev), T(ev2)), jm.fam_accum(J(ev), J(ev2)))]
    for g, w in pairs:
        np.testing.assert_array_equal(th.npy(g), np.asarray(w))
    # the feature-major form is the node-major one transposed
    np.testing.assert_array_equal(
        th.npy(tm.fam_scatter(T(ev.T.copy()), dim=-1)),
        np.asarray(jm.fam_scatter(J(ev))).T)
    np.testing.assert_array_equal(
        th.npy(tm.fam_gather_j(T(x.T.copy()), dim=-1)),
        np.asarray(jm.fam_gather_j(J(x))).T)


def _family_jacobian(js, ts, u, dt_scale=1.0):
    """su2_tpu's laminar implicit system on the state u: (res, JAX
    FamilyJacobian, the port's FamilyJacobian holding the same blocks)."""
    from su2_tpu import state as st
    from su2_tpu.ops import timestep
    from su2_tpu.solvers import ns as jns
    from su2_tpu_torch.linalg.blockcsr import FamilyJacobian
    lib, lay = js.lib, js.lay
    _, v, _ = st.cons2prim(lib, lay, jnp.asarray(u), js.t0, js.tparams)
    dt, _, _ = timestep.local_time_step(js.mesh, lay, v, js.params.cfl,
                                        js.params.max_dt)
    res, _, _, _, jac = jns.ns_assemble(lib, lay, js.mesh, js.params,
                                        js.bcs, v, dt * dt_scale,
                                        implicit=True)
    lanes = lambda b: th.tt(np.asarray(b).reshape(b.shape[0], -1).T)
    return res, jac, FamilyJacobian(diag=th.tt(jac.diag),
                                    off_ij=lanes(jac.off_ij),
                                    off_ji=lanes(jac.off_ji))


def test_family_sel_matches_jax(tmp_path):
    """blockcsr.family_sel of the lane-layout FamilyJacobian equals
    su2_tpu's family_sel (K, nP, v, v) in the stencil lane layout."""
    from su2_tpu.linalg import blockcsr as jbc
    from su2_tpu_torch.linalg import blockcsr
    js, ts = _laminar_case(tmp_path, True)
    _, jac, tjac = _family_jacobian(js, ts, th.mixed_state(ts, seed=4))
    want = np.asarray(jbc.family_sel(js.mesh, jac))       # (K, nP, v, v)
    k, n, v = want.shape[:3]
    want = want.transpose(0, 2, 3, 1).reshape(k * v * v, n)
    np.testing.assert_array_equal(th.npy(blockcsr.family_sel(ts.mesh, tjac)),
                                  want)


def test_make_solver_ops_fam_matches_jax(tmp_path, monkeypatch):
    """make_solver_ops_fam picks su2_tpu's tier for the laminar LU_SGS
    system (f64 at 153 nodes: full-precision sweep blocks, one-launch
    solve) and one FGMRES(10) solve agrees with su2_tpu's make_solver_ops
    on the same FamilyJacobian at 1e-10 x max|x|.  su2_tpu's solve runs its
    Krylov loop over the pallas (z, A z) in interpret mode
    (SU2_TPU_FUSED_FGMRES_OFF): the arithmetic of its one-launch cycle,
    which the port's plain one-launch solve computes."""
    from su2_tpu.linalg import blockcsr as jbc, krylov as jkr
    from su2_tpu_torch.linalg import blockcsr, stencil_solve as sts
    js, ts = _laminar_case(tmp_path, True, prec="LU_SGS")
    res, jac, tjac = _family_jacobian(js, ts, th.mixed_state(ts, seed=6))
    kw = dict(linear_iter=10)
    _, _, _, jsolve = jbc.make_solver_ops(js.mesh, jac, "LU_SGS",
                                          js.color_masks, **kw)
    mv, pc, pm, solve = blockcsr.make_solver_ops_fam(
        ts.mesh, tjac, "LU_SGS", ts.colors, ts.ncolor, **kw)
    offsets = tuple(ts.mesh.stencil_offsets)
    sel_dtype, one = sts.solve_tier(ts.mesh.npoint, offsets, ts.lay.nvar,
                                    torch.float64, ts.ncolor, 10)
    assert sel_dtype == torch.float64 and one
    assert (solve is not None) == (jsolve is not None)
    monkeypatch.setenv("SU2_TPU_FUSED_FGMRES_OFF", "1")
    jmv, jpc, jpm, jsolve_off = jbc.make_solver_ops(
        js.mesh, jac, "LU_SGS", js.color_masks, **kw)
    assert jsolve_off is None and jpm is not None
    rhs = -res
    want, _, _ = jkr.fgmres(jmv, jpc, rhs, max_iter=10, tol=1e-12,
                            precond_matvec=jpm)
    got, _, _ = solve(th.tt(rhs), 10, 1e-12)
    want = np.asarray(want)
    np.testing.assert_allclose(th.npy(got), want, rtol=0.0,
                               atol=1e-10 * np.abs(want).max())
    # the matvec of the operators is A x
    x = np.random.default_rng(2).normal(size=want.shape)
    np.testing.assert_allclose(th.npy(mv(th.tt(x))),
                               np.asarray(jmv(jnp.asarray(x))), rtol=0.0,
                               atol=1e-12 * np.abs(np.asarray(
                                   jmv(jnp.asarray(x)))).max())
