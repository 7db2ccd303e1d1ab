"""Plain version of kernel T3 through the port's ns_assemble against the JAX
ns_assemble with the fused edge kernel off (XLA edge-major chain) and on
(Pallas fused_edge_flux_pallas_multi in interpret mode): residual and the
convective / viscous spectral radii (tests/test_edge_fused.py:82,89)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)


def _make_pair(tmp, variant):
    text = th.case_variant(th.write_case(tmp), variant)
    js, ts = th.jax_sim(text), th.torch_sim(text)
    n, nd = js.mesh.npoint, js.lay.ndim
    rng = np.random.default_rng(7)
    lay = js.lay
    u = np.asarray(js.u0) * (1.0 + 0.02 * rng.standard_normal(
        np.asarray(js.u0).shape))
    # a mixing-layer composition: every species present and graded
    alpha = np.array([1.0, 1.0, 1.0, 1.0, 1.0] + [0.05] * (lay.ns - 5))
    u[:, lay.RHOS:] = u[:, :1] * rng.dirichlet(alpha, n)
    t_guess = np.asarray(js.t0)
    q = np.asarray(js.initial_turb_state()[0])
    turb = dict(tke=q[:, 0] * rng.uniform(0.5, 1.5, n),
                mu_t=rng.uniform(1e-5, 1e-3, n),
                grad_tke=rng.normal(0.0, 1e-1, (n, nd)),
                sigma_k=rng.uniform(0.85, 1.0, n))
    omega_t = q[:, 1] * rng.uniform(0.5, 1.5, n)
    return js, ts, u, t_guess, turb, omega_t


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _make_pair(tmp_path_factory.mktemp("edge"), "isothermal")


def _jax_terms(pair, fused):
    from su2_tpu import state as st
    from su2_tpu.ops import timestep, viscous as vis
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu.solvers import ns
    js, _, u, t_guess, turb, omega_t = pair
    lib, lay, mesh, prm = js.lib, js.lay, js.mesh, js.params
    j = {k: jnp.asarray(v) for k, v in turb.items()}
    _, v, _ = st.cons2prim(lib, lay, jnp.asarray(u), jnp.asarray(t_guess),
                           js.tparams, turb_ke=j["tke"])
    tfd = vis.TurbFlowData(tke=j["tke"], mu_t=j["mu_t"],
                           grad_tke=j["grad_tke"], sigma_k=j["sigma_k"])
    ek.set_edge_kernel_mode(fused)
    try:
        res, wm, trans, _, lams = ns.ns_assemble(
            lib, lay, mesh, prm, js.bcs, v, turb=tfd,
            omega_turb=jnp.asarray(omega_t),
            sigma_k_edge=j["sigma_k"][mesh.edges[:, 0]], want_lambdas=True)
    finally:
        ek.set_edge_kernel_mode(False)
    dpdu = st.dpdu(lib, lay, v)
    if fused:
        lam_c = timestep.boundary_lambda_inv(mesh, lay, v, lams[0])
        lam_v = ns.viscous_lambda_boundary(lib, mesh, lay, prm, v, trans,
                                           dpdu, tfd, lams[1])
    else:
        assert lams is None
        lam_c = timestep.max_lambda_inv(mesh, lay, v)
        lam_v = ns.viscous_lambda(lib, mesh, lay, prm, v, trans, dpdu, tfd)
    return res, wm, lam_c, lam_v


def _port_terms(pair):
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import timestep, viscous as vis
    from su2_tpu_torch.solvers import ns
    _, ts, u, t_guess, turb, omega_t = pair
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    t = {k: th.tt(v) for k, v in turb.items()}
    nsd = st.node_state(lib, lay, th.tt(u), th.tt(t_guess), ts.tparams,
                        turb_ke=t["tke"])
    tfd = vis.TurbFlowData(tke=t["tke"], mu_t=t["mu_t"],
                           grad_tke=t["grad_tke"], sigma_k=t["sigma_k"])
    res, wm, trans, _, lams, _ = ns.ns_assemble(
        lib, lay, mesh, prm, ts.bcs, nsd.v, nsd, tfd, th.tt(omega_t))
    lam_c = timestep.boundary_lambda_inv(mesh, lay, nsd.v, lams[0])
    lam_v = ns.viscous_lambda_boundary(lib, mesh, lay, prm, nsd.v, trans,
                                       nsd.dpdu, tfd, lams[1])
    return res, wm, lam_c, lam_v


@pytest.fixture(scope="module")
def port(pair):
    return _port_terms(pair)


def _check_terms(jax_terms, port_terms):
    res0, wm0, lc0, lv0 = (np.asarray(x) for x in jax_terms)
    res1, wm1, lc1, lv1 = (th.npy(x) for x in port_terms)
    np.testing.assert_array_equal(wm1, wm0)
    scale = np.abs(res0).max(axis=0)
    assert (scale > 0.0).all()
    for k in range(res0.shape[1]):
        np.testing.assert_allclose(res1[:, k], res0[:, k], rtol=1e-12,
                                   atol=1e-12 * scale[k], err_msg=str(k))
    np.testing.assert_allclose(lc1, lc0, rtol=1e-12)
    np.testing.assert_allclose(lv1, lv0, rtol=1e-10)


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas"])
def test_t3_plain_ns_assemble_matches_jax(pair, port, fused):
    _check_terms(_jax_terms(pair, fused), port)


def test_t3_slip_heatflux_mass_flow_matches_jax(tmp_path):
    """The same with a slip lower wall (euler_wall_residual), a heat-flux
    upper wall and a MASS_FLOW inlet, against the fused JAX path."""
    pair = _make_pair(tmp_path, "slip_heatflux_mass_flow")
    _check_terms(_jax_terms(pair, True), _port_terms(pair))


def test_t3_roll_subtract_equals_scatter_edges(pair):
    """The family roll-subtract that forms the residual from kernel T3's
    per-slot fluxes equals the gather-based scatter_edges of the same
    per-edge fluxes."""
    _, ts, *_ = pair
    mesh, lay = ts.mesh, ts.lay
    n = mesh.npoint
    rng = np.random.default_rng(1)
    fam = th.tt(rng.normal(size=(len(mesh.fam_offsets), lay.nvar, n)))
    # zero the absent edge slots, as the zero normals do in the kernel
    valid = (mesh.fam_normal != 0).any(-1)                  # (Kh, nP)
    fam = fam * valid[:, None, :]
    roll = sum(fam[k] - torch.roll(fam[k], o, dims=1)
               for k, o in enumerate(mesh.fam_offsets)).T
    e = mesh.edges
    diff = e[:, 1] - e[:, 0]
    k_of = {o: k for k, o in enumerate(mesh.fam_offsets)}
    edge_vals = torch.stack([fam[k_of[int(d)], :, int(i)]
                             for d, i in zip(diff, e[:, 0])])
    np.testing.assert_allclose(th.npy(mesh.scatter_edges(edge_vals)),
                               th.npy(roll), rtol=1e-13, atol=1e-13)
