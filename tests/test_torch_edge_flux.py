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


def test_shared_corner_nodes_match_jax(tmp_path):
    """The lower wall a second outlet: its two end nodes sit in two weak
    flux markers each (inlet or outlet, and lower_wall) and receive both
    boundary fluxes, added in batch order without atomics
    (euler.add_rows); the residual matches the JAX package's at
    _check_terms' tolerances (1e-12 of each variable's max)."""
    pair = _make_pair(tmp_path, "shared_corners")
    ts = pair[1]
    weak = [bc for bc in ts.bcs if bc.kind in ("inlet", "outlet")]
    nodes = torch.cat([bc.nodes for bc in weak])
    shared = nodes.unique(return_counts=True)[1]
    assert len(weak) == 3 and int((shared == 2).sum()) == 2
    _check_terms(_jax_terms(pair, True), _port_terms(pair))


def test_add_rows_sums_in_batch_order():
    """add_rows equals numpy's unbuffered np.add.at (rows added in batch
    order) bitwise, for a batch of three markers sharing nodes."""
    from su2_tpu_torch.solvers import euler as es
    rng = np.random.default_rng(2)
    x = rng.standard_normal((20, 3))
    seg = (5, 4, 6)
    nodes = np.concatenate([rng.choice(20, m, replace=False) for m in seg])
    assert len(np.unique(nodes)) < len(nodes)
    vals = rng.standard_normal((len(nodes), 3)) * 10.0 ** rng.integers(
        -8, 8, (len(nodes), 1))
    want = x.copy()
    np.add.at(want, nodes, vals)
    got = es.add_rows(th.tt(x), torch.as_tensor(nodes), th.tt(vals), seg)
    assert np.array_equal(th.npy(got), want)
    one = es.add_rows(th.tt(x), torch.as_tensor(nodes[:5]), th.tt(vals[:5]))
    want1 = x.copy()
    np.add.at(want1, nodes[:5], vals[:5])
    assert np.array_equal(th.npy(one), want1)


# (dimension, species count): shapes outside kernels.EDGE_SHAPES that the
# run-time instance takes, then shapes past its bounds (3D, 16 species)
OTHER_SHAPES = [(2, 5), (3, 16), (2, 1), (3, 17), (4, 9), (2, 0)]


@pytest.mark.parametrize("name", ["edge_flux", "edge_win", "edge_list_flux"])
@pytest.mark.parametrize("nd,ns", OTHER_SHAPES,
                         ids=[f"{nd}d-{ns}" for nd, ns in OTHER_SHAPES])
def test_edge_kernels_refuse_other_shapes(name, nd, ns):
    """The shape dispatch of T3, K8 and K13: a (dimension, species count)
    shape outside kernels.EDGE_SHAPES within 3D and 16 species passes the
    check and goes to the run-time instance (the check returns False; the
    compiled shapes return True); past those bounds the wrapper raises a
    ValueError that names the shape, before anything is launched."""
    from types import SimpleNamespace
    from su2_tpu_torch import kernels
    lay = SimpleNamespace(ndim=nd, ns=ns)
    if 1 <= nd <= kernels.MAX_DIM and 1 <= ns <= kernels.MAX_SPECIES:
        assert kernels._check_edge_shape(name, lay) is False
        return
    with pytest.raises(ValueError, match=rf"{name}: "
                       rf"({nd}D with {ns} species|{ns} species)"):
        getattr(kernels, name)(None, lay, None, None, None, None, None, None)


def _compiled(source, macro):
    """The arguments X(...) of the #define macro(X) in csrc/source."""
    import os
    import re
    from su2_tpu_torch import kernels
    with open(os.path.join(kernels.CSRC, source)) as fh:
        line = re.search(rf"#define {macro}\(X\)(.*)", fh.read())
    return tuple(tuple(int(a) for a in x.split(","))
                 for x in re.findall(r"X\(([\d, ]+)\)", line.group(1)))


@pytest.mark.parametrize("name,source,macro,listed", [
    ("edge_implicit", "edge_implicit.cu", "SU2K_IMPLICIT_BY_NS",
     "IMPLICIT_SPECIES"),
    ("ausm_flux_jac", "ausm_jac.cu", "SU2K_AUSM_BY_NS", "AUSM_SPECIES"),
    ("node_state", "node_state.cu", "SU2K_NODE_STATE_BY_NS",
     "NODE_STATE_SPECIES")])
def test_species_counts_match_the_compiled_instances(name, source, macro,
                                                     listed):
    """kernels.IMPLICIT_SPECIES (K10), AUSM_SPECIES (K11) and
    NODE_STATE_SPECIES (T2) list the species counts their #defines
    instantiate; every other count up to kernels.MAX_SPECIES passes the
    wrappers' check (the run-time instance) and 0 and 17 raise a ValueError
    that names the count."""
    from types import SimpleNamespace
    from su2_tpu_torch import kernels
    assert tuple(c[0] for c in _compiled(source, macro)) \
        == getattr(kernels, listed)
    for ns in range(1, kernels.MAX_SPECIES + 1):
        kernels._check_species(name, ns)
    lay = SimpleNamespace(ndim=2, ns=17)
    x = torch.zeros((1, 1), dtype=torch.float64)
    for ns in (0, 17):
        lay.ns = ns
        with pytest.raises(ValueError, match=rf"{name}: {ns} species"):
            if name == "edge_implicit":
                kernels.edge_implicit(None, lay, None, (0, 0, 0), x, (1,),
                                      x, x, True, True)
            elif name == "node_state":
                kernels.node_state(None, lay, None, x, x)
            else:
                kernels.ausm_flux_jac(lay, x, x, x, 0.0, x, x)


def test_edge_shapes_match_the_compiled_instances():
    """kernels.EDGE_SHAPES lists the shapes SU2K_EDGE_BY_SHAPE instantiates
    in csrc/edge_side.cuh, and every one of them passes the check as a
    compiled instance."""
    from types import SimpleNamespace
    from su2_tpu_torch import kernels
    compiled = _compiled("edge_side.cuh", "SU2K_EDGE_BY_SHAPE")
    assert compiled == kernels.EDGE_SHAPES
    for nd, ns in compiled:
        assert kernels._check_edge_shape(
            "edge_flux", SimpleNamespace(ndim=nd, ns=ns)) is True
