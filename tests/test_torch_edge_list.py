"""Kernel K13's layout and node sums on the CPU: the node-major stack the
edge pass reads in place, the node sums' loop (the index arithmetic of
csrc/edge_list.cu's edge_list_sum_kernel, written in torch) against
MeshArrays.scatter_edges_mixed bit for bit, the slot invariants that loop
relies on, and the edge-list branch of fused_interior_terms against
su2_tpu's (fused_edge_flux_pallas in interpret mode), on the 153-node
scrambled triangle channel and the quad channel's edge list."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]
DT_IDS = ["f64", "f32"]


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    return th.tri_sims(th.write_case(tmp_path_factory.mktemp("k13")))


@pytest.fixture(scope="module")
def meshes(sims):
    """The port's MeshArrays of the triangle channel and of the quad
    channel (channel_mesh on the same node grid, a static stencil)."""
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays
    from su2_tpu_torch.geometry.structured import channel_mesh
    quad = mesh_arrays(build_dual_grid(channel_mesh(*th.CHANNEL)))
    assert quad.fam_offsets is not None
    return {"tri": sims[1].mesh, "quad": quad}


@pytest.fixture(scope="module")
def inputs(sims):
    """fused_interior_terms' per-node inputs (v, grad, trans, turb,
    sigma_k, dpdu_e) of a mixed, reacting state on the triangle channel
    (numpy seed), through the port's plain node state and gradients."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import euler as es
    _, ts = sims
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    n, nd = mesh.npoint, lay.ndim
    rng = np.random.default_rng(14)
    u = th.mixed_state(ts, seed=14)
    q = th.npy(ts.initial_turb_state()[0])
    tke = th.tt(q[:, 0] * rng.uniform(0.5, 1.5, n))
    nsd = st.node_state(lib, lay, th.tt(u), ts.t0, ts.tparams, turb_ke=tke)
    grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(
        lib, lay, nsd.v, xs=nsd.xs))
    sigma_k = th.tt(rng.uniform(0.85, 1.0, n))
    turb = vis.TurbFlowData(tke=tke, mu_t=th.tt(rng.uniform(1e-5, 1e-3, n)),
                            grad_tke=th.tt(rng.normal(0.0, 1e-1, (n, nd))),
                            sigma_k=sigma_k)
    return (nsd.v, grad, vis.Transport(nsd.mu, nsd.kappa), turb, sigma_k,
            nsd.dpdu[:, lay.RHOE])


def _cast(inputs, dtype):
    """inputs with every tensor (the fields of trans and turb too) in
    dtype."""
    from su2_tpu_torch.ops import viscous as vis
    v, grad, trans, turb, sigma_k, dpdu_e = inputs
    c = lambda x: x.to(dtype)
    return (c(v), c(grad), vis.Transport(c(trans.mu), c(trans.kappa)),
            vis.TurbFlowData(tke=c(turb.tke), mu_t=c(turb.mu_t),
                             grad_tke=c(turb.grad_tke),
                             sigma_k=c(turb.sigma_k)),
            c(sigma_k), c(dpdu_e))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_stack_nodes_is_stack_inputs_transposed(sims, inputs, dtype):
    """The node-major stack K13's edge pass reads in place (stack_nodes,
    (nP, R), contiguous: a node's R inputs one run) is the feature-major
    stack_inputs transposed, bit for bit, and stack_inputs is still that
    stack's copy."""
    from su2_tpu_torch.ops import edge_flux as ef
    lay = sims[1].lay
    x = _cast(inputs, dtype)
    nodes = ef.stack_nodes(lay, *x)
    feat = ef.stack_inputs(lay, *x)
    n = sims[1].mesh.npoint
    assert nodes.shape == (n, ef.stack_rows(lay)["total"]) == (n, 48)
    assert nodes.is_contiguous() and feat.is_contiguous()
    assert nodes.dtype == feat.dtype == dtype
    assert torch.equal(nodes.T, feat)


def sums_loop(mesh, rows):
    """The node sums of edge_list_sum_kernel written out in torch: for
    each node p and column c, from slot 0 on in order, rows[e, c] times
    node_sign_t (c < nVar) or its absolute value (the last two columns),
    e = node_edges_t[d nP + p]; a pad slot (e = nE) reads zero."""
    n, ne, deg = mesh.npoint, mesh.nedge, mesh.max_degree
    nv = rows.shape[1] - 2
    acc = None
    for d in range(deg):
        e = mesh.node_edges_t[d * n:(d + 1) * n]
        s = mesh.node_sign_t[d * n:(d + 1) * n]
        x = torch.where((e < ne)[:, None], rows[e.clamp(max=ne - 1)],
                        torch.zeros((), dtype=rows.dtype))
        m = torch.cat([s[:, None].expand(-1, nv),
                       s.abs()[:, None].expand(-1, 2)], dim=1)
        acc = x * m if acc is None else acc + x * m
    return acc[:, :nv], acc[:, nv], acc[:, nv + 1]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("which", ["tri", "quad"])
def test_node_sums_loop_equals_scatter_edges_mixed(meshes, which, dtype):
    """The sum kernel's loop equals scatter_edges_mixed (the plain version
    the CPU keeps using) bit for bit on random edge rows (13 flux columns
    and the two radii, magnitudes over 16 decades), so the kernel may sum
    in its own order of loads and still match it: the product by +-1 or 0
    is exact, the slots are added in the same order."""
    mesh = meshes[which].to(dtype=dtype)
    rng = np.random.default_rng(15)
    rows = th.tt(rng.standard_normal((mesh.nedge, 15)) * 10.0 ** rng.uniform(
        -8, 8, (mesh.nedge, 1)), dtype)
    got = sums_loop(mesh, rows)
    res, lams = mesh.scatter_edges_mixed(rows[:, :13], rows[:, 13:])
    for g, w in zip(got, (res, lams[:, 0], lams[:, 1])):
        assert g.dtype == w.dtype == dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("which,deg", [("tri", 8), ("quad", 4)])
def test_slot_invariants(meshes, which, deg):
    """What the sum kernel relies on: node_edges_t and node_sign_t are
    slot-major (max_degree nP,), the pad slots hold the index nE and the
    sign 0 and only they; every edge sits in two slots, +1 at its i node
    and -1 at its j node; max_degree is the largest count of real slots."""
    mesh = meshes[which]
    n, ne = mesh.npoint, mesh.nedge
    assert mesh.max_degree == deg
    slots, sign = th.npy(mesh.node_edges_t), th.npy(mesh.node_sign_t)
    assert mesh.node_edges_t.dtype == torch.int64
    assert slots.shape == sign.shape == (deg * n,)
    pad = slots == ne
    assert ((slots >= 0) & (slots <= ne)).all()
    assert (sign[pad] == 0.0).all() and (np.abs(sign[~pad]) == 1.0).all()
    assert (~pad).reshape(deg, n).sum(0).max() == deg
    node = np.tile(np.arange(n), deg)
    edges = th.npy(mesh.edges)
    for s, col in ((1.0, 0), (-1.0, 1)):
        sel = sign == s
        assert np.array_equal(np.sort(slots[sel]), np.arange(ne))
        assert np.array_equal(node[sel], edges[slots[sel], col])


def test_edge_list_terms_plain_is_the_parent_branch(sims, inputs):
    """edge_list_terms_plain on the node-major stack gives what the edge
    list branch computed from the feature-major one (edge_list_flux_plain,
    then one scatter_edges_mixed) bit for bit."""
    from su2_tpu_torch.ops import edge_flux as ef
    ts = sims[1]
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    sc = ef.species_consts_of(lib)
    consts = (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb)
    got = ef.edge_list_terms_plain(lib, lay, sc, consts,
                                   ef.stack_nodes(lay, *inputs), mesh)
    flux, lc, lv = ef.edge_list_flux_plain(
        lib, lay, sc, consts, ef.stack_inputs(lay, *inputs), mesh.edges,
        mesh.edge_normal, mesh.coords)
    res, lams = mesh.scatter_edges_mixed(flux.T, torch.stack([lc, lv], 1))
    for g, w in zip(got, (res, lams[:, 0], lams[:, 1])):
        assert torch.equal(g, w)
    call = ef.fused_interior_terms(lib, lay, mesh, prm, *inputs)
    for g, w in zip(call, got):
        assert torch.equal(g, w)


def test_fused_interior_terms_matches_jax(sims, inputs):
    """The edge-list branch of the port's fused_interior_terms on the CPU
    (the node-major stack, edge_list_terms_plain) against su2_tpu's
    fused_interior_terms (fused_edge_flux_pallas in interpret mode, then
    its scatter_edges_mixed) on the same inputs: the residual per variable
    at rtol 1e-12, atol 1e-12 of its max, lc at rtol 1e-12, lv at rtol
    1e-10 (test_k13_plain_matches_pallas's tolerances)."""
    from su2_tpu.pallas import edge_fused as jef
    from su2_tpu_torch.ops import edge_flux as ef
    js, ts = sims
    v, grad, trans, turb, sigma_k, dpdu_e = inputs
    j = lambda x: jnp.asarray(th.npy(x))
    got = ef.fused_interior_terms(ts.lib, ts.lay, ts.mesh, ts.params,
                                  *inputs)
    want = jef.fused_interior_terms(
        js.lib, js.lay, js.mesh, js.params, j(v), j(grad),
        SimpleNamespace(mu=j(trans.mu), kappa=j(trans.kappa)),
        SimpleNamespace(tke=j(turb.tke), mu_t=j(turb.mu_t),
                        grad_tke=j(turb.grad_tke)), j(sigma_k), j(dpdu_e))
    res, lc, lv = (th.npy(x) for x in got)
    wres, wlc, wlv = (np.asarray(x) for x in want)
    assert res.shape == wres.shape == (ts.mesh.npoint, ts.lay.nvar)
    for k in range(res.shape[1]):
        np.testing.assert_allclose(res[:, k], wres[:, k], rtol=1e-12,
                                   atol=1e-12 * np.abs(wres[:, k]).max(),
                                   err_msg=str(k))
    np.testing.assert_allclose(lc, wlc, rtol=1e-12)
    np.testing.assert_allclose(lv, wlv, rtol=1e-10)


# (dimension, species count): the edge kernels' compiled shapes
# (kernels.EDGE_SHAPES), then shapes of their run-time instance
STACK_SHAPES = [(2, 9), (2, 3), (3, 9), (3, 3), (2, 5), (2, 1), (3, 16),
                (3, 5)]


@pytest.mark.parametrize("nd,ns", STACK_SHAPES,
                         ids=[f"{d}d-{s}" for d, s in STACK_SHAPES])
def test_stack_nodes_layout(nd, ns):
    """stack_nodes puts every input at stack_rows' offsets at each shape
    the edge kernels run: v, the gradients of T, u.. and X.. (grad[:, sel]
    bit for bit, the pressure row left out), mu, kappa, mu_t, tke, grad
    tke, dpdu_e + 1 and sigma_k; the result is one contiguous row a
    node."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import edge_flux as ef
    lay = st.Layout(nd, ns)
    n = 37
    rng = np.random.default_rng(16)
    r = lambda *shape: th.tt(rng.standard_normal((n,) + shape))
    v, grad = r(lay.nprim), r(2 + nd + ns, nd)
    trans = SimpleNamespace(mu=r(), kappa=r())
    turb = SimpleNamespace(mu_t=r(), tke=r(), grad_tke=r(nd))
    sigma_k, dpdu_e = r(), r()
    rows = ef.stack_rows(lay)
    f = ef.stack_nodes(lay, v, grad, trans, turb, sigma_k, dpdu_e)
    assert f.shape == (n, rows["total"]) and f.is_contiguous()
    sel = [0] + list(range(1, 1 + nd)) + list(range(2 + nd, 2 + nd + ns))
    assert torch.equal(f[:, :rows["g"]], v)
    assert torch.equal(f[:, rows["g"]:rows["mu"]],
                       grad[:, sel].reshape(n, -1))
    for key, want in (("mu", trans.mu), ("ka", trans.kappa),
                      ("mut", turb.mu_t), ("tke", turb.tke),
                      ("gam", dpdu_e + 1.0), ("sk", sigma_k)):
        assert torch.equal(f[:, rows[key]], want), key
    assert torch.equal(f[:, rows["gk"]:rows["gam"]], turb.grad_tke)


def test_k13_wrappers_refuse_cpu_tensors(sims, inputs):
    """K13's wrappers take CUDA tensors only: on CPU tensors they raise
    before anything is launched (fused_interior_terms runs the plain
    versions there)."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    ts = sims[1]
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    sc = ef.species_consts_of(lib)
    consts = (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb)
    f_nodes = ef.stack_nodes(lay, *inputs)
    rows = torch.zeros((mesh.nedge, lay.nvar + 2), dtype=torch.float64)
    for call in (
            lambda: kernels.edge_list_terms(lib, lay, sc, consts, f_nodes,
                                            mesh),
            lambda: kernels.edge_list_flux(lib, lay, sc, consts, f_nodes.T,
                                           mesh.edges, mesh.edge_normal,
                                           mesh.coords),
            lambda: kernels.edge_list_sums(mesh, rows)):
        with pytest.raises(ValueError, match="must be on"):
            call()
