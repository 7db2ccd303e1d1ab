"""Plain version of kernel K8 through the port's ns_assemble in the
>= TILED_MIN_NODES tier (forced at 153 nodes) against the JAX ns_assemble
with the tier forced (SU2_TPU_TILED_GRAD=1, SU2_TPU_WIN_EDGE=1, fused edge
mode on: the tiled gradient rows and the windowed _edge_win_call in
interpret mode), in one tile and in a forced two-tile plan
(tests/test_edge_win.py:106); residual and spectral radii at the
tolerances of tests/test_torch_edge_flux.py's _check_terms."""

import numpy as np
import pytest
import torch

import torch_helpers as th
from test_torch_edge_flux import _check_terms, _jax_terms, _make_pair, \
    _port_terms

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _make_pair(tmp_path_factory.mktemp("edgewin"), "isothermal")


def _jax_windowed(pair, monkeypatch, ntiles):
    from su2_tpu.pallas import edge_fused
    from su2_tpu.pallas.stencil_solve import _round128
    monkeypatch.setenv("SU2_TPU_TILED_GRAD", "1")
    monkeypatch.setenv("SU2_TPU_WIN_EDGE", "1")
    mesh = pair[0].mesh
    plan = edge_fused._edge_win_plan(mesh)
    assert plan is not None and plan[2] == 1
    if ntiles > 1:
        h = _round128(max(int(o) for o in mesh.fam_offsets))
        t = _round128(mesh.npoint) // ntiles
        assert t % 128 == 0 and t * ntiles >= mesh.npoint
        monkeypatch.setattr(edge_fused, "_edge_win_plan",
                            lambda m: (t, h, ntiles))
    return _jax_terms(pair, True)


def _port_tier(pair, monkeypatch):
    from su2_tpu_torch.ops import edge_flux, gradients
    monkeypatch.setattr(gradients, "TILED_MIN_NODES", 0)
    calls = []
    stack = edge_flux.stack_inputs
    monkeypatch.setattr(edge_flux, "stack_inputs", lambda *a, **kw: (
        calls.append(kw.get("grad_rows", a[7] if len(a) > 7 else None)
                     is not None) or stack(*a, **kw)))
    out = _port_terms(pair)
    assert calls == [True]          # the stack came from gradient rows
    return out


@pytest.mark.parametrize("ntiles", [1, 2], ids=["one_tile", "two_tiles"])
def test_k8_plain_ns_assemble_matches_jax_windowed(pair, ntiles,
                                                   monkeypatch):
    _check_terms(_jax_windowed(pair, monkeypatch, ntiles),
                 _port_tier(pair, monkeypatch))


def test_k8_tier_equals_the_t3_path(pair, monkeypatch):
    """At 153 nodes every volume is positive, so the tier's gradient rows
    equal the node-major sweep and the residual of the forced tier equals
    the T3 path's bitwise (the same per-edge arithmetic and order)."""
    below = _port_terms(pair)
    tier = _port_tier(pair, monkeypatch)
    for a, b in zip(tier, below):
        assert torch.equal(a, b)


def test_k8_slip_heatflux_mass_flow_matches_jax(tmp_path, monkeypatch):
    """The same with a slip lower wall, a heat-flux upper wall and a
    MASS_FLOW inlet."""
    pair = _make_pair(tmp_path, "slip_heatflux_mass_flow")
    _check_terms(_jax_windowed(pair, monkeypatch, 1),
                 _port_tier(pair, monkeypatch))


def test_edge_win_plain_sums_t3_slots(pair):
    """edge_win_plain is T3's per-slot outputs summed per node in the
    roll-subtract order, and the stack built from gradient rows equals
    the node-major one."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    _, ts, u, t_guess, turb, _ = pair
    lib, lay, mesh, prm = ts.lib, ts.lay, ts.mesh, ts.params
    nsd = st.node_state(lib, lay, th.tt(u), th.tt(t_guess), ts.tparams)
    q = vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs)
    t = {k: th.tt(v) for k, v in turb.items()}
    tfd = vis.TurbFlowData(**t)
    trans = vis.Transport(nsd.mu, nsd.kappa)
    grad = es.compute_gradients(mesh, prm, q)
    rows = es.compute_gradient_rows(mesh, prm, q)
    f_node = ef.stack_inputs(lay, nsd.v, grad, trans, tfd, t["sigma_k"],
                             nsd.dpdu[:, lay.RHOE])
    f_rows = ef.stack_inputs(lay, nsd.v, None, trans, tfd, t["sigma_k"],
                             nsd.dpdu[:, lay.RHOE], grad_rows=rows)
    assert torch.equal(f_node, f_rows)
    args = (lib, lay, ef.species_consts_of(lib),
            (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb),
            f_rows, mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)
    flux, lc, lv = ef.edge_flux_plain(*args)
    res, lcn, lvn = ef.edge_win_plain(*args)
    want = sum(flux[k] - torch.roll(flux[k], o, dims=1)
               for k, o in enumerate(mesh.fam_offsets))
    np.testing.assert_allclose(th.npy(res), th.npy(want), rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))
    assert res.shape == (lay.nvar, mesh.npoint)
    assert lcn.shape == lvn.shape == (mesh.npoint,)
