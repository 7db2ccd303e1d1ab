"""The implicit NS system of su2_tpu_torch (ns_assemble with dt: K10's
plain version, the boundary, slip-wall, source and isothermal-wall
Jacobians, the wall rows and the time diagonal) against su2_tpu's
ns_assemble(implicit=True) with the fused edge kernel in interpret mode,
on the 153-node synthetic channel."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)


def _mixed_state(js, ts, seed=7):
    """A perturbed state with every species present, random SST fields and
    a random local time step (numpy)."""
    n, lay = js.mesh.npoint, js.lay
    rng = np.random.default_rng(seed)
    q = np.asarray(js.initial_turb_state()[0])
    return dict(u=th.mixed_state(ts, seed=seed), t_guess=np.asarray(js.t0),
                tke=q[:, 0] * rng.uniform(0.5, 1.5, n),
                mu_t=rng.uniform(1e-5, 1e-3, n),
                grad_tke=rng.normal(0.0, 1e-1, (n, lay.ndim)),
                sigma_k=rng.uniform(0.85, 1.0, n),
                omega_t=q[:, 1] * rng.uniform(0.5, 1.5, n),
                dt=rng.uniform(0.5, 1.5, n) * 1e-5)


def _jax_system(js, s):
    from su2_tpu import state as st
    from su2_tpu.ops import viscous as vis
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu.solvers import ns
    J = lambda k: jnp.asarray(s[k])
    nsd = st.node_state(js.lib, js.lay, J("u"), J("t_guess"), js.tparams,
                        turb_ke=J("tke"))
    turb = vis.TurbFlowData(tke=J("tke"), mu_t=J("mu_t"),
                            grad_tke=J("grad_tke"), sigma_k=J("sigma_k"))
    ek.set_edge_kernel_mode(True)
    try:
        res, wm, _, _, jac, _ = ns.ns_assemble(
            js.lib, js.lay, js.mesh, js.params, js.bcs, nsd.v, J("dt"),
            implicit=True, turb=turb, omega_turb=J("omega_t"),
            sigma_k_edge=J("sigma_k")[js.mesh.edges[:, 0]], nsd=nsd,
            want_bc_states=True)
    finally:
        ek.set_edge_kernel_mode(False)
    return res, wm, jac


def _port_system(ts, s):
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import ns
    T = lambda k: th.tt(s[k])
    nsd = st.node_state(ts.lib, ts.lay, T("u"), T("t_guess"), ts.tparams,
                        turb_ke=T("tke"))
    turb = vis.TurbFlowData(tke=T("tke"), mu_t=T("mu_t"),
                            grad_tke=T("grad_tke"), sigma_k=T("sigma_k"))
    res, wm, _, _, jac, _ = ns.ns_assemble(
        ts.lib, ts.lay, ts.mesh, ts.params, ts.bcs, nsd.v, nsd, turb,
        T("omega_t"), dt=T("dt"))
    return res, wm, jac


@pytest.mark.parametrize("variant", ["isothermal", "slip_heatflux_mass_flow",
                                     "total_conditions"])
def test_ns_assemble_implicit_matches_jax(tmp_path, variant):
    """res, diag and sel_t of the implicit system (MUSCL, Venkatakrishnan)
    to 1e-10 x max|output| and the wall mask exactly, on the isothermal
    walls, a slip wall with a heat-flux wall and a MASS_FLOW inlet, and a
    TOTAL_CONDITIONS inlet (the JAX package's inlet kernel arithmetic, the
    port's K9 plain version)."""
    from su2_tpu.pallas import inlet_tc as jtc
    text = th.case_variant(th.with_implicit(th.write_case(tmp_path)),
                           variant)
    js, ts = th.jax_sim(text), th.torch_sim(text)
    s = _mixed_state(js, ts)
    jtc.set_inlet_tc_mode(variant == "total_conditions")
    try:
        res0, wm0, jac0 = _jax_system(js, s)
    finally:
        jtc.set_inlet_tc_mode(False)
    res1, wm1, jac1 = _port_system(ts, s)
    np.testing.assert_array_equal(th.npy(wm1), np.asarray(wm0))
    assert np.asarray(wm0).any()
    jac0 = th.jacobian_from_jax(jac0)
    for name, g, w in (("res", res1, res0), ("diag", jac1.diag, jac0.diag),
                       ("sel_t", jac1.sel_t, jac0.sel_t)):
        w = th.npy(w)
        np.testing.assert_allclose(th.npy(g), w, rtol=0.0,
                                   atol=1e-10 * np.abs(w).max(),
                                   err_msg=name)
