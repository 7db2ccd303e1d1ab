"""The laminar REACTIVE_NAVIER_STOKES step of su2_tpu_torch (KIND_TURB_MODEL=
NONE) against su2_tpu's Simulation (_make_explicit_step,
_make_implicit_step) on the 153-node synthetic channel: Simulation.run for
3 iterations, the laminar viscous flux and its Jacobians, the laminar
spectral radius, the setup and the CLI.  f64 on the CPU."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the mixed start of the implicit comparisons: every species present (see
# test_torch_slice.MIXED_YS and ROADMAP Queue 3 item 1)
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)

# id: (implicit (muscl, limiter) or None, variant, tiled, Runge-Kutta)
RUNS = {
    "explicit": (None, "isothermal", False, False),
    "explicit-rk": (None, "isothermal", False, True),
    "explicit-tiled": (None, "isothermal", True, False),
    "implicit": ((True, "VENKATAKRISHNAN"), "isothermal", False, False),
    "implicit-firstorder": ((False, None), "isothermal", False, False),
    "implicit-slip_heatflux_mass_flow": ((True, "VENKATAKRISHNAN"),
                                         "slip_heatflux_mass_flow", False,
                                         False),
}


def laminar_text(tmp_path, variant="isothermal", implicit=None,
                 prec="JACOBI", rk=False):
    text = th.cases.with_laminar(th.case_variant(th.write_case(tmp_path),
                                                 variant))
    if implicit is not None:
        text = th.with_implicit(text, *implicit, prec=prec)
    else:
        text = th.with_prec(text, prec)
    if rk:
        text = "\n".join([ln for ln in text.splitlines()
                          if not ln.startswith("TIME_DISCRE_FLOW")]
                         + ["TIME_DISCRE_FLOW= RUNGE-KUTTA_EXPLICIT"])
    return text


def run_matches_jax(text, implicit, tiled=False, monkeypatch=None):
    """Simulation.run(3) of both packages from the same state: u, T and
    the residual history within rtol 1e-9, atol 1e-12 max|field|.  The
    implicit runs start from the freestream with every species present;
    su2_tpu runs its pallas kernels in interpret mode (edge kernel mode:
    ausm_flux_jac_pallas_t; with LU_SGS its one-launch _fgmres_call)."""
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu_torch.ops import gradients
    js, ts = th.jax_sim(text), th.torch_sim(text)
    assert not ts.turbulent and ts.params.tke_inf == 0.0
    if tiled:
        monkeypatch.setenv("SU2_TPU_TILED_GRAD", "1")
        monkeypatch.setenv("SU2_TPU_WIN_EDGE", "1")
        monkeypatch.setattr(gradients, "TILED_MIN_NODES", 0)
    u = None
    if implicit:
        u = th.mixed_state(ts, ys=MIXED_YS)
    ek.set_edge_kernel_mode(tiled or implicit)
    try:
        want = js.run(3, u=None if u is None else jnp.asarray(u),
                      quiet=True)
    finally:
        ek.set_edge_kernel_mode(False)
    got = ts.run(3, u=None if u is None else th.tt(u), quiet=True)
    assert len(got) == len(want) == 3
    th.assert_fields_close(got, want, 1e-9, 1e-12, ("u", "t_guess", "hist"))
    assert np.isfinite(got[2]).all() and got[2].shape == (3, ts.lay.nvar)
    # the mixing layer reacts: laminar species production of the state
    from su2_tpu_torch import state as st
    from su2_tpu_torch.solvers import euler as es
    lay = ts.lay
    v = st.node_state(ts.lib, lay, got[0], got[1], ts.tparams).v
    om = es.chemistry_source_plain(ts.lib, ts.params, v[:, lay.T],
                                   v[:, lay.PRHO], v[:, lay.YS:])
    assert float(om.abs().max()) > 1e-2


@pytest.mark.parametrize("run_id", list(RUNS))
def test_laminar_run_matches_jax(tmp_path, monkeypatch, run_id):
    """explicit: explicit Euler from the freestream; -rk: the
    RUNGE-KUTTA_EXPLICIT stages; -tiled: the >= 200k-node tier forced on
    both sides (K7's rows, read node-major by the laminar edge terms);
    implicit: EULER_IMPLICIT with MUSCL and the Venkatakrishnan limiter,
    JACOBI; -firstorder; -slip_heatflux_mass_flow: a slip lower wall, a
    heat-flux upper wall and a MASS_FLOW inlet."""
    implicit, variant, tiled, rk = RUNS[run_id]
    text = laminar_text(tmp_path, variant, implicit, rk=rk)
    run_matches_jax(text, implicit is not None, tiled, monkeypatch)


def _rows(tmp_path, n=48, seed=9):
    """Edge rows (numpy) of a mixed reacting state of the laminar case:
    v_i, v_j, gradients, transport, dT/dU from the JAX package, random
    normals and edge vectors, one zero normal (a pad slot)."""
    from su2_tpu import state as st
    from su2_tpu.ops import viscous as vis
    from su2_tpu.solvers import euler as es
    text = laminar_text(tmp_path, implicit=(True, "VENKATAKRISHNAN"))
    js, ts = th.jax_sim(text), th.torch_sim(text)
    lib, lay = js.lib, js.lay
    _, v, _ = st.cons2prim(lib, lay, jnp.asarray(th.mixed_state(ts, seed=2)),
                           js.t0, js.tparams)
    grad = es.compute_gradients(js.mesh, js.params,
                                vis.ns_gradient_vars(lib, lay, v))
    trans = vis.node_transport(lib, lay, v)
    dtdu = st.dtdu(lib, lay, v)
    rng = np.random.default_rng(seed)
    idx = rng.choice(js.mesh.npoint, size=(2, n))
    a = lambda x, k: np.asarray(x)[idx[k]]
    r = dict(v_i=a(v, 0), v_j=a(v, 1), g_i=a(grad, 0), g_j=a(grad, 1),
             mu_i=a(trans.mu, 0), mu_j=a(trans.mu, 1),
             ka_i=a(trans.kappa, 0), ka_j=a(trans.kappa, 1),
             t_i=a(dtdu, 0), t_j=a(dtdu, 1),
             normal=rng.normal(0.0, 0.01, (n, 2)),
             evec=rng.normal(0.0, 0.02, (n, 2)))
    r["normal"][0] = 0.0
    return js, ts, r


@pytest.mark.parametrize("form", ["interior", "boundary"])
@pytest.mark.parametrize("jac", [False, True], ids=["flux", "jacobians"])
def test_viscous_flux_laminar_matches_jax(tmp_path, form, jac):
    """viscous_flux_t without the SST fields against su2_tpu's node-major
    viscous.viscous_flux with turb_i None (ops/viscous.py:184), with and
    without s_i/s_j: the interior form (corrected, each side's transport)
    and the boundary form (uncorrected, the domain node's transport and
    Fuller factor on both sides), 1e-12 x max; the zero-normal slot gives
    exactly 0 where su2_tpu's gives 0 (the flux) or is masked (the
    Jacobians).  The Jacobians' effective diffusion takes 1 - x_s as
    sum_{k!=s} x_k (ROADMAP Queue 3 item 1): every species is present, so
    the two forms agree to rounding."""
    from su2_tpu.chemistry import library as jcl
    from su2_tpu.ops import viscous as jvis
    from su2_tpu_torch.chemistry import library as cl
    from su2_tpu_torch.ops import edge_flux, viscous_t
    js, ts, r = _rows(tmp_path)
    lay, n = ts.lay, r["v_i"].shape[0]
    bnd = form == "boundary"
    sel = [0, 1, 2] + list(range(4, 4 + lay.ns))
    T = lambda k: th.tt(r[k])
    J = lambda k: jnp.asarray(r[k])
    g = lambda k: th.tt(r[k][:, sel].transpose(1, 2, 0))
    tmean = 0.5 * (r["v_i"][:, 0] + r["v_j"][:, 0])
    j_side = "i" if bnd else "j"
    jkw = dict(s_i=T("t_i").T, s_j=T(f"t_{j_side}").T) if jac else {}
    got = viscous_t.viscous_flux_t(
        lay, edge_flux.species_consts_of(ts.lib), T("v_i").T, T("v_j").T,
        g("g_i"), g(f"g_{j_side}"), T("normal").T, T("evec").T, T("mu_i"),
        T(f"mu_{j_side}"), T("ka_i"), T(f"ka_{j_side}"), None, None, None,
        None, None, None, None, cl.species_enthalpy(ts.lib, th.tt(tmean)).T,
        cl.species_cp(ts.lib, th.tt(tmean)).T, ts.params.prandtl_turb,
        ts.params.lewis_turb, corrected=not bnd,
        v_fuller_j=T("v_i").T if bnd else None, **jkw)
    dij = lambda v: jcl.binary_diffusion(js.lib, v[:, 0],
                                         v[:, 3] / 101325.0) / 1e4
    tr = lambda s: {"mu": J(f"mu_{s}"), "kappa": J(f"ka_{s}"),
                    "dij": dij(J(f"v_{'i' if bnd else s}"))}
    coords_i = np.zeros((n, 2))
    want = jvis.viscous_flux(
        js.lib, js.lay, J("v_i"), J("v_j"), J("g_i"), J(f"g_{j_side}"),
        J("normal"), tr("i"), tr(j_side), coord_i=jnp.asarray(coords_i),
        coord_j=jnp.asarray(coords_i + r["evec"]), corrected=not bnd,
        **({"s_i": J("t_i"), "s_j": J(f"t_{j_side}")} if jac else {}))
    if not jac:
        got, want = (got,), (want,)
    want = (want[0].T,) + tuple(jnp.moveaxis(w, 0, -1) for w in want[1:])
    for k, (g_, w) in enumerate(zip(got, want)):
        g_, w = th.npy(g_), np.asarray(w)
        assert g_.shape == w.shape
        np.testing.assert_allclose(g_[..., 1:], w[..., 1:], rtol=0.0,
                                   atol=1e-12 * np.abs(w).max())
        assert (g_[..., 0] == 0.0).all()


def test_viscous_lambda_laminar_matches_jax(tmp_path):
    """_visc_lam12's laminar branch (4/3 mu + kappa / (Cp/gamma)) and
    viscous_lambda with turb None (the family-roll means and the boundary
    vertices) against su2_tpu's at 1e-12 relative."""
    from su2_tpu import state as st
    from su2_tpu.ops import viscous as jvis
    from su2_tpu.solvers import ns as jns
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import ns
    text = laminar_text(tmp_path, implicit=(True, "VENKATAKRISHNAN"))
    js, ts = th.jax_sim(text), th.torch_sim(text)
    _, v, _ = st.cons2prim(js.lib, js.lay,
                           jnp.asarray(th.mixed_state(ts, seed=8)), js.t0,
                           js.tparams)
    trans = jvis.node_transport(js.lib, js.lay, v)
    dpdu = st.dpdu(js.lib, js.lay, v)
    want = np.asarray(jns.viscous_lambda(js.lib, js.mesh, js.lay, js.params,
                                         v, trans, dpdu, None))
    got = ns.viscous_lambda(ts.lib, ts.mesh, ts.lay, ts.params, th.tt(v),
                            vis.Transport(th.tt(trans.mu),
                                          th.tt(trans.kappa)),
                            th.tt(dpdu), None)
    np.testing.assert_allclose(th.npy(got), want, rtol=1e-12)
    rng = np.random.default_rng(4)
    mu, ka, gam, cv = (rng.uniform(0.5, 2.0, 16) for _ in range(4))
    T = th.tt
    np.testing.assert_allclose(
        th.npy(ns._visc_lam12(ts.params, False, T(mu), T(ka), None, T(gam),
                              T(cv))),
        np.asarray(jns._visc_lam12(js.params, False, jnp.asarray(mu),
                                   jnp.asarray(ka), None, jnp.asarray(gam),
                                   jnp.asarray(cv))), rtol=1e-15)
    np.testing.assert_allclose(th.npy(ns._visc_lam12(
        ts.params, False, T(mu), T(ka), None, T(gam), T(cv))),
        4.0 / 3.0 * mu + ka / cv, rtol=1e-15)


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_laminar_setup_follows_jax(tmp_path, implicit):
    """The laminar Simulation keeps k_inf = 0 (su2_tpu sets tke_inf only
    when turbulent: with k_inf every inlet and outlet enthalpy would carry
    it), builds no SST state, and its flux-BC ghost states equal
    su2_tpu's."""
    from su2_tpu.solvers import euler as jes
    from su2_tpu_torch import state as st
    from su2_tpu_torch.solvers import euler as es
    text = laminar_text(tmp_path, implicit=(True, "VENKATAKRISHNAN")
                        if implicit else None, prec="LU_SGS")
    js, ts = th.jax_sim(text), th.torch_sim(text)
    assert ts.params.tke_inf == js.params.tke_inf == 0.0
    assert not hasattr(ts, "scfg") and not hasattr(ts, "wall_dist")
    # the sweep colors only for an implicit system
    assert (ts.colors is None) == (js.color_masks is None) == (not implicit)
    assert ts.ncolor == (len(js.color_masks) if implicit else 0)
    nsd = st.node_state(ts.lib, ts.lay, ts.u0, ts.t0, ts.tparams)
    fb = es.flux_bc_batch(ts.lib, ts.lay, ts.bcs, nsd.v, nsd.dpdu,
                          ts.params.tke_inf)
    jfb = jes.flux_bc_batch(js.lib, js.lay, js.bcs, jnp.asarray(th.npy(
        nsd.v)), jnp.asarray(th.npy(nsd.dpdu)), js.params.tke_inf,
        js.mesh.coords)
    np.testing.assert_allclose(th.npy(fb.v_ghost), np.asarray(jfb[3]),
                               rtol=1e-13)


def test_run_chunks_laminar(tmp_path):
    """The laminar run with a chunk that does not divide niter matches the
    unchunked run and returns (u, t_guess, hist)."""
    text = laminar_text(tmp_path, implicit=(True, "VENKATAKRISHNAN"))
    a = th.torch_sim(text).run(4, quiet=True, chunk=3)
    b = th.torch_sim(text).run(4, quiet=True, chunk=1)
    assert len(a) == 3 and a[2].shape == (4, 13)
    assert torch.equal(a[0], b[0]) and np.array_equal(a[2], b[2])


def test_cli_laminar_two_iterations(tmp_path):
    """python -m su2_tpu_torch --cpu on the laminar implicit LU_SGS case:
    exits 0, and the history has 2 finite rows and no turbulence
    columns."""
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io.mesh import write_su2_mesh
    write_su2_mesh(channel_mesh(*th.CHANNEL), str(tmp_path / "channel.su2"))
    text = th.write_case(tmp_path / "lib", mesh_file="channel.su2")
    cfg = tmp_path / "case.cfg"
    cfg.write_text(th.with_implicit(th.cases.with_laminar(text),
                                    prec="LU_SGS"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(cfg), "2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "Res[k]" not in proc.stdout and "Res[RhoE]" in proc.stdout
    with open(tmp_path / "history.dat") as f:
        lines = f.read().splitlines()
    assert "Res_Turb" not in lines[1] and '"Res_Flow[4]"' in lines[1]
    rows = [ln for ln in lines if ln and ln[0].isdigit()]
    assert len(rows) == 2 and "nan" not in " ".join(rows).lower()
    # Iteration, 12 force/heat columns, 5 flow residuals, linear
    # iterations, CFL, time
    assert all(len(ln.split(",")) == 21 for ln in rows)
