"""Plain version of kernel K9 (su2_tpu_torch/solvers/inlet_tc.py) against
the JAX package's _solve_call (pallas/inlet_tc.py, interpret mode) on random
Riemann invariants, gammas and flow-direction cosines for the fuel stream of
the synthetic mixture, in float64 and float32; and the port's
TOTAL_CONDITIONS inlet ghost state against the JAX package's inlet_state,
through its kernel and through its XLA chain."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

N = 97
TTOT = 600.0


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return th.cases.write_library(str(tmp_path_factory.mktemp("tc")))


def _libs(manifest, f32):
    from su2_tpu.chemistry import library as jl
    from su2_tpu_torch.chemistry import library as tl
    jdt, tdt = (jnp.float32, torch.float32) if f32 \
        else (jnp.float64, torch.float64)
    return jl.load_library(manifest, None, jdt), tl.load_library(manifest,
                                                                 None, tdt)


def _batch(lib_t, seed):
    """Inflow states about the 600 K fuel stream: the Riemann invariant
    vn + 2 a/(gamma - 1) from T in [450, 650] K and vn in [-40, 0] m/s
    (vn along the outward normal), gamma in [1.06, 1.2], alpha (outward
    normal . flow direction) in [-1, -0.8]; a quarter with invariants
    scaled by [0.5, 1.5], which the secant does not always root."""
    rng = np.random.default_rng(seed)
    rgas = float(lib_t.ri[0])                     # pure C4H6
    gamma = rng.uniform(1.06, 1.2, N)
    a = np.sqrt(gamma * rgas * rng.uniform(450.0, 650.0, N))
    riemann = rng.uniform(-40.0, 0.0, N) + 2.0 * a / (gamma - 1.0)
    riemann[: N // 4] *= rng.uniform(0.5, 1.5, N // 4)
    alpha = rng.uniform(-1.0, -0.8, N)
    return riemann, gamma, alpha


FUEL = np.eye(9)[0]


@pytest.mark.parametrize("sec_iters", [15, 1], ids=["secant", "bisection"])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_k9_plain_matches_pallas_solve(manifest, f32, sec_iters):
    """f64 to rtol 1e-12, f32 to 1e-6; sec_iters=1 sends every vertex to
    the bisection fallback."""
    from su2_tpu.pallas import inlet_tc as jtc
    from su2_tpu_torch.solvers import inlet_tc as ttc
    jlib, tlib = _libs(manifest, f32)
    rm, ga, al = _batch(tlib, 4)
    jdt = jnp.float32 if f32 else jnp.float64
    want, rgas, htot = jtc.total_conditions_t(
        jlib, jnp.asarray(FUEL, jdt), TTOT, jnp.asarray(rm, jdt),
        jnp.asarray(ga, jdt), jnp.asarray(al, jdt), sec_iters=sec_iters)
    tc = dataclasses.replace(ttc.total_conditions_t(tlib, FUEL, TTOT),
                             sec_iters=sec_iters)
    assert tc.rgas == rgas and tc.htot == htot
    tdt = torch.float32 if f32 else torch.float64
    got = ttc.solve(tc, th.tt(rm, tdt), th.tt(ga, tdt), th.tt(al, tdt))
    want = np.asarray(want)
    assert got.dtype == tdt and np.isfinite(want).all()
    np.testing.assert_allclose(th.npy(got), want,
                               rtol=1e-6 if f32 else 1e-12)


def test_k9_secant_and_bisection_both_run(manifest):
    """The batch of the test above sends some vertices past the secant."""
    from su2_tpu_torch.solvers import inlet_tc as ttc
    _, tlib = _libs(manifest, False)
    rm, ga, al = (th.tt(x) for x in _batch(tlib, 4))
    tc = ttc.total_conditions_t(tlib, FUEL, TTOT)
    full = ttc.solve_plain(tc, rm, ga, al)
    bis = ttc.solve_plain(dataclasses.replace(tc, sec_iters=0), rm, ga, al)
    same = full == bis
    assert 0 < int(same.sum()) < N


@pytest.mark.parametrize("kernel", [True, False], ids=["pallas", "xla"])
def test_total_conditions_inlet_state_matches_jax(tmp_path, kernel):
    """The ghost rows, gamma and |v|^2 of the TOTAL_CONDITIONS inlet at a
    perturbed state of the 153-node channel: against the JAX package's
    kernel path to 1e-12 and against its XLA chain (no eps floor) at
    rtol 1e-8, the pin of tests/test_inlet_tc.py:94."""
    from su2_tpu import state as jst
    from su2_tpu.pallas import inlet_tc as jtc
    from su2_tpu.solvers import euler as jes
    from su2_tpu_torch import state as tst
    from su2_tpu_torch.solvers import euler as tes
    text = th.case_variant(th.write_case(tmp_path), "total_conditions")
    js, ts = th.jax_sim(text), th.torch_sim(text)
    rng = np.random.default_rng(3)
    u = np.asarray(js.u0) * (1.0 + 0.02 * rng.standard_normal(
        np.asarray(js.u0).shape))
    t_guess = np.asarray(js.t0)
    _, jv, _ = jst.cons2prim(js.lib, js.lay, jnp.asarray(u),
                             jnp.asarray(t_guess), js.tparams)
    jdpdu = jst.dpdu(js.lib, js.lay, jv)[:, js.lay.RHOE]
    tnsd = tst.node_state(ts.lib, ts.lay, th.tt(u), th.tt(t_guess),
                          ts.tparams)
    (jbc,) = [b for b in js.bcs if b.kind == "inlet"]
    (tbc,) = [b for b in ts.bcs if b.kind == "inlet"]
    assert tbc.inlet_mode == jbc.inlet_mode == "TOTAL_CONDITIONS"
    jtc.set_inlet_tc_mode(kernel)
    try:
        want = jes.inlet_state(js.lib, js.lay, jbc, jv, jdpdu,
                               js.params.tke_inf)
    finally:
        jtc.set_inlet_tc_mode(False)
    got = tes.inlet_state(ts.lib, ts.lay, tbc, tnsd.v,
                          tnsd.dpdu[:, ts.lay.RHOE], ts.params.tke_inf)
    rtol = 1e-12 if kernel else 1e-8
    for g, w in zip(got, want):
        np.testing.assert_allclose(th.npy(g), np.asarray(w), rtol=rtol,
                                   atol=1e-14 * np.abs(np.asarray(w)).max())
