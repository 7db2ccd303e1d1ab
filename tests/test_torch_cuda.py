"""The CUDA kernels T1-T4 and K5-K10 against their plain torch versions on
the card, and the slice's launch counts.  Every test needs a CUDA device
and skips without one.  This file imports no JAX, so on a machine without it run it
alone, past the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

N = 300


class _Prm:
    pasr = True
    pasr_lb = 0.2
    c_mu = 0.09


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are also checked by "
                    "chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def lib(card, tmp_path):
    from su2_tpu_torch.chemistry import library as tl
    return tl.load_library(th.cases.write_library(str(tmp_path))).to(card)


@pytest.mark.cuda
def test_t1_t4_kernels_match_plain(lib, card):
    from su2_tpu_torch import kernels
    from su2_tpu_torch.chemistry import library as tl
    from su2_tpu_torch.solvers import euler as es
    t, rho, ys, omt = (th.tt(a).to(card) for a in th.random_gas(
        lib.nspecies, N, seed=2))
    np.testing.assert_allclose(
        th.npy(kernels.mixture_enthalpy(lib, t, ys)),
        th.npy(tl.mixture_enthalpy_plain(lib, t, ys)), rtol=1e-12)
    for o in (omt, None):
        np.testing.assert_allclose(
            th.npy(kernels.chem_source(lib, _Prm, t, rho, ys, o)),
            th.npy(es.chemistry_source_plain(lib, _Prm, t, rho, ys, o)),
            rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("lite", [False, True], ids=["full", "lite"])
def test_t2_kernel_matches_plain(lib, card, lite):
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.chemistry import library as tl
    lay = st.Layout(2, lib.nspecies)

    def h_rgas(t, ys):
        tt, yy = th.tt(t).to(card), th.tt(ys).to(card)
        return (th.npy(tl.mixture_enthalpy_plain(lib, tt, yy)),
                th.npy(tl.mixture_rgas(lib, yy)))

    u, t_guess, tke = (th.tt(a).to(card) for a in th.random_conserved(
        h_rgas, lib.nspecies, 2, N, seed=3))
    p = st.TSolveParams()
    got = kernels.node_state(lib, lay, p, u, t_guess, tke, lite=lite)
    plain = st.node_state_lite_plain if lite else st.node_state_plain
    want = list(vars(plain(lib, lay, u, t_guess, p, tke)).values())
    th.assert_fields_close(got, want, 1e-10, 1e-12,
                           [f"field{i}" for i in range(len(want))])


@pytest.mark.cuda
def test_t3_kernel_matches_plain(card, tmp_path):
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    sim = Simulation(Config(text=th.write_case(tmp_path)),
                     raw_mesh=channel_mesh(*th.CHANNEL), device=card)
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    n = mesh.npoint
    rng = np.random.default_rng(9)
    u = sim.u0 * th.tt(1.0 + 0.02 * rng.standard_normal(
        tuple(sim.u0.shape))).to(card)
    nsd = st.node_state_plain(lib, lay, u, sim.t0, sim.tparams)
    grad = es.compute_gradients(mesh, prm,
                                vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs))
    turb = vis.TurbFlowData(
        tke=th.tt(rng.uniform(0.0, 5.0, n)).to(card),
        mu_t=th.tt(rng.uniform(1e-5, 1e-3, n)).to(card),
        grad_tke=th.tt(rng.normal(0.0, 1.0, (n, 2))).to(card),
        sigma_k=th.tt(rng.uniform(0.85, 1.0, n)).to(card))
    f_all = ef.stack_inputs(lay, nsd.v, grad,
                            vis.Transport(nsd.mu, nsd.kappa), turb,
                            turb.sigma_k, nsd.dpdu[:, lay.RHOE])
    args = (lib, lay, ef.species_consts_of(lib),
            (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb),
            f_all, mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)
    got = kernels.edge_flux(*args)
    want = ef.edge_flux_plain(*args)
    for g, w in zip(got, want):
        g, w = th.npy(g), th.npy(w)
        scale = np.abs(w).reshape(w.shape[0], -1, n).max(axis=-1,
                                                         keepdims=True)
        assert (np.abs(g - w).reshape(scale.shape[:2] + (n,))
                <= 1e-10 * scale).all()


def _card_sim(card, text, dtype=torch.float64):
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    return Simulation(Config(text=text), raw_mesh=channel_mesh(*th.CHANNEL),
                      dtype=dtype, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["WLS", "GG"])
def test_k7_kernel_matches_plain(card, tmp_path, mode, dtype):
    """f64 at the JAX package's tiled-sweep pin (rtol 1e-11, atol 1e-13 of
    the max); f32 rtol 1e-5, atol 1e-6 of the max (fused multiply-adds)."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import gradients_tiled as tg
    sim = _card_sim(card, th.write_case(tmp_path), dtype)
    q = th.tt(np.random.default_rng(5).standard_normal(
        (sim.mesh.npoint, 16)), dtype).to(card)
    kernels.reset_launches()
    got = tg.gradient_rows(sim.mesh, q, mode)
    assert kernels.launches["gradient_rows"] == 1
    want = th.npy(tg.gradient_rows_plain(sim.mesh, q, mode))
    rtol, afrac = (1e-11, 1e-13) if dtype == torch.float64 else (1e-5, 1e-6)
    np.testing.assert_allclose(th.npy(got), want, rtol=rtol,
                               atol=afrac * np.abs(want).max())


@pytest.mark.cuda
def test_k8_kernel_matches_plain(card, tmp_path):
    """K8 (the edge terms summed per node, one launch) against T3's plain
    version and the roll-subtract: rows of the residual within 1e-10 of
    their max, as T3; the radii within 1e-10 of theirs."""
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    sim = _card_sim(card, th.write_case(tmp_path))
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    n = mesh.npoint
    rng = np.random.default_rng(9)
    u = sim.u0 * th.tt(1.0 + 0.02 * rng.standard_normal(
        tuple(sim.u0.shape))).to(card)
    nsd = st.node_state_plain(lib, lay, u, sim.t0, sim.tparams)
    rows = es.compute_gradient_rows(
        mesh, prm, vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs))
    turb = vis.TurbFlowData(
        tke=th.tt(rng.uniform(0.0, 5.0, n)).to(card),
        mu_t=th.tt(rng.uniform(1e-5, 1e-3, n)).to(card),
        grad_tke=th.tt(rng.normal(0.0, 1.0, (n, 2))).to(card),
        sigma_k=th.tt(rng.uniform(0.85, 1.0, n)).to(card))
    f_all = ef.stack_inputs(lay, nsd.v, None,
                            vis.Transport(nsd.mu, nsd.kappa), turb,
                            turb.sigma_k, nsd.dpdu[:, lay.RHOE],
                            grad_rows=rows)
    args = (lib, lay, ef.species_consts_of(lib),
            (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb),
            f_all, mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)
    kernels.reset_launches()
    got = kernels.edge_win(*args)
    assert kernels.launches["edge_win"] == 1
    want = ef.edge_win_plain(*args)
    for g, w in zip(got, want):
        g, w = th.npy(g), th.npy(w).reshape(-1, n)
        scale = np.abs(w).max(axis=1, keepdims=True)
        assert (np.abs(g.reshape(w.shape) - w) <= 1e-10 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k9_kernel_matches_plain(card, tmp_path, dtype):
    """K9 is built without fused multiply-adds, so it runs the plain
    version's operations: f64 rtol 1e-12, f32 rtol 1e-6."""
    import dataclasses
    from su2_tpu_torch import kernels
    from su2_tpu_torch.chemistry import library as tl
    from su2_tpu_torch.solvers import inlet_tc as itc
    lib = tl.load_library(th.cases.write_library(str(tmp_path)), None,
                          dtype).to(card)
    rng = np.random.default_rng(4)
    gamma = rng.uniform(1.06, 1.2, N)
    a = np.sqrt(gamma * float(lib.ri[0]) * rng.uniform(450.0, 650.0, N))
    rm = rng.uniform(-40.0, 0.0, N) + 2.0 * a / (gamma - 1.0)
    rm[: N // 4] *= rng.uniform(0.5, 1.5, N // 4)
    al = rng.uniform(-1.0, -0.8, N)
    x = [th.tt(v, dtype).to(card) for v in (rm, gamma, al)]
    for sec in (15, 1):
        tc = dataclasses.replace(
            itc.total_conditions_t(lib, np.eye(lib.nspecies)[0], 600.0),
            sec_iters=sec)
        kernels.reset_launches()
        got = itc.solve(tc, *x)
        assert kernels.launches["inlet_tc"] == 1
        np.testing.assert_allclose(
            th.npy(got), th.npy(itc.solve_plain(tc, *x)),
            rtol=1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.cuda
def test_slice_launches_every_kernel(card, tmp_path):
    from su2_tpu_torch import kernels
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    sim = Simulation(Config(text=th.write_case(tmp_path)),
                     raw_mesh=channel_mesh(*th.CHANNEL), device=card)
    kernels.reset_launches()
    _, _, hist, _ = sim.run(3, quiet=True)
    assert np.isfinite(hist).all()
    assert kernels.launches["node_state"] == 6
    assert kernels.launches["edge_flux"] == 3
    assert kernels.launches["chem_source"] == 3
    assert kernels.launches["mixture_enthalpy"] >= 3
    # LU_SGS at 153 nodes: the whole FGMRES cycle in one launch
    assert kernels.launches["stencil_fgmres"] == 3
    assert kernels.launches["stencil_sgs_matvec"] == 0
    # below the tier: no gradient rows, no windowed edge kernel
    assert kernels.launches["gradient_rows"] == 0
    assert kernels.launches["edge_win"] == 0
    assert kernels.launches["inlet_tc"] == 0


@pytest.mark.cuda
def test_slice_launches_in_the_tier(card, tmp_path, monkeypatch):
    """The tier forced at 153 nodes: K8 once and T3 never per iteration,
    K7 for the flow sweep and the merged turbulence sweep (two per
    iteration: the case's methods match); the TOTAL_CONDITIONS inlet
    launches K9 once per iteration."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import gradients
    monkeypatch.setattr(gradients, "TILED_MIN_NODES", 0)
    sim = _card_sim(card, th.case_variant(th.write_case(tmp_path),
                                          "total_conditions"))
    kernels.reset_launches()
    _, _, hist, _ = sim.run(3, quiet=True)
    assert np.isfinite(hist).all()
    assert kernels.launches["edge_win"] == 3
    assert kernels.launches["edge_flux"] == 0
    assert kernels.launches["gradient_rows"] == 6
    assert kernels.launches["inlet_tc"] == 3
    assert kernels.launches["node_state"] == 6


# the (muscl, limiter) variants of K10 (cases.with_implicit_flow)
K10_VARIANTS = {"first_order": (False, None), "muscl": (True, None),
                "venkatakrishnan": (True, "VENKATAKRISHNAN"),
                "barth_jespersen": (True, "BARTH_JESPERSEN")}


def _k10_args(card, text, dtype):
    """K10's operands on a perturbed, mixed state of the 153-node channel:
    the stack of the port's own node state, gradients and limiter."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import edge_flux as ef, edge_implicit as ei
    from su2_tpu_torch.ops import limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    sim = _card_sim(card, text, dtype)
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    n = mesh.npoint
    rng = np.random.default_rng(9)
    u = th.tt(th.mixed_state(sim, seed=9), dtype).to(card)
    nsd = st.node_state_plain(lib, lay, u, sim.t0, sim.tparams)
    grad = es.compute_gradients(mesh, prm,
                                vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs))
    lim = None
    if prm.use_limiter:
        q, g = es.gradient_vars(lay, nsd.v), grad[:, :2 + lay.ndim]
        lim = (limiters.barth_jespersen(mesh, q, g)
               if prm.limiter_kind == "BARTH_JESPERSEN" else
               limiters.venkatakrishnan(mesh, q, g, prm.limiter_coeff,
                                        prm.ref_elem_length))
    t = lambda x: th.tt(x, dtype).to(card)
    turb = vis.TurbFlowData(tke=t(rng.uniform(0.0, 5.0, n)),
                            mu_t=t(rng.uniform(1e-5, 1e-3, n)),
                            grad_tke=t(rng.normal(0.0, 1.0, (n, 2))),
                            sigma_k=t(rng.uniform(0.85, 1.0, n)))
    f_all = ei.stack_inputs(lay, nsd.v, grad, lim,
                            vis.Transport(nsd.mu, nsd.kappa), turb,
                            turb.sigma_k, nsd.dtdu, nsd.dpdu)
    return (lib, lay, ef.species_consts_of(lib),
            (prm.m_infty, prm.prandtl_turb, prm.lewis_turb), f_all,
            mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec, prm.muscl,
            prm.use_limiter)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("variant", list(K10_VARIANTS))
def test_k10_kernel_matches_plain(card, tmp_path, variant, dtype):
    """K10 (every template variant, one launch for both families) against
    edge_implicit_plain: each output row of each family within 1e-10 (f64)
    or 1e-4 (f32, fused multiply-adds) of the row's max over the slots, as
    T3; the pad slots exactly 0."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_implicit as ei
    muscl, limiter = K10_VARIANTS[variant]
    args = _k10_args(card, th.with_implicit(th.write_case(tmp_path),
                                            muscl=muscl, limiter=limiter),
                     dtype)
    kernels.reset_launches()
    got = kernels.edge_implicit(*args)
    assert kernels.launches["edge_implicit"] == 1
    want = ei.edge_implicit_plain(*args)
    pad = th.npy((args[6] == 0).all(-1))              # (Kh, N)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for g, w in zip(got, want):
        g, w = th.npy(g).astype(np.float64), th.npy(w).astype(np.float64)
        assert np.isfinite(g).all()
        scale = np.abs(w).max(axis=-1, keepdims=True)
        assert (np.abs(g - w) <= tol * scale).all()
        assert (np.moveaxis(g, 1, 0)[:, pad] == 0.0).all()


@pytest.mark.cuda
def test_implicit_slice_launches(card, tmp_path, monkeypatch):
    """The implicit JACOBI case: K10 once per iteration (both families in
    one launch) and T2 twice; T3, K8, T4, K5 and K6 never; with the tier
    forced, K10 reads K7's rows (two K7 sweeps per iteration)."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import gradients
    text = th.with_implicit(th.write_case(tmp_path))
    for tier in (False, True):
        if tier:
            monkeypatch.setattr(gradients, "TILED_MIN_NODES", 0)
        sim = _card_sim(card, text)
        kernels.reset_launches()
        _, _, hist, _ = sim.run(3, quiet=True)
        assert np.isfinite(hist).all()
        want = {"edge_implicit": 3, "node_state": 6, "edge_flux": 0,
                "edge_win": 0, "chem_source": 0, "stencil_fgmres": 0,
                "stencil_sgs_matvec": 0, "gradient_rows": 6 * tier}
        assert {k: kernels.launches[k] for k in want} == want
        assert kernels.launches["mixture_enthalpy"] >= 3


BANDS = {"band2": (2, (-9, -8, -7, -1, 1, 7, 8, 9)),
         "band3": (3, (-5, -1, 1, 5))}
VARIANTS = ["float64", "float32", "mixed"]


def _band_args(card, system, variant, n=2000):
    v, offsets = BANDS[system]
    dtype = torch.float64 if variant == "float64" else torch.float32
    return th.stencil_args(th.band_system(n, v, offsets, 4, seed=7), dtype,
                           mixed=variant == "mixed", device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sgs_matvec", "sgs", "matvec"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("system", list(BANDS))
def test_k5_kernel_matches_plain(card, system, variant, mode):
    """K5 on band systems with round-robin masks (not a proper coloring:
    the two-buffer rule decides the numbers): f64 rtol 1e-11, atol 1e-13
    of the field's max (tests/test_stencil.py's own pin); f32 and mixed
    rtol 1e-5, atol 1e-6 of the max (f32 rounding, fused multiply-adds in
    the kernel)."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    args, r = _band_args(card, system, variant)
    sweep, matvec = mode != "matvec", mode != "sgs"
    kernels.reset_launches()
    got = kernels.stencil_sgs_matvec(**args, r=r, sweep=sweep, matvec=matvec)
    assert kernels.launches["stencil_sgs_matvec"] == 1
    want = ts.sgs_matvec_plain(**args, r=r, sweep=sweep, matvec=matvec)
    rtol, afrac = (1e-11, 1e-13) if variant == "float64" else (1e-5, 1e-6)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = th.npy(w)
        np.testing.assert_allclose(th.npy(g), w, rtol=rtol,
                                   atol=afrac * np.abs(w).max())


K6_CASES = [(v, r) for v in VARIANTS for r in ("random", "tight", "scaled")
            ] + [("float64", "zero")]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,rhs", K6_CASES)
@pytest.mark.parametrize("system", list(BANDS))
def test_k6_kernel_matches_plain(card, system, variant, rhs):
    """K6 (one cooperative launch) against the plain FGMRES(10) over the
    plain sweep, at the JAX package's pins (tests/test_stencil.py:259-262,
    315-317): equal iterations; f64 x rtol 1e-9, atol 1e-12 of max|x|, rel
    rtol 1e-8 (atol 1e-15: at tol 1e-12 rel ends at rounding level, where
    the summation orders of the dots show); f32 and mixed x within 2e-5 of
    max|x|.  'tight' is tol
    1e-12 (all iterations in f32), 'scaled' a right side times 1e18 (the
    pow2 scaling).  b = 0 only in f64: in f32 the reference's 1e-300 floor
    rounds to 0 and its cycle returns 0/0."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    args, r = _band_args(card, system, variant)
    b = {"random": r, "tight": r, "scaled": r * 1e18, "zero": 0.0 * r}[rhs]
    tol = 1e-12 if rhs == "tight" else 1e-6
    kernels.reset_launches()
    x, rel, it = kernels.stencil_fgmres(**args, b=b, m=10, tol=tol)
    assert kernels.launches["stencil_fgmres"] == 1
    wx, wrel, wit = ts.fgmres_plain(**args, b=b, m=10, tol=tol)
    assert int(it) == int(wit)
    x, wx = th.npy(x), th.npy(wx)
    scale = max(np.abs(wx).max(), 1e-300)
    if variant == "float64":
        np.testing.assert_allclose(x, wx, rtol=1e-9, atol=1e-12 * scale)
        np.testing.assert_allclose(float(rel), float(wrel), rtol=1e-8,
                                   atol=1e-15)
    else:
        assert np.abs(x - wx).max() <= 2e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["LU_SGS", "ILU0"])
def test_f64_past_the_gate_launches_k5(card, monkeypatch, kind):
    """In float64 past the full-precision gate the solve's (z, A z) is K5
    at full precision, one launch per application (the reference has no
    bf16 tier there), equal to the plain version at the f64 pin."""
    from types import SimpleNamespace
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import blockcsr as tb, stencil_solve as ts
    monkeypatch.setattr(ts, "supported", lambda *a, **kw: False)
    args, r = _band_args(card, "band2", "float64")
    n, v = r.shape
    mesh = SimpleNamespace(npoint=n, stencil_offsets=args["offsets"])
    _, _, pm, solve = tb.make_solver_ops_stencil_t(
        mesh, args["diag_t"].T.reshape(n, v, v), args["selm_t"], kind,
        args["colors"], args["ncolor"], linear_iter=10)
    assert solve is None
    ops = pm.__self__
    assert ops.sel_t.dtype == torch.float64
    kernels.reset_launches()
    got = pm(r)
    assert kernels.launches["stencil_sgs_matvec"] == 1
    want = ts.sgs_matvec_plain(ops.sel_t, ops.selm_t, ops.dinv_t, ops.diag_t,
                               ops.colors, r, ops.offsets, ops.ncolor)
    for g, w in zip(got, want):
        w = th.npy(w)
        np.testing.assert_allclose(th.npy(g), w, rtol=1e-11,
                                   atol=1e-13 * np.abs(w).max())
