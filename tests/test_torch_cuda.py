"""The CUDA kernels T1-T4 and K5-K13 against their plain torch versions on
the card (K11 also on the triangle channel's edge rows), and the slice's
launch counts and graph replays (also on meshes without a static
stencil).  Every test needs a CUDA device
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


T2_SPECIES = [(ns, dt) for ns in (9, 3, 5, 16)
              for dt in ("float64", "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,dtype", T2_SPECIES,
                         ids=[f"{ns}sp-{dt}" for ns, dt in T2_SPECIES])
def test_t2_every_species_instance(card, tmp_path, ns, dtype):
    """T2 at its compiled species counts (kernels.NODE_STATE_SPECIES: 9
    and 3) and at 5 and 16 (its run-time-count instance; the case's
    library cut or cycled by cases.species_cut), full and lite, against
    node_state_plain / node_state_lite_plain on the card at chip_smoke.py's
    node_state tolerances (f64 rtol 1e-10, atol 1e-12 of the field's max;
    f32 2e-4, 1e-6): the secant path, the bisection path (secant budget 1
    from 4999 K, as tests/test_torch_node_state.py) and the non-physical
    flags (a negative partial density, a vanishing density; the flags
    exactly).  The lite variant's u, v, flags, mu and X equal the full
    variant's bit for bit."""
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.chemistry import library as tl
    dt = getattr(torch, dtype)
    man = th.cases.write_library(str(tmp_path))
    lib64 = th.cases.species_cut(tl.load_library(man), ns).to(card)
    lib = th.cases.species_cut(tl.load_library(man, None, dt), ns).to(card)
    lay = st.Layout(2, ns)
    assert (ns in kernels.NODE_STATE_SPECIES) == (ns in (9, 3))

    def h_rgas(t, ys):
        tt, yy = th.tt(t).to(card), th.tt(ys).to(card)
        return (th.npy(tl.mixture_enthalpy_plain(lib64, tt, yy)),
                th.npy(tl.mixture_rgas(lib64, yy)))

    u, t_guess, tke = th.random_conserved(h_rgas, ns, 2, N, seed=3)
    flagged = u.copy()
    flagged[3, lay.RHOS] = -1.0e-4
    flagged[7, lay.RHO] = 1.0e-20
    bis = st.TSolveParams(secant_iters=1, secant_tol=1e-30)
    rtol, afrac = (1e-10, 1e-12) if dtype == "float64" else (2e-4, 1e-6)
    for label, uu, tg, p in (
            ("secant", u, t_guess, st.TSolveParams()),
            ("bisection", u, np.full(N, 4999.0), bis),
            ("flags", flagged, t_guess, st.TSolveParams())):
        uu, tg, tk = (th.tt(a, dt).to(card) for a in (uu, tg, tke))
        full = kernels.node_state(lib, lay, p, uu, tg, tk)
        lite = kernels.node_state(lib, lay, p, uu, tg, tk, lite=True)
        for got, plain in ((full, st.node_state_plain),
                           (lite, st.node_state_lite_plain)):
            want = list(vars(plain(lib, lay, uu, tg, p, tk)).values())
            th.assert_fields_close(got, want, rtol, afrac,
                                   [f"{label} field{i}"
                                    for i in range(len(want))])
        if label == "flags":
            assert bool(full[2][3]) and bool(full[2][7])
        for i, j in ((0, 0), (1, 1), (2, 2), (5, 4), (7, 5)):
            assert torch.equal(full[i], lite[j]), (label, i)


@pytest.mark.cuda
@pytest.mark.parametrize("ns,dtype", T2_SPECIES,
                         ids=[f"{ns}sp-{dt}" for ns, dt in T2_SPECIES])
def test_t2_clip_every_instance(card, tmp_path, ns, dtype):
    """CLIPPING_TEMPRATURE in T2 at every instance, full and lite: with a
    guess 10 % off at half the nodes (the clip binds there) against
    node_state_plain / node_state_lite_plain with the clip, at the
    tolerances of test_t2_every_species_instance; guessed at the
    unclipped solve's own T (the clip cannot bind), the clipped outputs
    equal the unclipped ones bit for bit, so the clip adds no rounding
    where it stays off (chip_smoke.py --bitwise holds the unclipped T2
    against the parent commit's build)."""
    from dataclasses import replace
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.chemistry import library as tl
    dt = getattr(torch, dtype)
    man = th.cases.write_library(str(tmp_path))
    lib64 = th.cases.species_cut(tl.load_library(man), ns).to(card)
    lib = th.cases.species_cut(tl.load_library(man, None, dt), ns).to(card)
    lay = st.Layout(2, ns)

    def h_rgas(t, ys):
        tt, yy = th.tt(t).to(card), th.tt(ys).to(card)
        return (th.npy(tl.mixture_enthalpy_plain(lib64, tt, yy)),
                th.npy(tl.mixture_rgas(lib64, yy)))

    u, t_guess, tke = th.random_conserved(h_rgas, ns, 2, N, seed=5)
    off = t_guess * np.where(np.random.default_rng(6).random(N) < 0.5, 1.1,
                             1.0)
    clip = st.TSolveParams(clip_temp=True)
    rtol, afrac = (1e-10, 1e-12) if dtype == "float64" else (2e-4, 1e-6)
    uu, tk = th.tt(u, dt).to(card), th.tt(tke, dt).to(card)
    for lite, plain in ((False, st.node_state_plain),
                        (True, st.node_state_lite_plain)):
        tg = th.tt(off, dt).to(card)
        got = kernels.node_state(lib, lay, clip, uu, tg, tk, lite=lite)
        want = list(vars(plain(lib, lay, uu, tg, clip, tk)).values())
        th.assert_fields_close(got, want, rtol, afrac,
                               [f"clip field{i}" for i in range(len(want))])
        free = kernels.node_state(lib, lay, replace(clip, clip_temp=False),
                                  uu, tg, tk, lite=lite)
        assert 0 < int(((free[1][:, 0] - got[1][:, 0]).abs() > 1.0).sum()) \
            < N
        tg = kernels.node_state(lib, lay, replace(clip, clip_temp=False),
                                uu, th.tt(t_guess, dt).to(card), tk,
                                lite=lite)[1][:, 0].contiguous()
        on = kernels.node_state(lib, lay, clip, uu, tg, tk, lite=lite)
        free = kernels.node_state(lib, lay, replace(clip, clip_temp=False),
                                  uu, tg, tk, lite=lite)
        assert bool(((free[1][:, 0] / tg - 1.0).abs() < 0.01).all())
        for a, b in zip(on, free):
            assert torch.equal(a, b)


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


# K7's stencils on the card, (n, offsets, d): the 2D quad channel's 4
# offsets and the 3D hex box's 6 (kernels.K7_STENCILS, compiled), 8 2D and
# 5 3D offsets and 2 on a 90-node ring whose window wraps more than once
# (the run-time-K instance); n is no multiple of any window
K7_CASES = {"2d-k4": (2037, (-37, -1, 1, 37), 2),
            "3d-k6": (1530, (-90, -9, -1, 1, 9, 90), 3),
            "2d-k8": (1111, (-38, -37, -36, -1, 1, 36, 37, 38), 2),
            "3d-k5": (999, (-100, -1, 1, 10, 100), 3),
            "ring-k2": (90, (-89, 3), 2)}


def _k7_mesh(card, n, offsets, d, dtype, seed):
    """Random coefficients, boundary normals and volumes (a tenth of them
    0: GG divides those by 1) of a stencil mesh on the card."""
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    k = len(offsets)
    t = lambda a: th.tt(a, dtype).to(card)
    vol = np.where(rng.random(n) < 0.1, 0.0, rng.uniform(0.5, 2.0, n))
    return SimpleNamespace(
        npoint=n, ndim=d, stencil_offsets=offsets,
        wls_coeff=t(rng.standard_normal((k, n, d))),
        gg_snormal=t(rng.standard_normal((k, n, d))),
        bnd_accum_normal=t(rng.standard_normal((n, d))), volume=t(vol))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["WLS", "GG"])
@pytest.mark.parametrize("stencil", list(K7_CASES))
def test_k7_forms_match_plain(card, monkeypatch, stencil, mode, dtype):
    """K7's window form as kernels.k7_plan picks it and forced to 128 and
    256 nodes (windows that wrap past 0 and n), and its streamed form
    (window=0), at nG = 1, 2, 13, 15 and on a q whose storage starts 4
    bytes past a 16-byte boundary, against gradient_rows_plain at
    chip_smoke.py's K7 tolerances (f64 rtol 1e-11, atol 1e-13 of the max;
    f32 1e-5, 1e-6); every fresh tensor of the wrapper NaN-filled; one
    launch a call."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import gradients_tiled as tg
    n, offs, d = K7_CASES[stencil]
    mesh = _k7_mesh(card, n, offs, d, dtype, seed=n)
    assert ((len(offs), d) in kernels.K7_STENCILS) == (stencil in
                                                       ("2d-k4", "3d-k6"))
    gg = mode == "GG"
    coef = mesh.gg_snormal if gg else mesh.wls_coeff
    extra = (mesh.bnd_accum_normal, mesh.volume) if gg else (None, None)
    rtol, afrac = (1e-11, 1e-13) if dtype == torch.float64 else (1e-5, 1e-6)
    rng = np.random.default_rng(7)
    empty = torch.empty

    def nan_empty(*a, **kw):
        t = empty(*a, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    for ng in (1, 2, 13, 15):
        qs = [th.tt(rng.standard_normal((n, ng)), dtype).to(card)]
        if ng == 13:
            buf = th.tt(rng.standard_normal(n * ng + 1), dtype).to(card)
            qs.append(buf[1:].view(n, ng))
        for q in qs:
            want = th.npy(tg.gradient_rows_plain(mesh, q, mode))
            for window in (None, 0, 128, 256):
                plan = kernels.k7_plan(n, ng, offs, q.element_size(), window)
                assert plan.form == ("streamed" if window == 0
                                     else "window")
                monkeypatch.setattr(torch, "empty", nan_empty)
                kernels.reset_launches()
                got = kernels.gradient_rows(q, coef, offs, *extra,
                                            window=window)
                torch.cuda.synchronize()
                monkeypatch.setattr(torch, "empty", empty)
                assert kernels.launches["gradient_rows"] == 1
                np.testing.assert_allclose(
                    th.npy(got), want, rtol=rtol,
                    atol=afrac * np.abs(want).max(),
                    err_msg=f"nG {ng} window {window} plan {plan}")


# T4's (species, reactions) shapes: the compiled (9, 2) and (3, 2) (the
# case cut to 3 species; kernels.CHEM_SHAPES) and the run-time instance at
# 1, 5 and 16 species
T4_SPECIES = [(ns, dt) for ns in (9, 3, 1, 5, 16)
              for dt in ("float64", "float32")]


def t4_gas(ns, n, seed):
    """Random (T, rho, Y, omega_t) at ns species with vanishing species (Y
    = 0 and 1e-16: the kernel's guards)."""
    t, rho, ys, omt = th.random_gas(max(ns, 3), n, seed)
    ys = ys[:, :ns] / np.maximum(ys[:, :ns].sum(1, keepdims=True), 1e-300)
    ys[: n // 4, 0] = 0.0
    ys[n // 4: n // 2, -1] = 1e-16
    return t, rho, ys, omt


@pytest.mark.cuda
@pytest.mark.parametrize("ns,dtype", T4_SPECIES,
                         ids=[f"{ns}sp-{dt}" for ns, dt in T4_SPECIES])
def test_t4_every_instance(card, tmp_path, monkeypatch, ns, dtype):
    """T4 at its compiled (S, R) shapes and its run-time instance, both
    chemistry variants of the case (backward rates from Keq, and the
    second reaction's explicit backward Arrhenius rate), PaSR on and off,
    on contiguous inputs and on the column views of primitive rows and a
    turbulence state (as chemistry_source_residual passes them), against
    chemistry_source_plain at chip_smoke.py's T4 tolerances (f64 rtol
    1e-9, atol 1e-12 of the max; f32 5e-3, 2e-5); every fresh tensor of
    the wrapper NaN-filled; one launch a call."""
    for backward in (False, True):
        _t4_check(card, tmp_path / str(backward), monkeypatch, ns, dtype,
                  backward)


def _t4_check(card, path, monkeypatch, ns, dtype, backward):
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.chemistry import library as tl
    from su2_tpu_torch.solvers import euler as es
    dt = getattr(torch, dtype)
    path.mkdir()
    man = th.cases.write_library(str(path), backward)
    lib = th.cases.species_cut(tl.load_library(man, None, dt), ns).to(card)
    assert ((ns, lib.nreactions) in kernels.CHEM_SHAPES) == (ns in (9, 3))
    lay = st.Layout(2, ns)
    t, rho, ys, omt = (th.tt(a, dt).to(card) for a in t4_gas(ns, N, 6))
    v = torch.full((N, lay.nprim), float("nan"), dtype=dt, device=card)
    v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:] = t, rho, ys
    turb = torch.stack([torch.ones_like(omt), omt], dim=1)
    layouts = {"contiguous": (t, rho, ys, omt),
               "rows": (v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:],
                        turb[:, 1])}
    rtol, afrac = (1e-9, 1e-12) if dtype == "float64" else (5e-3, 2e-5)
    empty = torch.empty

    def nan_empty(*a, **kw):
        x = empty(*a, **kw)
        return x.fill_(float("nan")) if x.is_floating_point() else x

    for label, (a, b, c, o) in layouts.items():
        for pasr in (True, False):
            monkeypatch.setattr(torch, "empty", nan_empty)
            kernels.reset_launches()
            got = kernels.chem_source(lib, _Prm, a, b, c, o if pasr else None)
            torch.cuda.synchronize()
            monkeypatch.setattr(torch, "empty", empty)
            assert kernels.launches["chem_source"] == 1
            want = th.npy(es.chemistry_source_plain(
                lib, _Prm, t, rho, ys, omt if pasr else None))
            np.testing.assert_allclose(
                th.npy(got), want, rtol=rtol,
                atol=afrac * np.abs(want).max(),
                err_msg=f"{label}, PaSR {pasr}, backward {backward}")


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


def _run_launches(sim, niter=3):
    """(sim.run(niter)'s result, the kernel launches of that run): a
    one-iteration run first captures the step's CUDA graph, so the run's
    launches are its replays', niter times the capture's (no wrapper runs
    in a replay)."""
    from su2_tpu_torch import kernels
    sim.run(1, quiet=True)
    kernels.reset_launches()
    out = sim.run(niter, quiet=True)
    counts = dict(kernels.launches)
    assert counts == {k: niter * c for k, c in sim._graph.per_replay.items()}
    return out, counts


@pytest.mark.cuda
def test_slice_launches_every_kernel(card, tmp_path):
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    sim = Simulation(Config(text=th.write_case(tmp_path)),
                     raw_mesh=channel_mesh(*th.CHANNEL), device=card)
    (_, _, hist, _), launched = _run_launches(sim)
    assert np.isfinite(hist).all()
    assert launched["node_state"] == 6
    assert launched["edge_flux"] == 3
    assert launched["chem_source"] == 3
    assert launched["mixture_enthalpy"] >= 3
    # LU_SGS at 153 nodes: the whole FGMRES cycle in one launch
    assert launched["stencil_fgmres"] == 3
    assert launched["stencil_sgs_matvec"] == 0
    # below the tier: no gradient rows, no windowed edge kernel
    assert launched["gradient_rows"] == 0
    assert launched["edge_win"] == 0
    assert launched["inlet_tc"] == 0


@pytest.mark.cuda
def test_slice_launches_in_the_tier(card, tmp_path, monkeypatch):
    """The tier forced at 153 nodes: K8 once and T3 never per iteration,
    K7 for the flow sweep and the merged turbulence sweep (two per
    iteration: the case's methods match); the TOTAL_CONDITIONS inlet
    launches K9 once per iteration."""
    from su2_tpu_torch.ops import gradients
    monkeypatch.setattr(gradients, "TILED_MIN_NODES", 0)
    sim = _card_sim(card, th.case_variant(th.write_case(tmp_path),
                                          "total_conditions"))
    (_, _, hist, _), launched = _run_launches(sim)
    assert np.isfinite(hist).all()
    assert launched["edge_win"] == 3
    assert launched["edge_flux"] == 0
    assert launched["gradient_rows"] == 6
    assert launched["inlet_tc"] == 3
    assert launched["node_state"] == 6


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


K10_SPECIES = [(ns, var, dt) for ns in (9, 3, 5) for var in K10_VARIANTS
               for dt in ("float64", "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,variant,dtype", K10_SPECIES,
                         ids=[f"{ns}-{var}-{dt}"
                              for ns, var, dt in K10_SPECIES])
def test_k10_every_species_instance(card, tmp_path, ns, variant, dtype):
    """K10 at 9 and 3 species (its compiled instances) and 5 (the
    run-time-count instance), every (MUSCL, limiter) variant, on a cut of
    the case's library (torch_helpers.implicit_shape_inputs) against
    edge_implicit_plain: each output row of each family within 1e-10 (f64)
    or 1e-4 (f32) of the row's max; the pad slots exactly 0."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_implicit as ei
    muscl, limiter = K10_VARIANTS[variant]
    _, args = th.implicit_shape_inputs(ns, tmp_path, getattr(torch, dtype),
                                       card)
    args = args[:8] + (muscl, limiter is not None)
    kernels.reset_launches()
    got = kernels.edge_implicit(*args)
    assert kernels.launches["edge_implicit"] == 1
    want = ei.edge_implicit_plain(*args)
    pad = th.npy((args[6] == 0).all(-1))
    tol = 1e-10 if dtype == "float64" else 1e-4
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
    from su2_tpu_torch.ops import gradients
    text = th.with_implicit(th.write_case(tmp_path))
    for tier in (False, True):
        if tier:
            monkeypatch.setattr(gradients, "TILED_MIN_NODES", 0)
        sim = _card_sim(card, text)
        (_, _, hist, _), launched = _run_launches(sim)
        assert np.isfinite(hist).all()
        want = {"edge_implicit": 3, "node_state": 6, "edge_flux": 0,
                "edge_win": 0, "chem_source": 0, "stencil_fgmres": 0,
                "stencil_sgs_matvec": 0, "gradient_rows": 6 * tier}
        assert {k: launched[k] for k in want} == want
        assert launched["mixture_enthalpy"] >= 3


# the tiers of the implicit LU_SGS case at 153 nodes: (dtype, forced
# predicates of linalg/stencil_solve.py, K6 and K5 launches per iteration)
LUSGS_TIERS = {
    "one-launch-f64": (torch.float64, {}, 2, 0),
    "one-launch-f32": (torch.float32, {}, 2, 0),
    # past the full-precision gate: the mixed one-launch tier
    "mixed-f32": (torch.float32,
                  {"supported": lambda n, k, v, dt, nc=None:
                   dt == torch.bfloat16}, 2, 0),
    # past every one-launch gate: K5 (z, A z) ten times per solve
    "per-iteration-f32": (torch.float32,
                          {"fgmres_supported": lambda *a, **k: False,
                           "fgmres_mixed_supported": lambda *a, **k: False},
                          0, 20)}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", list(LUSGS_TIERS))
def test_implicit_lusgs_slice_launches(card, tmp_path, monkeypatch, tier):
    """The implicit LU_SGS case (the flow's 13 x 13 and the SST's 2 x 2
    systems through the multicolor sweep): K6 once per solve where the
    one-launch predicate holds (two per iteration), else K5 once per
    Krylov vector (FGMRES(10): 20 per iteration); K10 once and T2 twice
    per iteration, T3, K8 and T4 never; the flow's sweep blocks bf16 in
    the mixed tier."""
    from su2_tpu_torch.linalg import blockcsr, stencil_solve as ts
    dtype, patch, k6, k5 = LUSGS_TIERS[tier]
    for name, fn in patch.items():
        monkeypatch.setattr(ts, name, fn)
    sweep_dtypes = []
    make = blockcsr.make_solver_ops_stencil_t

    def spy(*a, **kw):
        ops = make(*a, **kw)
        sweep_dtypes.append(ops[2].__self__.sel_t.dtype)
        return ops
    monkeypatch.setattr(blockcsr, "make_solver_ops_stencil_t", spy)
    sim = _card_sim(card, th.with_implicit(th.write_case(tmp_path),
                                           prec="LU_SGS"), dtype)
    (_, _, hist, _), launched = _run_launches(sim)
    assert np.isfinite(hist).all()
    want = {"stencil_fgmres": 3 * k6, "stencil_sgs_matvec": 3 * k5,
            "edge_implicit": 3, "node_state": 6, "edge_flux": 0,
            "edge_win": 0, "chem_source": 0, "gradient_rows": 0}
    assert {k: launched[k] for k in want} == want
    # the flow's system, then the SST's, in every eager iteration: the
    # graph's warm-up and its capture (the replays run no Python)
    sweep = torch.bfloat16 if tier == "mixed-f32" else dtype
    assert sweep_dtypes == [sweep] * 4


BANDS = {"band2": (2, (-9, -8, -7, -1, 1, 7, 8, 9)),
         "band3": (3, (-5, -1, 1, 5)),
         "band7": (7, (-9, -1, 1, 9)),
         "band13": (13, (-9, -1, 1, 9))}
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


def _k5_check(args, r, variant, mode="sgs_matvec", **layout):
    """K5 through the wrapper (with the layout given, if any) against the
    plain natural-layout version at test_k5_kernel_matches_plain's pins."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    sweep, matvec = mode != "matvec", mode != "sgs"
    got = kernels.stencil_sgs_matvec(**dict(args, **layout), r=r,
                                     sweep=sweep, matvec=matvec)
    want = ts.sgs_matvec_plain(**args, r=r, sweep=sweep, matvec=matvec)
    rtol, afrac = (1e-11, 1e-13) if variant == "float64" else (1e-5, 1e-6)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = th.npy(w)
        np.testing.assert_allclose(th.npy(g), w, rtol=rtol,
                                   atol=afrac * np.abs(w).max())


def _cm_layout(args):
    from su2_tpu_torch.linalg import stencil_solve as ts
    order = ts.color_order(args["colors"])
    selp, dinv = ts.to_color_major(order, args["selm_t"], args["dinv_t"],
                                args["selp_t"].dtype)
    return order, dict(selp_t=selp, dinv_t=dinv, order=order,
                       color_major=True)


K5_COLORINGS = [(c, v, var) for c in th.COLORINGS for v in (2, 3, 7, 13)
                for var in VARIANTS]


@pytest.mark.cuda
@pytest.mark.parametrize("coloring,v,variant", K5_COLORINGS,
                         ids=[f"{c}-v{v}-{var}"
                              for c, v, var in K5_COLORINGS])
def test_k5_colorings(card, coloring, v, variant):
    """K5's passes over the color-major node list on proper colorings with
    2, 3 and 4 colors and on masks that are not a proper coloring (the
    two-buffer rule decides the numbers), at every compiled width: the
    sweep blocks and dinv in the color-major lane layout and in the
    natural one (and the node list made by the wrapper), sweep + matvec
    and sweep only, against the plain version."""
    offsets, nc = th.COLORINGS[coloring]
    dtype = torch.float64 if variant == "float64" else torch.float32
    args, r = th.stencil_args(th.band_system(2000, v, offsets, nc, seed=5),
                              dtype, mixed=variant == "mixed", device=card)
    order, cm = _cm_layout(args)
    for mode in ("sgs_matvec", "sgs"):
        _k5_check(args, r, variant, mode, **cm)
        _k5_check(args, r, variant, mode, order=order)
        _k5_check(args, r, variant, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [2037, 37])
def test_k5_ragged_n_and_empty_color(card, n, variant):
    """n not a multiple of the 256-thread block (and smaller than one),
    and a color with no node (colors 0, 2, 3 of 4), v = 13, both
    layouts."""
    offsets, _ = th.COLORINGS["proper4"]
    dtype = torch.float64 if variant == "float64" else torch.float32
    s = th.recolor(th.band_system(n, 13, offsets, 4, seed=6),
                   np.array([(0, 2, 3)[p % 3] for p in range(n)]), 4)
    args, r = th.stencil_args(s, dtype, mixed=variant == "mixed",
                              device=card)
    assert int((args["colors"] == 1).sum()) == 0
    order, cm = _cm_layout(args)
    _k5_check(args, r, variant, **cm)
    _k5_check(args, r, variant, order=order)


@pytest.mark.cuda
@pytest.mark.parametrize("sel_dtype", [torch.bfloat16, None],
                         ids=["mixed", "f32"])
def test_stencil_solve_ops_layout_on_card(card, sel_dtype):
    """On the card StencilSolveOps makes the node order once per colors
    tensor (for K5, and for K6 at v >= 7); in the mixed tier it holds the
    bf16 sweep blocks and dinv color-major, at full precision the natural
    blocks.  At v = 7 precond_matvec (K5) and fgmres (K6, one_launch or
    not) equal the plain versions on the natural blocks; at v = 2 the
    one-launch layout stays natural with no order, and K6 refuses blocks
    laid out color-major for K5."""
    from types import SimpleNamespace
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    args, r = th.stencil_args(th.band_system(2000, 7, (-9, -1, 1, 9), 2),
                              torch.float32, mixed=sel_dtype is not None,
                              device=card)
    n = r.shape[0]
    mesh = SimpleNamespace(stencil_offsets=args["offsets"])
    blk = lambda t, v=7: t.T.reshape(n, v, v)
    mk = lambda a, v=7, **kw: ts.StencilSolveOps(
        mesh, a["selm_t"], blk(a["dinv_t"], v), blk(a["diag_t"], v),
        a["colors"], a["ncolor"], sel_dtype=sel_dtype, **kw)
    ops = mk(args)
    assert ops.order.dtype == torch.int32
    assert ops.color_major == (sel_dtype is not None)
    kernels.reset_launches()
    got = ops.precond_matvec(r)
    assert kernels.launches["stencil_sgs_matvec"] == 1
    want = ts.sgs_matvec_plain(**args, r=r)
    for g, w in zip(got, want):
        w = th.npy(w)
        np.testing.assert_allclose(th.npy(g), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
    one = mk(args, one_launch=True)
    assert one.order is ops.order
    assert one.color_major == ops.color_major
    wx, _, wit = ts.fgmres_plain(**args, b=r, m=10, tol=1e-6)
    for o in (ops, one):
        x, _, it = o.fgmres(r, 10, 1e-6)
        assert int(it) == int(wit)
        assert np.abs(th.npy(x) - th.npy(wx)).max() \
            <= 2e-5 * np.abs(th.npy(wx)).max()
    args2, r2 = th.stencil_args(th.band_system(2000, 2, (-9, -1, 1, 9), 2),
                                torch.float32, mixed=sel_dtype is not None,
                                device=card)
    one2 = mk(args2, 2, one_launch=True)
    assert one2.order is None and not one2.color_major
    if sel_dtype is not None:
        with pytest.raises(ValueError):
            mk(args2, 2).fgmres(r2, 10, 1e-6)


K6_CASES = [(v, r) for v in VARIANTS for r in ("random", "tight", "scaled")
            ] + [("float64", "zero")]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,rhs", K6_CASES)
@pytest.mark.parametrize("system", list(BANDS))
def test_k6_kernel_matches_plain(card, system, variant, rhs):
    """K6 (one launch: a cooperative grid at v = 7, 13, a cluster of 8 or
    16 CTAs at v = 2, 3) against the plain FGMRES(10) over the
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
    n, v = r.shape
    grid = kernels.stencil_fgmres_grid(
        r.dtype, args["selp_t"].dtype == torch.bfloat16, v, n, 10)
    if v >= kernels.K6_ROWS_MIN_V:
        assert 1 <= grid <= -(-n // (32 * kernels.k6_groups(v)))
    else:
        assert grid in (8, 16)          # the cluster's CTAs
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


K6_COLORINGS = [(c, v, var) for c in th.COLORINGS for v in (7, 13)
                for var in VARIANTS]


@pytest.mark.cuda
@pytest.mark.parametrize("coloring,v,variant", K6_COLORINGS,
                         ids=[f"{c}-v{v}-{var}"
                              for c, v, var in K6_COLORINGS])
def test_k6_colorings(card, coloring, v, variant):
    """K6 at v = 7 and 13 (the warp-per-row kernel over the color-major
    node list) on proper colorings with 2, 3 and 4 colors and on masks
    that are not a proper coloring, with the sweep blocks and dinv in the
    color-major lane layout and in the natural one: equal iterations to
    the plain FGMRES(10), x at test_k6_kernel_matches_plain's pins (tol
    1e-8 in f64; in f32 tol 1e-12, every iteration, as its 'tight' case:
    an f32 cycle that stops near its rounding level stops at an iteration
    the summation order decides)."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    offsets, nc = th.COLORINGS[coloring]
    dtype = torch.float64 if variant == "float64" else torch.float32
    args, r = th.stencil_args(th.band_system(2037, v, offsets, nc, seed=5),
                              dtype, mixed=variant == "mixed", device=card)
    order, cm = _cm_layout(args)
    tol = 1e-8 if variant == "float64" else 1e-12
    wx, wrel, wit = ts.fgmres_plain(**args, b=r, m=10, tol=tol)
    scale = max(np.abs(th.npy(wx)).max(), 1e-300)
    for layout in (cm, dict(order=order), {}):
        kernels.reset_launches()
        x, rel, it = kernels.stencil_fgmres(**dict(args, **layout), b=r,
                                            m=10, tol=tol)
        assert kernels.launches["stencil_fgmres"] == 1
        assert int(it) == int(wit)
        x = th.npy(x)
        if variant == "float64":
            np.testing.assert_allclose(x, th.npy(wx), rtol=1e-9,
                                       atol=1e-12 * scale)
        else:
            assert np.abs(x - th.npy(wx)).max() <= 2e-5 * scale


K6_BIG = [(v, var) for v in (7, 13) for var in VARIANTS]


@pytest.mark.cuda
@pytest.mark.parametrize("v,variant", K6_BIG,
                         ids=[f"v{v}-{var}" for v, var in K6_BIG])
def test_k6_rows_kernel_many_groups(card, v, variant):
    """K6 at v = 7 and 13 on 30,011 nodes (more 32-node groups than the
    grid has group slots, so blocks walk several groups a pass) over the
    color-major layout, two right sides in turn on fresh workspaces, each
    against the plain FGMRES(10) at test_k6_colorings' pins: no phase
    reads an entry that another thread writes in the same phase (the
    first sweep pass once read v_0 before its grid barrier)."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    offsets, nc = th.COLORINGS["proper2"]
    dtype = torch.float64 if variant == "float64" else torch.float32
    args, r = th.stencil_args(th.band_system(30011, v, offsets, nc, seed=8),
                              dtype, mixed=variant == "mixed", device=card)
    n = r.shape[0]
    groups = -(-n // 32)
    assert kernels.stencil_fgmres_grid(
        dtype, variant == "mixed", v, n, 10) * kernels.k6_groups(v) < groups
    _, cm = _cm_layout(args)
    tol = 1e-8 if variant == "float64" else 1e-12
    rng = np.random.default_rng(3)
    for b in (r, th.tt(rng.standard_normal(tuple(r.shape)), dtype).to(card)):
        x, _, it = kernels.stencil_fgmres(**dict(args, **cm), b=b, m=10,
                                          tol=tol)
        wx, _, wit = ts.fgmres_plain(**args, b=b, m=10, tol=tol)
        assert int(it) == int(wit)
        x, wx = th.npy(x), th.npy(wx)
        scale = max(np.abs(wx).max(), 1e-300)
        if variant == "float64":
            np.testing.assert_allclose(x, wx, rtol=1e-9, atol=1e-12 * scale)
        else:
            assert np.abs(x - wx).max() <= 2e-5 * scale


K6_CLUSTER_SIZES = [(v, n, var, c) for v in (2, 3)
                    for n in (700, 9072, 12288) for var in VARIANTS
                    for c in (16, 8)]


def _k6_pins(x, wx, variant):
    """test_k6_colorings' pins on x against the plain cycle's wx."""
    x, wx = th.npy(x), th.npy(wx)
    scale = max(np.abs(wx).max(), 1e-300)
    if variant == "float64":
        np.testing.assert_allclose(x, wx, rtol=1e-9, atol=1e-12 * scale)
    else:
        assert np.abs(x - wx).max() <= 2e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("v,n,variant,cluster", K6_CLUSTER_SIZES,
                         ids=[f"v{v}-{n}-{var}-c{c}"
                              for v, n, var, c in K6_CLUSTER_SIZES])
def test_k6_cluster_sizes(card, monkeypatch, v, n, variant, cluster):
    """K6 at v = 2, 3 (one thread-block cluster of 16 or 8 CTAs of 1,024
    threads, forced by stencil_fgmres's cluster; the resident form where
    every node has a thread, the streamed one past 8,192 nodes at 8 CTAs
    and in f64 at v = 3) on a field smaller than one CTA (700 nodes), at
    the flagship 9,072 nodes and at the one-launch tier's cap of 12,288
    (stencil_solve._fgmres_cap(10)), on a proper 2-coloring, against the
    plain FGMRES(10) at test_k6_colorings' pins (tol 1e-8 in f64, 1e-12
    otherwise): two right sides solved in turn, each on fresh memory
    filled with NaN (every torch.empty of the wrapper), so no phase reads
    an entry before the barrier after the phase that writes it; and the
    same solve twice, equal bit for bit (the reductions are
    deterministic)."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    offsets, nc = th.COLORINGS["proper2"]
    dtype = torch.float64 if variant == "float64" else torch.float32
    args, r = th.stencil_args(th.band_system(n, v, offsets, nc, seed=9),
                              dtype, mixed=variant == "mixed", device=card)
    assert kernels.stencil_fgmres_grid(dtype, variant == "mixed", v, n, 10,
                                       cluster=cluster) == cluster
    tol = 1e-8 if variant == "float64" else 1e-12
    empty = torch.empty

    def nan_empty(*a, **kw):
        t = empty(*a, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    rng = np.random.default_rng(4)
    for b in (r, th.tt(rng.standard_normal(tuple(r.shape)), dtype).to(card)):
        monkeypatch.setattr(torch, "empty", nan_empty)
        kernels.reset_launches()
        x, rel, it = kernels.stencil_fgmres(**args, b=b, m=10, tol=tol,
                                            cluster=cluster)
        assert kernels.launches["stencil_fgmres"] == 1
        monkeypatch.setattr(torch, "empty", empty)
        wx, _, wit = ts.fgmres_plain(**args, b=b, m=10, tol=tol)
        assert int(it) == int(wit)
        _k6_pins(x, wx, variant)
        x2, rel2, it2 = kernels.stencil_fgmres(**args, b=b, m=10, tol=tol,
                                               cluster=cluster)
        assert torch.equal(x2, x) and torch.equal(rel2, rel) \
            and int(it2) == int(it)


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


def _k11_inputs(card, tmp_path, dtype):
    """K11's operands on the laminar implicit case's family slots: the
    face states of the port's own MUSCL reconstruction (limited) and of
    first order, feature-major, with zero normals on the pad slots."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    text = th.with_implicit(th.cases.with_laminar(th.write_case(tmp_path)))
    sim = _card_sim(card, text, dtype)
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    u = th.tt(th.mixed_state(sim, seed=4), dtype).to(card)
    nsd = st.node_state_plain(lib, lay, u, sim.t0, sim.tparams)
    grad = es.compute_gradients(mesh, prm,
                                vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs))
    g = grad[:, :2 + lay.ndim]
    lim = limiters.venkatakrishnan(mesh, es.gradient_vars(lay, nsd.v), g,
                                   prm.limiter_coeff, prm.ref_elem_length)
    v_i, s_i, v_j, s_j = es.muscl_reconstruct_fam(
        lib, lay, mesh, prm, nsd.v, g.permute(1, 2, 0), lim)
    normal = mesh.fam_normal_flat.T.contiguous()
    return sim, (v_i, v_j, normal, s_i, s_j)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["feature_major", "edge_major"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k11_kernel_matches_plain(card, tmp_path, dtype, layout):
    """K11 against its plain version (ops/ausm_t.ausm_flux_t) on the
    laminar implicit case's family-slot inputs, in both layouts: every
    output within 1e-12 (f64) or 1e-5 (f32, fused multiply-adds) of its
    field's max, relative 1e-10 / 1e-4 per entry; the pad slots exactly
    0; one launch per call."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import ausm_t
    sim, ins = _k11_inputs(card, tmp_path, dtype)
    lay, m_inf = sim.lay, sim.params.m_infty
    want = ausm_t.ausm_flux_t(lay, *ins[:3], m_inf, *ins[3:])
    kernels.reset_launches()
    if layout == "feature_major":
        got = kernels.ausm_flux_jac(lay, *ins[:3], m_inf, *ins[3:])
    else:
        got = kernels.ausm_flux_jac(lay, *(x.T for x in ins[:3]), m_inf,
                                    *(x.T for x in ins[3:]),
                                    edge_major=True)
        got = (got[0].T, got[1].permute(1, 2, 0), got[2].permute(1, 2, 0))
    assert kernels.launches["ausm_flux_jac"] == 1
    pad = th.npy(~sim.mesh.fam_valid_flat)
    assert pad.any()
    rtol, afrac = (1e-10, 1e-12) if dtype == torch.float64 else (1e-4, 1e-5)
    for g, w in zip(got, want):
        g, w = th.npy(g).astype(np.float64), th.npy(w).astype(np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert (np.abs(g - w) <= rtol * np.abs(w)
                + afrac * np.abs(w).max()).all()
        assert (g[..., pad] == 0.0).all()


K11_SPECIES = [(ns, lay, dt) for ns in (3, 5)
               for lay in ("feature_major", "edge_major")
               for dt in ("float64", "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,layout,dtype", K11_SPECIES,
                         ids=[f"{ns}-{lay}-{dt}"
                              for ns, lay, dt in K11_SPECIES])
def test_k11_other_species_counts(card, ns, layout, dtype):
    """K11 at 3 and 5 species (its run-time-count instance; 9 is
    compiled) on random face states (torch_helpers.ausm_edge_inputs)
    against ops/ausm_t.ausm_flux_t, both layouts, at
    test_k11_kernel_matches_plain's pins; the pad slots exactly 0."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import ausm_t
    from su2_tpu_torch.state import Layout
    lay = Layout(2, ns)
    assert ns not in kernels.AUSM_SPECIES
    dt = getattr(torch, dtype)
    r = th.ausm_edge_inputs(lay)
    ins = [th.tt(r[k].T, dt).to(card).contiguous()
           for k in ("v_i", "v_j", "normal", "s_i", "s_j")]
    m_inf = 0.0251
    want = ausm_t.ausm_flux_t(lay, *ins[:3], m_inf, *ins[3:])
    kernels.reset_launches()
    if layout == "feature_major":
        got = kernels.ausm_flux_jac(lay, *ins[:3], m_inf, *ins[3:])
    else:
        got = kernels.ausm_flux_jac(lay, *(x.T for x in ins[:3]), m_inf,
                                    *(x.T for x in ins[3:]),
                                    edge_major=True)
        got = (got[0].T, got[1].permute(1, 2, 0), got[2].permute(1, 2, 0))
    assert kernels.launches["ausm_flux_jac"] == 1
    pad = (r["normal"] == 0.0).all(1)
    rtol, afrac = (1e-10, 1e-12) if dtype == "float64" else (1e-4, 1e-5)
    for g, w in zip(got, want):
        g, w = th.npy(g).astype(np.float64), th.npy(w).astype(np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert (np.abs(g - w) <= rtol * np.abs(w)
                + afrac * np.abs(w).max()).all()
        assert (g[..., pad] == 0.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_laminar_slice_launches(card, tmp_path, implicit):
    """The laminar case on the card: implicit (LU_SGS), K11 once per
    iteration and K6 once (the flow's solve, one launch at 153 nodes), T2
    once; explicit, T4 and T2 once per iteration; K10, T3, K8 never (no
    SST fields), K11 never in the explicit step."""
    text = th.cases.with_laminar(th.with_prec(th.write_case(tmp_path),
                                              "LU_SGS"))
    if implicit:
        text = th.with_implicit(text, prec="LU_SGS")
    sim = _card_sim(card, text)
    (u, _, hist), launched = _run_launches(sim)
    assert np.isfinite(hist).all() and torch.isfinite(u).all()
    want = {"ausm_flux_jac": 3 * implicit, "stencil_fgmres": 3 * implicit,
            "stencil_sgs_matvec": 0, "chem_source": 3 * (not implicit),
            "node_state": 3, "edge_implicit": 0, "edge_flux": 0,
            "edge_win": 0, "gradient_rows": 0, "inlet_tc": 0}
    assert {k: launched[k] for k in want} == want


def _k12_inputs(card, dtype, feature_major=False, seed=12):
    """K12's operands on the 153-node channel: random fields (every source
    branch taken, a wall strip), rho and the velocity as columns of the
    primitive rows and the (k, omega) gradients as a slice of a wider
    gradient set, node-major or (feature_major) a view of the >= 200k-node
    tier's gradient rows, as the step hands them over."""
    from su2_tpu_torch.geometry.dual_grid import build_dual_grid
    from su2_tpu_torch.geometry.mesh_data import mesh_arrays
    from su2_tpu_torch.geometry.structured import channel_mesh
    mesh = mesh_arrays(build_dual_grid(channel_mesh(*th.CHANNEL)), dtype,
                       card)
    n, d = mesh.npoint, mesh.ndim
    rng = np.random.default_rng(seed)
    t = lambda a: th.tt(a, dtype).to(card)
    prim = t(np.abs(rng.normal(1.0, 0.1, (n, 16))) + 0.5)
    prim[:, 1:1 + d] = t(rng.normal(0.0, 1.0, (n, d)))
    grads = t(rng.normal(0.0, 0.5, (n, 7, d)))
    if feature_major:
        grads = grads.reshape(n, 7 * d).T.contiguous().T.reshape(n, 7, d)
    dist = np.abs(rng.normal(0.5, 0.1, n)) + 0.01
    dist[5::13] = 0.0
    dt = 1e-4 * rng.uniform(0.5, 2.0, n)
    dt[4::17] = 0.0
    q = np.abs(rng.normal(1.0, 0.2, (n, 2))) + 0.1
    q[1::3, 1] *= 0.05
    wall = torch.zeros(n, dtype=torch.bool, device=card)
    wall[::7] = True
    from su2_tpu_torch.turbulence import sst
    args = (mesh, sst._CONSTS + (0.8,), t(q), prim[:, 4], prim[:, 1:1 + d], grads[:, 5:, :],
            t(np.abs(rng.normal(1.8e-5, 2e-6, n))),
            t(np.abs(rng.normal(1e-4, 1e-5, n))), t(dist),
            t(np.abs(rng.normal(1.0, 0.5, n))), t(rng.normal(0.0, 3.0, n)),
            t(dt), wall, t(rng.uniform(0.0, 1.0, n)),
            t(rng.uniform(0.0, 1.0, n)),
            t(np.abs(rng.normal(1e-3, 1e-3, n)) + 1e-20))
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["node_major", "feature_major"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k12_kernel_matches_plain(card, dtype, layout):
    """K12 against its plain version (turbulence/sst_assemble.
    assemble_plain) on strided inputs with a wall strip: every output row
    within 1e-12 (f64) or 1e-5 (f32) of that row's max; the wall rows'
    residual and off-diagonal blocks exactly 0; one launch per call."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.turbulence import sst_assemble as sa
    args = _k12_inputs(card, dtype, layout == "feature_major")
    assert not args[3].is_contiguous() and not args[5].is_contiguous()
    assert (args[5].stride(0) == 1) == (layout == "feature_major")
    want = sa.assemble_plain(*args)
    kernels.reset_launches()
    got = sa.sst_assemble(*args)
    assert kernels.launches["sst_assemble"] == 1
    afrac = 1e-12 if dtype == torch.float64 else 1e-5
    k = len(args[0].stencil_offsets)
    for g, w, rows in zip(got, want, (2, 2, 4 * k)):
        g, w = th.npy(g).astype(np.float64), th.npy(w).astype(np.float64)
        assert g.shape == w.shape == (rows, args[0].npoint)
        assert np.isfinite(g).all()
        assert (np.abs(g - w)
                <= afrac * np.abs(w).max(1, keepdims=True)).all()
    wall = th.npy(args[12])
    assert (th.npy(got[0])[:, wall] == 0.0).all()
    assert (th.npy(got[2])[:, wall] == 0.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_fused_slice_launches(card, tmp_path, monkeypatch, implicit):
    """SU2_TPU_SST_ASSEMBLE=pallas on a float32 card run: K12 once per
    iteration, the SST's solve in stencil_solve.fused_sst_solve_tier's
    tier (one K6 launch at 153 nodes; the implicit flow's solve one more),
    T2 twice; unset, K12 never.  Any other value raises."""
    from su2_tpu_torch.linalg import stencil_solve as ts
    from su2_tpu_torch.turbulence import sst
    text = th.write_case(tmp_path)
    if implicit:
        text = th.with_implicit(text, prec="LU_SGS")
    monkeypatch.setenv("SU2_TPU_SST_ASSEMBLE", "bogus")
    with pytest.raises(ValueError):
        _card_sim(card, text, torch.float32)
    monkeypatch.setenv("SU2_TPU_SST_ASSEMBLE", "pallas")
    try:
        sim = _card_sim(card, text, torch.float32)
        assert sst.assemble_mode() == "fused"
        (_, _, hist, _), launched = _run_launches(sim)
    finally:
        sst.set_assemble_mode("unfused")
    assert np.isfinite(hist).all()
    _, one = ts.fused_sst_solve_tier(sim.mesh.npoint, sim.mesh.stencil_offsets,
                                     torch.float32, sim.ncolor,
                                     sim.cfg.linear_solver_iter)
    assert one
    want = {"sst_assemble": 3, "stencil_fgmres": 3 * (1 + implicit),
            "stencil_sgs_matvec": 0, "node_state": 6,
            "edge_implicit": 3 * implicit}
    assert {k: launched[k] for k in want} == want
    monkeypatch.delenv("SU2_TPU_SST_ASSEMBLE")
    _, launched = _run_launches(_card_sim(card, text, torch.float32), 2)
    assert launched["sst_assemble"] == 0


def _k13_stack(sim, seed=13):
    """The feature-major stack of a perturbed reacting state on sim's mesh
    (plain node state and gradients), as fused_interior_terms builds it."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    n, dev, dt = mesh.npoint, sim.device, sim.dtype
    rng = np.random.default_rng(seed)
    u = sim.u0 * th.tt(1.0 + 0.02 * rng.standard_normal(
        tuple(sim.u0.shape)), dt).to(dev)
    nsd = st.node_state_plain(lib, lay, u, sim.t0, sim.tparams)
    grad = es.compute_gradients(mesh, prm,
                                vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs))
    turb = vis.TurbFlowData(
        tke=th.tt(rng.uniform(0.0, 5.0, n), dt).to(dev),
        mu_t=th.tt(rng.uniform(1e-5, 1e-3, n), dt).to(dev),
        grad_tke=th.tt(rng.normal(0.0, 1.0, (n, 2)), dt).to(dev),
        sigma_k=th.tt(rng.uniform(0.85, 1.0, n), dt).to(dev))
    f_all = ef.stack_inputs(lay, nsd.v, grad,
                            vis.Transport(nsd.mu, nsd.kappa), turb,
                            turb.sigma_k, nsd.dpdu[:, lay.RHOE])
    consts = (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb)
    return lib, lay, ef.species_consts_of(lib), consts, f_all


def _tri_card_sim(card, text, shape, dtype):
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    return Simulation(Config(text=text), raw_mesh=cases.tri_channel_mesh(
        *shape), dtype=dtype, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k13_kernel_matches_plain(card, tmp_path, dtype):
    """K13 (the edge terms over the edge list) against
    edge_list_flux_plain on the 9,072-node scrambled triangle channel:
    every output row within 1e-10 (f64) or 1e-4 (f32) of its max, as T3;
    one launch per call."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    sim = _tri_card_sim(card, th.write_case(tmp_path), (189, 48), dtype)
    mesh = sim.mesh
    assert mesh.stencil_offsets is None and mesh.npoint == 9072
    args = _k13_stack(sim) + (mesh.edges, mesh.edge_normal, mesh.coords)
    kernels.reset_launches()
    got = kernels.edge_list_flux(*args)
    assert kernels.launches["edge_list_flux"] == 1
    want = ef.edge_list_flux_plain(*args)
    afrac = 1e-10 if dtype == torch.float64 else 1e-4
    for g, w in zip(got, want):
        g = th.npy(g).astype(np.float64).reshape(-1, mesh.nedge)
        w = th.npy(w).astype(np.float64).reshape(-1, mesh.nedge)
        assert np.isfinite(g).all()
        assert (np.abs(g - w) <= afrac * np.abs(w).max(1, keepdims=True)).all()


def _k13_call_args(sim, seed=13):
    """kernels.edge_list_terms' arguments on sim's triangle mesh: the stack
    of _k13_stack node-major, as fused_interior_terms holds it."""
    head = _k13_stack(sim, seed)
    return head[:4] + (head[4].T.contiguous(), sim.mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k13_call_matches_plain(card, tmp_path, dtype):
    """K13's whole call (kernels.edge_list_terms: the edge pass on the
    node-major stack, then the node sums) against edge_list_terms_plain on
    the 9,072-node scrambled triangle channel: every output row within
    1e-10 (f64) or 1e-4 (f32) of its max; one launch of each kernel."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    sim = _tri_card_sim(card, th.write_case(tmp_path), (189, 48), dtype)
    args = _k13_call_args(sim)
    kernels.reset_launches()
    got = kernels.edge_list_terms(*args)
    assert (kernels.launches["edge_list_flux"],
            kernels.launches["edge_list_sum"]) == (1, 1)
    want = ef.edge_list_terms_plain(*args)
    afrac = 1e-10 if dtype == torch.float64 else 1e-4
    for g, w in zip((got[0].T, got[1][None], got[2][None]),
                    (want[0].T, want[1][None], want[2][None])):
        g, w = th.npy(g).astype(np.float64), th.npy(w).astype(np.float64)
        assert np.isfinite(g).all()
        assert (np.abs(g - w) <= afrac * np.abs(w).max(1, keepdims=True)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("which", ["tri", "quad"])
def test_k13_sums_equal_scatter_edges_mixed(card, tmp_path, which, dtype):
    """K13's node sums (kernels.edge_list_sums) equal the torch gather and
    slot sum mesh.scatter_edges_mixed on the card bit for bit: on random
    edge rows (magnitudes over 16 decades) of the 9,072-node triangle
    channel and of the quad channel's edge list, and on the edge pass's
    own rows, where the call (edge_list_terms) gives the same sums."""
    from su2_tpu_torch import kernels
    sim = (_tri_card_sim(card, th.write_case(tmp_path), (189, 48), dtype)
           if which == "tri" else
           _card_sim(card, th.write_case(tmp_path), dtype))
    mesh = sim.mesh
    rng = np.random.default_rng(16)
    rows = th.tt(rng.standard_normal((mesh.nedge, 15)) * 10.0 ** rng.uniform(
        -8, 8, (mesh.nedge, 1)), dtype).to(card)
    cases = [rows]
    if which == "tri":
        args = _k13_call_args(sim)
        flux, lc, lv = kernels.edge_list_flux(*args[:4], args[4].T,
                                              mesh.edges, mesh.edge_normal,
                                              mesh.coords)
        cases.append(torch.cat([flux.T, lc[:, None], lv[:, None]], 1))
    for r in cases:
        got = kernels.edge_list_sums(mesh, r)
        res, lams = mesh.scatter_edges_mixed(r[:, :13], r[:, 13:])
        for g, w in zip(got, (res, lams[:, 0], lams[:, 1])):
            assert torch.equal(g, w)
    if which == "tri":
        for g, w in zip(kernels.edge_list_terms(*args), got):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k13_edge_pass_reads_either_stack(card, tmp_path, dtype):
    """kernels.edge_list_flux gives the same outputs bit for bit from the
    node-major stack read in place (a transposed view, the main path's
    form) and from the feature-major stack (copied node-major first), also
    where the node-major rows start off a 16-byte boundary (copied)."""
    from su2_tpu_torch import kernels
    sim = _tri_card_sim(card, th.write_case(tmp_path), (189, 48), dtype)
    mesh = sim.mesh
    args = _k13_call_args(sim)
    geo = (mesh.edges, mesh.edge_normal, mesh.coords)
    f_nodes = args[4]
    big = torch.empty(f_nodes.numel() + 1, dtype=dtype, device=card)
    off = big[1:].view(f_nodes.shape)
    off.copy_(f_nodes)
    assert off.data_ptr() % 16 != 0
    want = kernels.edge_list_flux(*args[:4], f_nodes.T.contiguous(), *geo)
    for f_all in (f_nodes.T, off.T):
        for g, w in zip(kernels.edge_list_flux(*args[:4], f_all, *geo),
                        want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_t3_k8_k13_share_edge_side_bitwise(card, tmp_path):
    """After edge_side took the endpoint columns and the edge geometry as
    arguments, T3, K8 and K13 still run one arithmetic: in f64 on the
    stencil channel, K13 over the family slots' edges (its own
    coords[j] - coords[i] equals the host's float64 fam_evec) gives T3's
    outputs at those slots bit for bit, and K8 gives the roll-subtract of
    T3's outputs bit for bit."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    sim = _card_sim(card, th.write_case(tmp_path))
    mesh = sim.mesh
    n = mesh.npoint
    head = _k13_stack(sim)
    fam = (mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)
    flux, lc, lv = kernels.edge_flux(*head, *fam)
    res, lcn, lvn = kernels.edge_win(*head, *fam)
    want = ef.roll_subtract(mesh.fam_offsets, flux, lc, lv)
    for g, w in zip((res, lcn, lvn), want):
        assert torch.equal(g, w)
    valid = (mesh.fam_normal != 0).any(-1)                  # (Kh, nP)
    ks, ps = torch.nonzero(valid, as_tuple=True)
    offs = torch.tensor(mesh.fam_offsets, device=card)
    edges = torch.stack([ps, (ps + offs[ks]) % n], dim=1)
    assert torch.equal(mesh.coords[edges[:, 1]] - mesh.coords[edges[:, 0]],
                       mesh.fam_evec[ks, ps])
    f13, lc13, lv13 = kernels.edge_list_flux(
        *head, edges.contiguous(), mesh.fam_normal[ks, ps].contiguous(),
        mesh.coords)
    assert torch.equal(f13, flux[ks, :, ps].T)
    assert torch.equal(lc13, lc[ks, ps]) and torch.equal(lv13, lv[ks, ps])


SHAPES = [(nd, ns, dt) for nd, ns in ((2, 9), (2, 3), (3, 9), (3, 3),
                                      (2, 5), (2, 1), (3, 16))
          for dt in ("float64", "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("nd,ns,dtype", SHAPES,
                         ids=[f"{nd}d-{ns}-{dt}" for nd, ns, dt in SHAPES])
def test_edge_kernels_every_compiled_shape(card, tmp_path, nd, ns, dtype):
    """T3, K8 and K13 at every (dimension, species count) shape they are
    compiled for (kernels.EDGE_SHAPES) and at shapes their run-time
    instance takes ((2, 5), (2, 1), (3, 16)), on torch_helpers.
    edge_shape_inputs: each against its plain version, every output row
    within 1e-10 (f64) or 1e-4 (f32) of its max; K8 the roll-subtract of
    T3's outputs bit for bit; K13 over the family slots' edges."""
    from types import SimpleNamespace
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    assert kernels._check_edge_shape("edge_flux", SimpleNamespace(
        ndim=nd, ns=ns)) == ((nd, ns) in kernels.EDGE_SHAPES)
    dt = getattr(torch, dtype)
    mesh, head = th.edge_shape_inputs(nd, ns, tmp_path, dt, card)
    n = mesh.npoint
    fam = (mesh.fam_offsets, mesh.fam_normal, mesh.fam_evec)
    valid = (mesh.fam_normal != 0).any(-1)
    ks, ps = torch.nonzero(valid, as_tuple=True)
    offs = torch.tensor(mesh.fam_offsets, device=card)
    edges = torch.stack([ps, (ps + offs[ks]) % n], dim=1).contiguous()
    lst = (edges, mesh.fam_normal[ks, ps].contiguous(), mesh.coords)
    afrac = 1e-10 if dt == torch.float64 else 1e-4
    kernels.reset_launches()
    t3 = kernels.edge_flux(*head, *fam)
    for got, want in ((t3, ef.edge_flux_plain(*head, *fam)),
                      (kernels.edge_win(*head, *fam),
                       ef.edge_win_plain(*head, *fam)),
                      (kernels.edge_list_flux(*head, *lst),
                       ef.edge_list_flux_plain(*head, *lst))):
        for g, w in zip(got, want):
            g = th.npy(g).astype(np.float64)
            w = th.npy(w).astype(np.float64)
            assert np.isfinite(g).all()
            rows = w.shape[-1]
            g, w = g.reshape(-1, rows), w.reshape(-1, rows)
            assert (np.abs(g - w)
                    <= afrac * np.abs(w).max(1, keepdims=True)).all()
    assert {k: kernels.launches[k] for k in
            ("edge_flux", "edge_win", "edge_list_flux")} == dict(
                edge_flux=1, edge_win=1, edge_list_flux=1)
    win = kernels.edge_win(*head, *fam)
    for g, w in zip(win, ef.roll_subtract(mesh.fam_offsets, *t3)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nd,ns,dtype", SHAPES,
                         ids=[f"{nd}d-{ns}-{dt}" for nd, ns, dt in SHAPES])
def test_k13_call_every_compiled_shape(card, tmp_path, nd, ns, dtype):
    """K13's whole call (kernels.edge_list_terms) at the shapes of
    test_edge_kernels_every_compiled_shape over the mesh's edge list, on
    torch_helpers.edge_shape_inputs with the stack node-major: against
    edge_list_terms_plain, every output row within 1e-10 (f64) or 1e-4
    (f32) of its max."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import edge_flux as ef
    dt = getattr(torch, dtype)
    mesh, head = th.edge_shape_inputs(nd, ns, tmp_path, dt, card)
    args = head[:4] + (head[4].T.contiguous(), mesh)
    got = kernels.edge_list_terms(*args)
    want = ef.edge_list_terms_plain(*args)
    afrac = 1e-10 if dt == torch.float64 else 1e-4
    for g, w in zip((got[0].T, got[1][None], got[2][None]),
                    (want[0].T, want[1][None], want[2][None])):
        g, w = th.npy(g).astype(np.float64), th.npy(w).astype(np.float64)
        assert np.isfinite(g).all()
        assert (np.abs(g - w) <= afrac * np.abs(w).max(1, keepdims=True)).all()


@pytest.mark.cuda
def test_tri_slice_launches(card, tmp_path):
    """The explicit LU_SGS step on the 153-node scrambled triangle
    channel: K13 once per iteration (its edge pass and its node sums), T2
    twice, T4 once; T3, K8, K5, K6, K7, K10 and K12 never (the SST solve
    is the torch gather sweep)."""
    sim = _tri_card_sim(card, th.write_case(tmp_path), th.CHANNEL,
                        torch.float64)
    (_, _, hist, _), launched = _run_launches(sim)
    assert np.isfinite(hist).all()
    want = {"edge_list_flux": 3, "edge_list_sum": 3, "node_state": 6,
            "chem_source": 3,
            "edge_flux": 0, "edge_win": 0, "stencil_fgmres": 0,
            "stencil_sgs_matvec": 0, "gradient_rows": 0,
            "edge_implicit": 0, "sst_assemble": 0}
    assert {k: launched[k] for k in want} == want


def _k11_edge_inputs(card, tmp_path, dtype):
    """K11's operands on the edge rows of the 9,072-node triangle
    channel's implicit case (MUSCL + Venkatakrishnan): euler.edge_faces of
    a mixed state, feature-major, as convective_system passes them."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.ops import limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    text = th.with_implicit(th.write_case(tmp_path), prec="LU_SGS")
    sim = _tri_card_sim(card, text, (189, 48), dtype)
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    u = th.tt(th.mixed_state(sim, seed=4), dtype).to(card)
    nsd = st.node_state_plain(lib, lay, u, sim.t0, sim.tparams)
    grad = es.compute_gradients(mesh, prm,
                                vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs))
    lim = limiters.venkatakrishnan(mesh, es.gradient_vars(lay, nsd.v),
                                   grad[:, :2 + lay.ndim], prm.limiter_coeff,
                                   prm.ref_elem_length)
    v_i, v_j, s_i, s_j = es.edge_faces(lib, lay, mesh, prm, nsd.v, grad, lim,
                                       nsd.dpdu)
    return sim, (v_i, v_j, mesh.edge_normal.T.contiguous(), s_i, s_j)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k11_edge_rows_match_plain(card, tmp_path, dtype):
    """K11 against ausm_t.ausm_flux_t on the 9,072-node triangle
    channel's edge rows (26,743 edges, MUSCL face states): every output
    within 1e-12 (f64) or 1e-5 (f32) of its field's max, relative 1e-10 /
    1e-4 per entry; one launch per call; the first-order rows
    (v.T[:, i]) reach it contiguous, without a copy."""
    from su2_tpu_torch import kernels
    from su2_tpu_torch.ops import ausm_t
    sim, ins = _k11_edge_inputs(card, tmp_path, dtype)
    lay, m_inf = sim.lay, sim.params.m_infty
    assert ins[0].shape[1] == sim.mesh.nedge == 26743
    want = ausm_t.ausm_flux_t(lay, *ins[:3], m_inf, *ins[3:])
    kernels.reset_launches()
    got = kernels.ausm_flux_jac(lay, *ins[:3], m_inf, *ins[3:])
    assert kernels.launches["ausm_flux_jac"] == 1
    rtol, afrac = (1e-10, 1e-12) if dtype == torch.float64 else (1e-4, 1e-5)
    for g, w in zip(got, want):
        g, w = th.npy(g).astype(np.float64), th.npy(w).astype(np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert (np.abs(g - w) <= rtol * np.abs(w)
                + afrac * np.abs(w).max()).all()
    i = sim.mesh.edges[:, 0]
    assert sim.u0.T[:, i].is_contiguous()


def _eager(sim, state, niter, ignites=None, cfl=None, dual=None):
    """niter eager iterations (Simulation._body: sim._step and its history
    row): (the final state, the (niter, W) rows)."""
    rows = []
    for j in range(niter):
        state, row = sim._body(
            state, None if ignites is None else bool(ignites[j]), cfl, dual)
        rows.append(row)
    return tuple(state), torch.stack(rows)


def _assert_same(got, want):
    (gc, gh), (wc, wh) = got, want
    assert len(gc) == len(wc)
    for a, b in zip(gc, wc):
        assert torch.equal(a, b)
    assert torch.equal(gh, wh)


def _graph_text(tmp_path, implicit):
    text = th.write_case(tmp_path)
    return th.with_implicit(text, prec="LU_SGS") if implicit else text


# the graph test's paths: (implicit flow, cfg lines, K6 solves per
# iteration); the dual-time paths read u_n, u_nm1 from the graph's buffers
DUAL2 = dict(UNSTEADY_SIMULATION="DUAL_TIME_STEPPING-2ND_ORDER",
             UNST_TIMESTEP="2e-5")
GRAPH_PATHS = {
    "explicit": (False, {}, 1), "implicit": (True, {}, 2),
    "dual-explicit": (False, DUAL2, 1),
    "dual-implicit": (True, dict(DUAL2, UNSTEADY_SIMULATION=(
        "DUAL_TIME_STEPPING-1ST_ORDER")), 2),
    "muscl": (False, dict(SPATIAL_ORDER_FLOW="2ND_ORDER_LIMITER",
                          SLOPE_LIMITER_FLOW="VENKATAKRISHNAN"), 1),
    "clip": (False, dict(CLIPPING_TEMPRATURE="YES"), 1),
    "bcgstab": (True, dict(LINEAR_SOLVER="BCGSTAB"), 0),
    "linelet": (True, dict(LINEAR_SOLVER_PREC="LINELET"), 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_matches_eager_bitwise(card, tmp_path, path, dtype):
    """Five iterations of the LU_SGS step (explicit flow, or implicit:
    K10 and two K6 solves; dual time with the states of two physical
    steps, explicit MUSCL, CLIPPING_TEMPRATURE, BCGSTAB (K5's sweep-only
    and matvec-only forms), the flow's LINELET) through the captured
    graph (_multistep: five replays) equal five eager iterations from the
    same state bit for bit, state and history rows; the capture's
    launches per replay are one eager iteration's, and the call counts
    its warm-up iteration and five replays of them."""
    from su2_tpu_torch import kernels
    implicit, lines, k6 = GRAPH_PATHS[path]
    sim = _card_sim(card, th.with_lines(_graph_text(tmp_path, implicit),
                                        **lines), dtype)
    state = (sim.u0, sim.t0) + tuple(sim.initial_turb_state())
    dual = None
    if sim.dual_order:
        dual = (state[0], state[0])
        state = _eager(sim, state, 2, dual=dual)[0]
        dual = (state[0], dual[0])
    state = _eager(sim, state, 2, dual=dual)[0]
    kernels.reset_launches()
    want = _eager(sim, state, 5, dual=dual)
    eager = dict(kernels.launches)
    kernels.reset_launches()
    got = sim._multistep(state, 5, dual=dual)
    _assert_same(got, want)
    assert {k: 5 * c for k, c in sim._graph.per_replay.items()} == eager
    assert dict(kernels.launches) == {
        k: 6 * c for k, c in sim._graph.per_replay.items()}
    assert eager["stencil_fgmres"] == 5 * k6
    bcg = path == "bcgstab"
    assert (eager["stencil_sweep_only"] > 0) == bcg
    assert (eager["stencil_matvec_only"] > 0) == (bcg or path == "linelet")


# the graph test's paths on meshes without a static stencil: (cfg text
# from the case, the tet box); ausm_flux_jac launches per iteration
GATHER_GRAPH_PATHS = {
    "tri-implicit-lusgs": (lambda t: th.with_implicit(t, prec="LU_SGS"),
                           False, 1),
    "tri-implicit-linelet": (lambda t: th.with_implicit(t, prec="LINELET"),
                             False, 1),
    "tri-laminar-implicit": (lambda t: th.with_implicit(
        th.cases.with_laminar(t), prec="JACOBI"), False, 1),
    "tri-laminar-explicit": (th.cases.with_laminar, False, 0),
    "tet-explicit": (th.cases.with_box_markers, True, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("path", list(GATHER_GRAPH_PATHS))
def test_gather_graph_matches_eager_bitwise(card, tmp_path, path, dtype):
    """Five iterations on the 153-node scrambled triangle channel
    (implicit RANS with LU_SGS or LINELET and laminar implicit JACOBI: the
    edge-list system, K11 once per iteration; laminar explicit) or the
    180-node tet box (explicit LU_SGS: K13 at (3, 9), the 3D gather WLS)
    through the captured graph equal five eager iterations from the same
    state bit for bit, state and history rows; K5, K6, K10 never."""
    from su2_tpu_torch import cases, kernels
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    cfg_of, tet, k11 = GATHER_GRAPH_PATHS[path]
    raw = (cases.tet_box_mesh(6, 6, 5) if tet
           else cases.tri_channel_mesh(*th.CHANNEL))
    sim = Simulation(Config(text=cfg_of(th.write_case(tmp_path))),
                     raw_mesh=raw, dtype=dtype, device=card)
    assert sim.mesh.stencil_offsets is None
    state = (sim.u0, sim.t0) + (tuple(sim.initial_turb_state())
                                if sim.turbulent else ())
    state = _eager(sim, state, 2)[0]
    kernels.reset_launches()
    want = _eager(sim, state, 5)
    eager = dict(kernels.launches)
    kernels.reset_launches()
    got = sim._multistep(state, 5)
    _assert_same(got, want)
    assert {k: 5 * c for k, c in sim._graph.per_replay.items()} == eager
    assert eager["ausm_flux_jac"] == 5 * k11
    assert eager["edge_list_flux"] == 5 * (sim.turbulent
                                           and not sim.cfg.implicit_flow)
    for k in ("stencil_fgmres", "stencil_sgs_matvec", "stencil_sweep_only",
              "stencil_matvec_only", "edge_implicit", "edge_flux"):
        assert eager[k] == 0, k


@pytest.mark.cuda
def test_bcgstab_lusgs_launches_k5_forms(card, tmp_path):
    """The implicit LU_SGS case with LINEAR_SOLVER= BCGSTAB at 153 nodes:
    per iteration the flow's (v = 13) and the SST's (v = 2) BCGSTAB(10)
    each launch K5's matvec-only form 21 times (the start and two per
    iteration) and its sweep-only form 20 times, and no K6 or (z, A z)
    form; the run stays finite."""
    text = th.with_lines(_graph_text(tmp_path, True), LINEAR_SOLVER="BCGSTAB")
    sim = _card_sim(card, text)
    (_, _, hist, _), launched = _run_launches(sim)
    assert np.isfinite(hist).all()
    assert launched["stencil_matvec_only"] == 3 * 2 * 21
    assert launched["stencil_sweep_only"] == 3 * 2 * 20
    assert launched["stencil_sgs_matvec"] == 3 * 2 * 41
    assert launched["stencil_fgmres"] == 0


@pytest.mark.cuda
def test_run_unsteady_card_vs_cpu(card, tmp_path):
    """run_unsteady (explicit BDF2, 2 physical steps of 3 inner
    iterations; each step one chunk of graph replays) on the card against
    the CPU in float64: state and history within rtol 1e-9, atol 1e-12
    max|field|."""
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    text = th.with_lines(th.write_case(tmp_path), UNST_INT_ITER="3", **DUAL2)
    out = [Simulation(Config(text=text), raw_mesh=channel_mesh(*th.CHANNEL),
                      dtype=torch.float64, device=d).run_unsteady(
                          2, quiet=True) for d in (card, "cpu")]
    (gu, gt, gh, gs), (cu, ct, ch, cs) = out
    th.assert_fields_close([gu, gt, gh, *gs], [cu, ct, ch, *cs], 1e-9,
                           1e-12, ["u", "t", "hist", "q", "mu_t", "grad_k",
                                   "sigma_k"])


@pytest.mark.cuda
def test_graph_tail_chunk_and_second_run(card, tmp_path):
    """run(7, chunk=3): two chunks and a tail chunk of one iteration, all
    replays of one graph, equal seven eager iterations bit for bit; a
    second run on the same Simulation replays the same graph and agrees
    again; a chunk past the history's rows captures anew."""
    sim = _card_sim(card, th.write_case(tmp_path))
    state = (sim.u0, sim.t0) + tuple(sim.initial_turb_state())
    want_c, want_h = _eager(sim, state, 7)
    for run in range(2):
        u, t, hist, turb = sim.run(7, quiet=True, chunk=3)
        if run == 0:
            graph = sim._graph
        assert sim._graph is graph
        _assert_same(((u, t) + tuple(turb), torch.zeros(0)),
                     (want_c, torch.zeros(0)))
        rms = th.npy(want_h[:, :sim.lay.nvar]).astype(np.float64)
        assert np.array_equal(hist, np.log10(np.maximum(rms, 1e-300)))
    k = graph.hist.shape[0] + 1
    got = sim._multistep(state, k)
    assert sim._graph is not graph and sim._graph.hist.shape[0] == k
    _assert_same(got, _eager(sim, state, k))


@pytest.mark.cuda
def test_graph_ignition_and_cfl_buffers(card, tmp_path):
    """IGNITION flags and the CFL reach the captured step through its
    buffers: the graph with flags (1, 1, 0) and with a changed CFL equals
    the eager step with the same ignite and cfl arguments bit for bit, and
    differs from the run without them."""
    text = "\n".join([th.write_case(tmp_path), "IGNITION= YES",
                      "IGNITION_ITER= 2", "OXIDIZER_INDEX= 2"])
    sim = _card_sim(card, text)
    rich = (0.45, 0.05, 0.3, 0.04, 0.08, 0.02, 0.02, 0.02, 0.02)
    state = (th.tt(th.mixed_state(sim, ys=rich, seed=3)).to(card),
             sim.t0) + tuple(sim.initial_turb_state())
    flags = np.array([True, True, False])
    got = sim._multistep(state, 3, flags)
    _assert_same(got, _eager(sim, state, 3, flags))
    off = sim._multistep(state, 3, np.zeros(3, bool))
    _assert_same(off, _eager(sim, state, 3))
    assert not torch.equal(got[0][1], off[0][1])
    cfl = torch.tensor(0.05, dtype=sim.dtype, device=card)
    slow = sim._multistep(state, 2, None, 0.05)
    _assert_same(slow, _eager(sim, state, 2, cfl=cfl))
    assert not torch.equal(slow[1][:, -1], off[1][:2, -1])


@pytest.mark.cuda
def test_graph_capture_failure_raises(card, tmp_path):
    """A step that cannot be captured (it reads a value back to the host)
    makes the chunk raise the capture's error; the run does not go on
    through the eager step, and no graph is kept."""
    sim = _card_sim(card, th.write_case(tmp_path))
    step = sim._step

    def syncing(*args, **kw):
        out = step(*args, **kw)
        float(out[0].sum())
        return out
    sim._step = syncing
    with pytest.raises(RuntimeError):
        sim.run(3, quiet=True, chunk=3)
    assert sim._graph is None
    sim._step = step
    u, _, hist, _ = sim.run(2, quiet=True)
    assert np.isfinite(hist).all() and sim._graph is not None


@pytest.mark.cuda
def test_restart_reads_back_the_run_bitwise(card, tmp_path):
    """f32: run(6, chunk=3) through the graph with WRT_SOL_FREQ= 3 writes
    the restart after 3 and 6 iterations (between chunks, outside the
    graph); RESTART_SOL= YES reads the last one back: its u and q (as the
    restarted run starts from them) are the run's final carry bit for
    bit (an f32 value survives the restart's 15 digits)."""
    text = th.with_lines(th.write_case(tmp_path), WRT_SOL_FREQ=3)
    sim = _card_sim(card, text, torch.float32)
    sim.enable_output(str(tmp_path))
    u, _, hist, turb = sim.run(6, quiet=True, chunk=3)
    assert np.isfinite(hist).all() and sim._graph is not None
    assert (tmp_path / "flow.dat").is_file()
    back = _card_sim(card, th.with_lines(
        text, RESTART_SOL="YES",
        SOLUTION_FLOW_FILENAME=str(tmp_path / "restart_flow.dat")),
        torch.float32)
    assert torch.equal(back.u0, u)
    assert torch.equal(back.initial_turb_state()[0], turb[0])


def _forces_leaves(forces):
    if isinstance(forces, dict):
        return [x for k in sorted(forces) for x in _forces_leaves(forces[k])]
    if isinstance(forces, tuple):
        return [x for f in forces for x in _forces_leaves(f)]
    return [float(forces)]


@pytest.mark.cuda
def test_restart_and_forces_card_vs_cpu(card, tmp_path):
    """f64, from a restart of a mixed state: the recomputed mu_t, grad_k
    and sigma_k (T2 and the gradient on the card) agree with the CPU's at
    rtol 1e-9, atol 1e-12 max|field|; monitor_forces over both walls
    (T2 on the card, the markers' rows copied to the host) at rtol 1e-9,
    atol 1e-12 th.force_scale."""
    from su2_tpu_torch import kernels
    text = th.write_case(tmp_path)
    src = th.torch_sim(text)
    src.enable_output(str(tmp_path))
    src.write_solution(th.tt(th.mixed_state(
        src, ys=(0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02),
        seed=1)), src.t0, src.initial_turb_state()[:2])
    rtext = th.with_lines(
        text, RESTART_SOL="YES",
        SOLUTION_FLOW_FILENAME=str(tmp_path / "restart_flow.dat"),
        MARKER_MONITORING="( lower_wall, upper_wall )")
    gpu, cpu = _card_sim(card, rtext), th.torch_sim(rtext)
    kernels.reset_launches()
    g = gpu.initial_turb_state()
    assert kernels.launches["node_state"] == 1
    c = cpu.initial_turb_state()
    th.assert_fields_close(g, c, 1e-9, 1e-12,
                           ("q", "mu_t", "grad_k", "sigma_k"))
    fg = _forces_leaves(gpu.monitor_forces(gpu.u0, gpu.t0, g[:2]))
    fc = _forces_leaves(cpu.monitor_forces(cpu.u0, cpu.t0, c[:2]))
    np.testing.assert_allclose(fg, fc, rtol=1e-9,
                               atol=1e-12 * th.force_scale(cpu))
