"""The CUDA kernels T1-T4 against their plain torch versions on the card,
and the slice's launch counts.  Every test needs a CUDA device and skips
without one.  This file imports no JAX, so on a machine without it run it
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
