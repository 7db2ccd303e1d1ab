"""Plain version of kernel T2 (state.node_state_plain / node_state_lite_plain)
against the XLA chain of tests/test_node_state.py:45-66 and the Pallas
node_state kernel in interpret mode: secant path, bisection path and the
non-physical flags, on the case's 9 species and on both libraries cut to 3
(T2's other compiled count) and 5 species (its run-time instance on the
card)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

N = 160
NAMES = ["u_clip", "v", "nonphys", "dtdu", "dpdu", "mu", "kappa", "xs"]


# (species count, reference): the case's 9 species under the ids these
# tests had before the cut counts, then the libraries cut to 3 and 5
CASES = [(ns, ref) for ns in (9, 3, 5)
         for ref in ("xla_chain", "pallas_interpret")]
IDS = [ref if ns == 9 else f"{ns}sp-{ref}" for ns, ref in CASES]


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """setups(ns): the fixture tuple on the libraries cut to ns species
    (th.jax_species_cut, cases.species_cut), made once per count."""
    made = {}

    def get(ns):
        if ns not in made:
            made[ns] = _make(tmp_path_factory, ns)
        return made[ns]
    return get


@pytest.fixture(scope="module")
def setup(setups):
    return setups(9)


def _make(tmp_path_factory, ns):
    from su2_tpu import state as jst
    from su2_tpu.chemistry import library as jl
    from su2_tpu_torch import state as tst
    from su2_tpu_torch.chemistry import library as tl
    man = th.cases.write_library(str(tmp_path_factory.mktemp("ns")))
    jlib, tlib = jl.load_library(man), tl.load_library(man)
    if ns != tlib.nspecies:
        jlib, tlib = th.jax_species_cut(jlib, ns), \
            th.cases.species_cut(tlib, ns)
    nd = 2

    def h_rgas(t, ys):
        jt, jy = jnp.asarray(t), jnp.asarray(ys)
        return (np.asarray(jl.mixture_enthalpy(jlib, jt, jy)),
                np.asarray(jl.mixture_rgas(jlib, jy)))

    u, t_guess, tke = th.random_conserved(h_rgas, ns, nd, N, seed=3)
    return (jlib, tlib, jst.Layout(nd, ns), tst.Layout(nd, ns), u, t_guess,
            tke)


def _xla_chain(jlib, lay, tparams, u, t_guess, tke):
    from su2_tpu import state as st
    from su2_tpu.chemistry import library as cl
    uc, v, nonphys = st.cons2prim(jlib, lay, u, t_guess, tparams, turb_ke=tke)
    t, ys = v[:, lay.T], v[:, lay.YS:lay.YS + lay.ns]
    return (uc, v, nonphys, st.dtdu(jlib, lay, v), st.dpdu(jlib, lay, v),
            cl.mixture_viscosity(jlib, t, ys),
            cl.mixture_conductivity(jlib, t, ys), cl.molar_from_mass(jlib, ys))


def _compare(setup, u, t_guess, ref, **tp):
    from su2_tpu import state as jst
    from su2_tpu.pallas import node_state as nst
    from su2_tpu_torch import state as tst
    jlib, tlib, jlay, tlay, _, _, tke = setup
    jp, tp_ = jst.TSolveParams(**tp), tst.TSolveParams(**tp)
    ju, jt, jk = (jnp.asarray(x) for x in (u, t_guess, tke))
    if ref == "xla_chain":
        want = _xla_chain(jlib, jlay, jp, ju, jt, jk)
    else:
        want = nst.node_state(jlib, jlay, jp, ju, jt, turb_ke=jk)
    got = tst.node_state_plain(tlib, tlay, th.tt(u), th.tt(t_guess), tp_,
                               th.tt(tke))
    th.assert_fields_close(list(vars(got).values()), want, 5e-12, 1e-300,
                           NAMES)
    # the lite variant returns the same u, v, flags, mu, xs and gamma - 1
    lite = tst.node_state_lite_plain(tlib, tlay, th.tt(u), th.tt(t_guess),
                                     tp_, th.tt(tke))
    for name in ("u", "v", "nonphys", "mu", "xs"):
        assert torch.equal(getattr(lite, name), getattr(got, name)), name
    np.testing.assert_allclose(th.npy(lite.gm1),
                               np.asarray(want[4])[:, tlay.RHOE], rtol=1e-12)


@pytest.mark.parametrize("ns,ref", CASES, ids=IDS)
def test_t2_plain_secant_path(setups, ns, ref):
    setup = setups(ns)
    _compare(setup, setup[4], setup[5], ref)


@pytest.mark.parametrize("ns,ref", CASES, ids=IDS)
def test_t2_plain_bisection_path(setups, ns, ref):
    """Secant budget 1 from a far-off guess: most cells bisect."""
    setup = setups(ns)
    _compare(setup, setup[4], np.full(N, 4999.0), ref, secant_iters=1,
             secant_tol=1e-30)


@pytest.mark.parametrize("ns,ref", CASES, ids=IDS)
def test_t2_plain_nonphys_flags(setups, ns, ref):
    """Negative partial density and vanishing rho are flagged like the
    chain (tests/test_node_state.py:104-110)."""
    setup = setups(ns)
    lay = setup[3]
    u = setup[4].copy()
    u[3, lay.RHOS] = -1.0e-4
    u[7, lay.RHO] = 1.0e-20
    _compare(setup, u, setup[5], ref)


def test_node_state_dispatch_cpu(setup):
    """state.node_state takes the plain chain for CPU tensors, also with
    CLIPPING_TEMPRATURE (clip_temp), which the plain chain honours."""
    from su2_tpu_torch import state as tst
    _, tlib, _, tlay, u, t_guess, tke = setup
    p = tst.TSolveParams()
    a = tst.node_state(tlib, tlay, th.tt(u), th.tt(t_guess), p, th.tt(tke))
    b = tst.node_state_plain(tlib, tlay, th.tt(u), th.tt(t_guess), p,
                             th.tt(tke))
    for k in vars(b):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    pc = tst.TSolveParams(clip_temp=True)
    a = tst.node_state(tlib, tlay, th.tt(u), th.tt(t_guess), pc)
    b = tst.node_state_plain(tlib, tlay, th.tt(u), th.tt(t_guess), pc)
    for k in vars(b):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
