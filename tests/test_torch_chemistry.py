"""su2_tpu_torch.chemistry.library and the plain versions of kernels T1
(mixture enthalpy) and T4 (chemistry source) against su2_tpu on random
(T, rho, Y), both chemistry variants of the synthetic case."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

N = 300


@pytest.fixture(scope="module", params=[False, True], ids=["keq", "backward"])
def libs(request, tmp_path_factory):
    from su2_tpu.chemistry import library as jl
    from su2_tpu_torch.chemistry import library as tl
    d = tmp_path_factory.mktemp("chem")
    man = th.cases.write_library(str(d), request.param)
    return jl.load_library(man), tl.load_library(man)


@pytest.fixture(scope="module")
def gas(libs):
    t, rho, ys, omt = th.random_gas(libs[1].nspecies, N, seed=11)
    return t, rho, ys, omt


# function name -> args builder over (t, rho, ys, omt) and the library;
# evaluated identically in both packages
CASES = {
    "species_cp": lambda t, r, y, o: (t,),
    "species_enthalpy": lambda t, r, y, o: (t,),
    "species_energy": lambda t, r, y, o: (t,),
    "mixture_rgas": lambda t, r, y, o: (y,),
    "mixture_cp": lambda t, r, y, o: (t, y),
    "frozen_gamma_sound": lambda t, r, y, o: (t, y),
    "molar_from_mass": lambda t, r, y, o: (y,),
    "species_viscosity": lambda t, r, y, o: (t,),
    "species_conductivity": lambda t, r, y, o: (t,),
    "mixture_viscosity": lambda t, r, y, o: (t, y),
    "mixture_conductivity": lambda t, r, y, o: (t, y),
    "binary_diffusion": lambda t, r, y, o: (t, r * 1e5),
    "concentrations": lambda t, r, y, o: (r, y),
    "equilibrium_constants": lambda t, r, y, o: (t,),
    "rate_constants": lambda t, r, y, o: (t,),
    "reaction_rates": lambda t, r, y, o: (t, r, y),
}


def _cmp(got, want, rtol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(th.npy(g), np.asarray(w), rtol=rtol,
                                   atol=0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_library_function_matches(libs, gas, name):
    from su2_tpu.chemistry import library as jl
    from su2_tpu_torch.chemistry import library as tl
    jlib, tlib = libs
    args = CASES[name](*gas)
    want = getattr(jl, name)(jlib, *(jnp.asarray(a) for a in args))
    got = getattr(tl, name)(tlib, *(th.tt(a) for a in args))
    _cmp(got, want, 1e-12)


def test_stefan_maxwell_and_kinetic_tensors_match(libs, gas):
    """Gamma matrix, omega tensor, dFr/drho, PaSR constants, mass
    production (the rest of library.py:224-502)."""
    from su2_tpu.chemistry import library as jl
    from su2_tpu_torch.chemistry import library as tl
    jlib, tlib = libs
    t, rho, ys, omt = gas
    jx = [jnp.asarray(a) for a in gas]
    tx = [th.tt(a) for a in gas]
    dij_j = jl.binary_diffusion(jlib, jx[0], jx[1] * 1e5)
    dij_t = tl.binary_diffusion(tlib, tx[0], tx[1] * 1e5)
    xs_j, xs_t = jl.molar_from_mass(jlib, jx[2]), tl.molar_from_mass(tlib,
                                                                    tx[2])
    _cmp(tl.stefan_maxwell_gamma(tlib, tx[1], xs_t, tx[2], dij_t),
         jl.stefan_maxwell_gamma(jlib, jx[1], xs_j, jx[2], dij_j), 1e-12)
    rf_j, rb_j, _ = jl.reaction_rates(jlib, jx[0], jx[1], jx[2])
    rf_t, rb_t, _ = tl.reaction_rates(tlib, tx[0], tx[1], tx[2])
    om_j, om_t = jl.omega_tensor(jlib, rf_j, rb_j), tl.omega_tensor(
        tlib, rf_t, rb_t)
    _cmp(om_t, om_j, 1e-12)
    dfr_j = jl.dfr_drho(jlib, rf_j, rb_j, jx[1], jx[2])
    dfr_t = tl.dfr_drho(tlib, rf_t, rb_t, tx[1], tx[2])
    _cmp(dfr_t, dfr_j, 1e-12)
    k_j = jl.pasr_constants(jlib, dfr_j, jx[3], 0.09, 0.2)
    k_t = tl.pasr_constants(tlib, dfr_t, tx[3], 0.09, 0.2)
    _cmp(k_t, k_j, 1e-12)
    _cmp(tl.mass_production(tlib, om_t, k_t),
         jl.mass_production(jlib, om_j, k_j), 1e-12)
    _cmp(tl.mass_production(tlib, om_t), jl.mass_production(jlib, om_j),
         1e-12)


@pytest.mark.parametrize("ref", ["gather", "onehot"])
def test_t1_plain_matches_jax(libs, gas, ref):
    """Kernel T1's plain version vs the JAX gather path and the JAX one-hot
    contraction of pallas/thermo.py, including knots and the clamped
    table ends."""
    from su2_tpu.chemistry import library as jl
    from su2_tpu.pallas import thermo as jthermo
    from su2_tpu_torch.chemistry import library as tl
    jlib, tlib = libs
    t, _, ys, _ = gas
    t = t.copy()
    t[:20] = th.cases.T_GRID[5:25]            # exactly on knots
    t[20], t[21] = 100.0, 7000.0             # clamped below / above
    if ref == "gather":
        want = jl.mixture_enthalpy(jlib, jnp.asarray(t), jnp.asarray(ys))
    else:
        want = jthermo.mixture_enthalpy_onehot(
            jlib, jnp.asarray(t), jl.clip_mass_fractions(jnp.asarray(ys)))
    got = tl.mixture_enthalpy_plain(tlib, th.tt(t), th.tt(ys))
    np.testing.assert_allclose(th.npy(got), np.asarray(want), rtol=1e-12)
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(tl.mixture_enthalpy(tlib, th.tt(t), th.tt(ys)), got)


class _Prm:
    pasr = True
    pasr_lb = 0.2
    c_mu = 0.09


def _jax_chain(jlib, t, rho, ys, omt):
    """The XLA chain of tests/test_chem_source.py:28."""
    from su2_tpu.chemistry import library as cl
    rf, rb, _ = cl.reaction_rates(jlib, t, rho, ys)
    om = cl.omega_tensor(jlib, rf, rb)
    if omt is not None:
        dfr = cl.dfr_drho(jlib, rf, rb, rho, ys)
        k = cl.pasr_constants(jlib, dfr, omt, _Prm.c_mu, _Prm.pasr_lb)
        return cl.mass_production(jlib, om, k)
    return cl.mass_production(jlib, om)


@pytest.mark.parametrize("ref", ["xla_chain", "pallas_interpret"])
@pytest.mark.parametrize("pasr", [True, False])
def test_t4_plain_matches_jax(libs, pasr, ref):
    """Kernel T4's plain version (chemistry_source_plain) vs the XLA chain
    and the Pallas chem_source kernel in interpret mode, with the
    vanishing-species guards (tests/test_chem_source.py:37-49)."""
    from su2_tpu.pallas import chem_source as pcs
    from su2_tpu_torch.solvers import euler as es
    jlib, tlib = libs
    t, rho, ys, omt = th.random_gas(tlib.nspecies, N, seed=5)
    jx = [jnp.asarray(a) for a in (t, rho, ys, omt)]
    jomt = jx[3] if pasr else None
    if ref == "xla_chain":
        want = _jax_chain(jlib, jx[0], jx[1], jx[2], jomt)
    else:
        want = pcs.chem_source(jlib, _Prm, jx[0], jx[1], jx[2], jomt)
    got = es.chemistry_source_plain(tlib, _Prm, th.tt(t), th.tt(rho),
                                    th.tt(ys), th.tt(omt) if pasr else None)
    np.testing.assert_allclose(th.npy(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


def test_case_reacts(libs):
    """The synthetic mixing layer (600 K fuel into 1200 K O2) reacts."""
    from su2_tpu_torch.solvers import euler as es
    tlib = libs[1]
    ys = np.zeros((1, tlib.nspecies))
    ys[0, 0], ys[0, 2] = 0.2, 0.8
    om = es.chemistry_source_plain(tlib, _Prm, th.tt([1000.0]),
                                   th.tt([0.4]), th.tt(ys), th.tt([100.0]))
    assert float(om[0, 0]) < 0.0 and float(om[0, 3]) > 0.0


def test_kernel_wrappers_refuse_cpu_tensors(libs):
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    a CPU tensor."""
    from su2_tpu_torch import kernels
    tlib = libs[1]
    with pytest.raises(ValueError, match="must be on"):
        kernels.mixture_enthalpy(tlib, th.tt(np.full(4, 1000.0)),
                                 th.tt(np.full((4, tlib.nspecies), 0.1)))


def _rows(tlib, t, rho, ys, omt):
    """The primitive rows (N, nPrim) and a turbulence state (N, 2) holding
    (T, rho, Y) and omega_t where the step keeps them (2D layout), and
    their column views, as chemistry_source_residual passes them."""
    from su2_tpu_torch import state as st
    lay = st.Layout(2, tlib.nspecies)
    v = torch.full((t.shape[0], lay.nprim), float("nan"), dtype=torch.float64)
    v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:] = th.tt(t), th.tt(rho), \
        th.tt(ys)
    turb = torch.stack([torch.ones(t.shape[0], dtype=torch.float64),
                        th.tt(omt)], dim=1)
    return v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:], turb[:, 1]


@pytest.mark.parametrize("ref", ["xla_chain", "pallas_interpret"])
@pytest.mark.parametrize("pasr", [True, False])
def test_t4_plain_on_row_views_matches_jax(libs, pasr, ref):
    """T4 reads its inputs in place from the primitive rows and the
    turbulence state: the plain version on those column views equals it
    on contiguous copies bit for bit, and su2_tpu's chain / Pallas
    chem_source (interpret mode) at test_t4_plain_matches_jax's
    tolerances."""
    from su2_tpu.pallas import chem_source as pcs
    from su2_tpu_torch.solvers import euler as es
    jlib, tlib = libs
    t, rho, ys, omt = th.random_gas(tlib.nspecies, N, seed=8)
    views = _rows(tlib, t, rho, ys, omt)
    assert not any(x.is_contiguous() for x in views)
    o = views[3] if pasr else None
    got = es.chemistry_source_plain(tlib, _Prm, *views[:3], o)
    assert torch.equal(got, es.chemistry_source_plain(
        tlib, _Prm, *(x.contiguous() for x in views[:3]),
        None if o is None else o.contiguous()))
    jx = [jnp.asarray(a) for a in (t, rho, ys, omt)]
    jomt = jx[3] if pasr else None
    if ref == "xla_chain":
        want = _jax_chain(jlib, jx[0], jx[1], jx[2], jomt)
    else:
        want = pcs.chem_source(jlib, _Prm, jx[0], jx[1], jx[2], jomt)
    np.testing.assert_allclose(th.npy(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("layout", ["rows", "contiguous", "wide", "no_pasr"])
def test_chem_sources_groups_views(libs, layout):
    """kernels.chem_sources: the step's views become two row sources (the
    primitive rows, one full row each; omega_t's column of the turbulence
    state), contiguous inputs four, columns of a wide tensor one source
    each once their span passes CHEM_SPAN; every field's column is where
    it lies in its source."""
    from su2_tpu_torch import kernels
    tlib = libs[1]
    ns = tlib.nspecies
    t, rho, ys, omt = th.random_gas(ns, N, seed=9)
    if layout in ("rows", "no_pasr"):
        fields = list(_rows(tlib, t, rho, ys, omt))
        nprim = fields[0].stride(0)
        want = [(0, nprim, nprim), (1, 2, 1)]
        cols = [(0, 0), (0, 4), (0, 7), (1, 0)]
        if layout == "no_pasr":
            fields, want, cols = fields[:3], want[:1], cols[:3]
    elif layout == "contiguous":
        fields = [th.tt(a) for a in (t, rho, ys, omt)]
        want = [(0, 1, 1), (0, 1, 1), (0, ns, ns), (0, 1, 1)]
        cols = [(0, 0), (1, 0), (2, 0), (3, 0)]
    else:
        wide = torch.zeros((N, 100), dtype=torch.float64)
        fields = [wide[:, 0], wide[:, 40], wide[:, 1:1 + ns], wide[:, 2]]
        want = [(0, 100, 1 + ns), (40, 100, 1)]
        cols = [(0, 0), (1, 0), (0, 1), (0, 2)]
    srcs, owner, at = kernels.chem_sources(fields)
    assert srcs == want and at == cols
    assert len(owner) == len(srcs) <= kernels.CHEM_SOURCES
    for (i, c), x in zip(at, fields):
        lo, stride, width = srcs[i]
        w = x.shape[1] if x.ndim == 2 else 1
        assert x.stride(0) == stride and c + w <= width
        assert x.storage_offset() == lo + c


def test_t4_wrapper_refuses_cpu_tensors(libs):
    """T4 launches on CUDA tensors or raises; it never runs a CPU one,
    strided or not."""
    from su2_tpu_torch import kernels
    tlib = libs[1]
    t, rho, ys, omt = th.random_gas(tlib.nspecies, N, seed=10)
    for views in (_rows(tlib, t, rho, ys, omt),
                  [th.tt(a) for a in (t, rho, ys, omt)]):
        with pytest.raises(ValueError, match="must be on"):
            kernels.chem_source(tlib, _Prm, *views)
