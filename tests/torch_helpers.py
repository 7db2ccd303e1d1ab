"""Shared helpers of the su2_tpu_torch tests: the only module that touches
both packages.  Data cross between them as numpy arrays.  JAX is imported
only inside the helpers that build su2_tpu objects, so the card tests
(test_torch_cuda.py) run where JAX is not installed."""

import os

import numpy as np
import torch

from su2_tpu_torch import cases
from su2_tpu_torch.chemistry.library import _TABLE_FIELDS

META = ("t0", "dt", "nt", "nspecies", "nreactions", "species")
CHANNEL = (17, 9)        # 153 nodes


def write_case(directory, backward_rate=False, mesh_file=None):
    """The synthetic 9-species case in `directory`; returns the cfg text."""
    os.makedirs(directory, exist_ok=True)
    return cases.write_case(str(directory), backward_rate=backward_rate,
                            mesh_file=mesh_file)


def case_variant(text, name):
    """The case, or its variant with a slip lower wall, a heat-flux upper
    wall and a MASS_FLOW inlet (fuel at 1.1 kg/m^3)."""
    if name == "isothermal":
        return text
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("MARKER_ISOTHERMAL", "INLET_TYPE",
                                   "MARKER_INLET"))]
    return "\n".join(lines + [
        "MARKER_HEATFLUX = (upper_wall, 2500.0)",
        "MARKER_EULER = (lower_wall)",
        "INLET_TYPE = MASS_FLOW",
        "MARKER_INLET= ( inlet, 1.1, 12.0, 1.0, 0.0, 0.0 )"])


def jax_sim(text, shape=CHANNEL):
    import jax.numpy as jnp
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation
    from su2_tpu.geometry.structured import channel_mesh
    return Simulation(Config(text=text), dtype=jnp.float64,
                      raw_mesh=channel_mesh(*shape))


def torch_sim(text, shape=CHANNEL):
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    return Simulation(Config(text=text), raw_mesh=channel_mesh(*shape),
                      dtype=torch.float64)


def chemlib_numpy(jlib) -> dict:
    """The JAX ChemLib's leaves as numpy plus its metadata."""
    d = {k: np.asarray(getattr(jlib, k)) for k in _TABLE_FIELDS}
    d.update({k: getattr(jlib, k) for k in META})
    return d


def tt(x, dtype=torch.float64):
    """numpy / JAX array -> CPU tensor (a copy)."""
    return torch.as_tensor(np.array(x)).to(dtype)


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def random_gas(ns, n, seed, t_range=(300.0, 2500.0)):
    """Random (T, rho, Y) in numpy, with vanishing species."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(*t_range, n)
    rho = rng.uniform(0.2, 2.0, n)
    ys = rng.dirichlet(np.ones(ns), size=n)
    ys[: n // 4, 0] = 0.0
    ys[n // 4: n // 2, 2] = 1e-16
    omt = rng.uniform(1.0, 1e4, n)
    return t, rho, ys, omt


def random_conserved(h_rgas, ns, nd, n, seed):
    """A random conserved state u (N, nVar), a perturbed temperature guess
    and a turbulent kinetic energy, in numpy float64, from random T, P,
    velocity and a mixing-layer composition; h_rgas(t, ys) returns the
    mixture enthalpy and gas constant."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(500.0, 2500.0, n)
    p = rng.uniform(0.9e5, 1.2e5, n)
    vel = rng.normal(0.0, 20.0, (n, nd))
    # fuel, water, oxygen and the carbon oxides; radicals and H2 at traces
    alpha = np.array([1.0, 1.0, 1.0, 1.0, 1.0] + [0.05] * (ns - 5))
    ys = rng.dirichlet(alpha, n)
    h, rgas = h_rgas(t, ys)
    rho = p / (rgas * t)
    e = h - rgas * t + 0.5 * (vel * vel).sum(1)
    u = np.concatenate([rho[:, None], rho[:, None] * vel, (rho * e)[:, None],
                        rho[:, None] * ys], axis=1)
    t_guess = t * (1.0 + 0.02 * rng.standard_normal(n))
    tke = rng.uniform(0.0, 5.0, n)
    return u, t_guess, tke


def assert_fields_close(got, want, rtol, atol_frac, names):
    """Every field: |got - want| <= rtol |want| + atol_frac max|want|."""
    for name, g, w in zip(names, got, want):
        g, w = npy(g), npy(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_frac * np.abs(w).max(), err_msg=name)
