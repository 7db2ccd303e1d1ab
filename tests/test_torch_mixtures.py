"""The implicit flow at a mixture of 5 species (cases.SPECIES[:5], both
reactions; the flow's block width nDim + nSpecies + 2 = 9, which K5 and
K6 run through their run-time-width instance on the card): two coupled
iterations of su2_tpu's jitted implicit step against su2_tpu_torch's
Simulation._step, float64, MUSCL + Venkatakrishnan, FGMRES with LU_SGS,
on channel_mesh(8, 6) from th.mixed_state (every species present, ROADMAP
Queue 3 item 1).  su2_tpu runs with its edge kernel mode off (its XLA
assembly) and SU2_TPU_FUSED_FGMRES_OFF (its Krylov loop over the (z, A z)
kernel in interpret mode, the arithmetic of its one-launch cycle), as
tests/test_torch_implicit_3d_steps.py runs it; the port's solves take the
plain K5/K6 of stencil_solve.solve_tier's f64 tier.  Tolerance: every
field within rtol 1e-9, atol 1e-12 max|field|."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

RANS_NAMES = ("u", "t_guess", "q", "mu_t", "grad_k", "sigma_k", "rms",
              "rmax", "turb_rms", "nonphys", "min_dt")
LAMINAR_NAMES = ("u", "t_guess", "rms", "rmax", "nonphys", "min_dt")
# C4H6, H2O, O2, CO, CO2: every species present
MIXED_YS = (0.02, 0.1, 0.6, 0.08, 0.2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The 5-species implicit LU_SGS case text and its mesh, with su2_tpu
    set up as the module docstring says (restored after the module)."""
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu_torch.geometry.structured import channel_mesh
    text = th.with_implicit(th.cases.write_case(
        str(tmp_path_factory.mktemp("species5")),
        species=th.cases.SPECIES[:5]), prec="LU_SGS")
    saved = os.environ.get("SU2_TPU_FUSED_FGMRES_OFF")
    os.environ["SU2_TPU_FUSED_FGMRES_OFF"] = "1"
    ek.set_edge_kernel_mode(False)
    try:
        yield text, channel_mesh(8, 6)
    finally:
        if saved is None:
            del os.environ["SU2_TPU_FUSED_FGMRES_OFF"]
        else:
            os.environ["SU2_TPU_FUSED_FGMRES_OFF"] = saved


def _sims(text, raw):
    from su2_tpu.config import Config as JConfig
    from su2_tpu.driver import Simulation as JSimulation
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    js = JSimulation(JConfig(text=text), dtype=jnp.float64,
                     raw_mesh=th.jax_raw(raw))
    ts = Simulation(Config(text=text), raw_mesh=raw, dtype=torch.float64,
                    device="cpu")
    assert ts.lay.ns == 5 and ts.lay.nvar == 9
    assert tuple(ts.mesh.stencil_offsets) == (-6, -1, 1, 6)
    return js, ts


def _two_steps(fn, ts, j_state, t_state, names):
    for _ in range(2):
        jo = fn(*j_state)
        to = ts._step(*t_state)
        th.assert_fields_close(to, jo, 1e-9, 1e-12, names)
        j_state = tuple(jo[:len(j_state)])
        t_state = tuple(to[:len(t_state)])


def test_implicit_rans_5_species_steps_match_jax(case):
    """The implicit RANS step at 5 species (K10's plain version at the
    run-time species count, the flow's v = 9 and the SST's v = 2 solves
    through the plain K5 in the Krylov loop and the plain K6 cycle)."""
    from su2_tpu_torch.convert import state_from_numpy
    js, ts = _sims(*case)
    step = jax.jit(js._make_rans_step())
    j_state = (jnp.asarray(th.mixed_state(ts, ys=MIXED_YS)), js.t0) \
        + tuple(js.initial_turb_state())
    t_state = state_from_numpy(*(np.asarray(x) for x in j_state))
    _two_steps(lambda *s: step(*s, jnp.asarray(False)), ts, j_state,
               t_state, RANS_NAMES)


def test_laminar_implicit_5_species_steps_match_jax(case):
    """The laminar implicit step at 5 species (KIND_TURB_MODEL= NONE: the
    family Jacobian of K11's plain version at 5 species, the flow's v = 9
    solve)."""
    text, raw = case
    js, ts = _sims(th.cases.with_laminar(text), raw)
    assert not ts.turbulent
    step = jax.jit(js._make_implicit_step())
    u = th.mixed_state(ts, ys=MIXED_YS)
    j_state = (jnp.asarray(u), js.t0)
    t_state = (th.tt(u), torch.as_tensor(np.array(js.t0)))
    _two_steps(step, ts, j_state, t_state, LAMINAR_NAMES)
