"""Two coupled iterations of su2_tpu's jitted implicit RANS step in 3D
against su2_tpu_torch's Simulation._step, float64: MUSCL +
Venkatakrishnan, FGMRES with LU_SGS for the flow's 14 x 14 and the SST's
2 x 2 systems, on box_mesh(3, 3, 3) (the smallest box with an interior
node) with cases.with_box_markers' walls, from th.mixed_state (every
species present, ROADMAP Queue 3 item 1).  su2_tpu runs with its edge
kernel mode off (its XLA family assembly, which tests/test_rans_3d.py:81
pins to its fused kernel's 3D branch) and SU2_TPU_FUSED_FGMRES_OFF (its
Krylov loop over the (z, A z) kernel in interpret mode, the arithmetic of
its one-launch cycle, as tests/test_torch_dual_time.py runs it): the
step's compile, about a minute, is this file's cost.  Tolerance: every
field within rtol 1e-9, atol 1e-12 max|field|."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

NAMES = ("u", "t_guess", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
         "turb_rms", "nonphys", "min_dt")
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """(su2_tpu's jitted RANS step, its Simulation, the port's) on the box,
    the step compiled once."""
    from su2_tpu.config import Config as JConfig
    from su2_tpu.driver import Simulation as JSimulation
    from su2_tpu.pallas import edge_kernels as ek
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import box_mesh
    text = th.with_implicit(th.cases.with_box_markers(th.write_case(
        tmp_path_factory.mktemp("box_step"))), prec="LU_SGS")
    raw = box_mesh(3, 3, 3)
    js = JSimulation(JConfig(text=text), dtype=jnp.float64,
                     raw_mesh=th.jax_raw(raw))
    ts = Simulation(Config(text=text), raw_mesh=raw, dtype=torch.float64,
                    device="cpu")
    saved = os.environ.get("SU2_TPU_FUSED_FGMRES_OFF")
    os.environ["SU2_TPU_FUSED_FGMRES_OFF"] = "1"
    ek.set_edge_kernel_mode(False)
    try:
        fn = jax.jit(js._make_rans_step())
        state = (jnp.asarray(th.mixed_state(ts, ys=MIXED_YS)), js.t0) \
            + tuple(js.initial_turb_state())
        yield fn, js, ts, state
    finally:
        if saved is None:
            del os.environ["SU2_TPU_FUSED_FGMRES_OFF"]
        else:
            os.environ["SU2_TPU_FUSED_FGMRES_OFF"] = saved


def test_implicit_rans_3d_steps_match_jax(step):
    """Two iterations of the 3D implicit RANS step, su2_tpu's jitted step
    against the port's (K10's plain version at (3, 9), the 3D boundary,
    wall, source and SST-coupling Jacobians, the flow's v = 14 and the
    SST's v = 2 solves through the plain K6 cycle, the SST step): every
    output field within rtol 1e-9, atol 1e-12 max|field|."""
    from su2_tpu_torch.convert import state_from_numpy
    fn, js, ts, j_state = step
    assert ts.lay.ndim == 3 and ts.lay.nvar == 14
    assert tuple(ts.mesh.stencil_offsets) == (-9, -3, -1, 1, 3, 9)
    t_state = state_from_numpy(*(np.asarray(x) for x in j_state))
    for _ in range(2):
        jo = fn(*j_state, jnp.asarray(False))
        to = ts._step(*t_state)
        th.assert_fields_close(to, jo, 1e-9, 1e-12, NAMES)
        j_state, t_state = tuple(jo[:6]), tuple(to[:6])
