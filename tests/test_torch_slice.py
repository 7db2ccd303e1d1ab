"""The coupled explicit-flow REACTIVE_RANS step of su2_tpu_torch against
su2_tpu's Simulation._make_rans_step (XLA modes) on the 153-node synthetic
channel; the run loop, the CLI and the refusal of unported options."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("u", "t_guess", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
         "turb_rms", "nonphys", "min_dt")


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.write_case(tmp_path_factory.mktemp("slice"))


@pytest.mark.parametrize("backward_rate,variant", [
    (False, "isothermal"), (True, "isothermal"),
    (False, "slip_heatflux_mass_flow")],
    ids=["keq", "backward", "slip_heatflux_mass_flow"])
def test_three_coupled_iterations_match_jax(tmp_path, backward_rate,
                                            variant):
    """Every output field of 3 coupled iterations from the same state:
    rtol 1e-9, atol 1e-12 max|field|.  The module tests hold single
    evaluations at 1e-12..5e-12; three explicit steps compound those
    rounding differences (FGMRES orthogonalisation, secant stopping), and
    fields near zero (grad_k, the momentum of the first wall rows) carry
    them relative to their scale, hence the looser per-element rtol."""
    text = th.case_variant(
        th.write_case(tmp_path, backward_rate=backward_rate), variant)
    js, ts = th.jax_sim(text), th.torch_sim(text)
    step = jax.jit(js._make_rans_step())
    from su2_tpu_torch.convert import state_from_numpy
    j_state = (js.u0, js.t0) + tuple(js.initial_turb_state())
    # the port starts from the JAX carry, which equals its own initial state
    t_state = state_from_numpy(*(np.asarray(x) for x in j_state))
    own = (ts.u0, ts.t0) + tuple(ts.initial_turb_state())
    for a, b in zip(t_state, own):
        assert torch.equal(a, b)
    for _ in range(3):
        jo = step(*j_state, jnp.asarray(False))
        to = ts._step(*t_state)
        th.assert_fields_close(to, jo, 1e-9, 1e-12, NAMES)
        j_state, t_state = tuple(jo[:6]), tuple(to[:6])
    # the mixing layer reacts along the way
    from su2_tpu_torch import state as st
    from su2_tpu_torch.solvers import euler as es
    lay = ts.lay
    v = st.node_state(ts.lib, lay, t_state[0], t_state[1], ts.tparams,
                      turb_ke=t_state[2][:, 0]).v
    om = es.chemistry_source_plain(ts.lib, ts.params, v[:, lay.T],
                                   v[:, lay.PRHO], v[:, lay.YS:],
                                   t_state[2][:, 1])
    assert float(om.abs().max()) > 1e-2


def test_run_chunks_and_history(text, tmp_path):
    """run() with a chunk that does not divide niter writes one history
    row per iteration and matches the unchunked run."""
    ts = th.torch_sim(text)
    ts.enable_output(str(tmp_path))
    u1, t1, h1, s1 = ts.run(4, quiet=True, chunk=3)
    ts2 = th.torch_sim(text)
    u2, t2, h2, s2 = ts2.run(4, quiet=True, chunk=1)
    assert h1.shape == (4, ts.lay.nvar) and np.isfinite(h1).all()
    assert torch.equal(u1, u2) and np.array_equal(h1, h2)
    with open(tmp_path / "history.dat") as f:
        rows = [ln for ln in f.read().splitlines()
                if ln and ln[0].isdigit()]
    assert len(rows) == 4


@pytest.mark.parametrize("key,value,where", [
    ("LINEAR_SOLVER_PREC", "LU_SGS", "su2_tpu.pallas.stencil_solve"),
    ("SPATIAL_ORDER_FLOW", "2ND_ORDER", "su2_tpu.ops.limiters"),
    ("TIME_DISCRE_FLOW", "EULER_IMPLICIT", "su2_tpu.solvers.euler"),
    ("INLET_TYPE", "TOTAL_CONDITIONS", "su2_tpu.solvers.euler"),
    ("KIND_TURB_MODEL", "SA", "su2_tpu.turbulence"),
])
def test_unported_options_raise(text, key, value, where):
    lines = [ln for ln in text.splitlines() if not ln.startswith(key)]
    with pytest.raises(NotImplementedError, match=where.replace(".", r"\.")):
        th.torch_sim("\n".join(lines + [f"{key}= {value}"]))


def test_cli_two_iterations(tmp_path):
    """python -m su2_tpu_torch on a channel written as .su2: runs, and the
    history has 2 rows."""
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io.mesh import write_su2_mesh
    write_su2_mesh(channel_mesh(*th.CHANNEL), str(tmp_path / "channel.su2"))
    text = th.write_case(tmp_path / "lib", mesh_file="channel.su2")
    cfg = tmp_path / "case.cfg"
    cfg.write_text(text)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", str(cfg),
                           "2"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "history.dat") as f:
        rows = [ln for ln in f.read().splitlines()
                if ln and ln[0].isdigit()]
    assert len(rows) == 2
