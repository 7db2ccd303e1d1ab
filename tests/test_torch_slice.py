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


VARIANTS = [(False, "isothermal"), (True, "isothermal"),
            (False, "slip_heatflux_mass_flow")]
VARIANT_IDS = ["keq", "backward", "slip_heatflux_mass_flow"]
# implicit flow (JACOBI for both systems): (muscl, limiter)
IMPLICIT = (True, "VENKATAKRISHNAN")
# the mixed start of the implicit comparisons: every species present
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)


@pytest.mark.parametrize(
    "backward_rate,variant,prec,tiled,implicit",
    [(b, v, "LU_SGS", False, None) for b, v in VARIANTS]
    + [(b, v, "JACOBI", False, None) for b, v in VARIANTS]
    + [(False, "isothermal", "LU_SGS", True, None),
       (False, "slip_heatflux_mass_flow", "LU_SGS", True, None),
       (False, "total_conditions", "LU_SGS", False, None),
       (False, "shared_corners", "LU_SGS", False, None),
       (False, "isothermal", "JACOBI", False, IMPLICIT),
       (False, "isothermal", "JACOBI", False, (True, None)),
       (False, "isothermal", "JACOBI", False, (False, None)),
       (False, "isothermal", "JACOBI", True, IMPLICIT),
       (False, "slip_heatflux_mass_flow", "JACOBI", False, IMPLICIT),
       (False, "isothermal", "LU_SGS", False, IMPLICIT),
       (False, "isothermal", "ILU0", False, IMPLICIT)],
    ids=VARIANT_IDS + [f"{i}-jacobi" for i in VARIANT_IDS]
    + ["keq-tiled", "slip_heatflux_mass_flow-tiled", "total_conditions",
       "shared_corners", "implicit", "implicit-nolimiter",
       "implicit-firstorder", "implicit-tiled",
       "implicit-slip_heatflux_mass_flow", "implicit-lusgs", "implicit-ilu0"])
def test_three_coupled_iterations_match_jax(tmp_path, monkeypatch,
                                            backward_rate, variant, prec,
                                            tiled, implicit):
    """Every output field of 3 coupled iterations from the same state:
    rtol 1e-9, atol 1e-12 max|field|.  The module tests hold single
    evaluations at 1e-12..5e-12; three explicit steps compound those
    rounding differences (FGMRES orthogonalisation, secant stopping), and
    fields near zero (grad_k, the momentum of the first wall rows) carry
    them relative to their scale, hence the looser per-element rtol.
    With the default LU_SGS, su2_tpu runs the SST solve through its
    one-launch _fgmres_call in interpret mode and the port through its
    plain FGMRES over the plain sweep; JACOBI bypasses both.  -tiled
    forces the >= 200k-node tier on both sides (su2_tpu: the tiled
    gradient rows and the windowed edge kernel, fused edge mode on); the
    TOTAL_CONDITIONS inlet runs su2_tpu's _solve_call, the arithmetic the
    port computes; shared_corners puts two nodes in two weak flux markers
    each (the boundary scatters' order).
    implicit-*: EULER_IMPLICIT flow with JACOBI, MUSCL with the
    Venkatakrishnan limiter, unlimited MUSCL or first order; su2_tpu runs
    its fused implicit edge kernel in interpret mode.  implicit-lusgs and
    -ilu0 solve the flow's 13 x 13 block system and the SST's with the
    multicolor sweep: su2_tpu through its one-launch _fgmres_call at
    v = 13 and v = 2 in interpret mode, the port through its plain FGMRES
    over the plain sweep (in f64 at this size the one-launch tier; the
    windowed and mixed tiers are float32 only).  They start from the
    freestream with every species present (MIXED_YS): in the
    case's own pure streams su2_tpu's effective diffusion (1 - x_s over a
    trace-sized sum) and the port's (sum_{k!=s} x_k over it,
    ops/viscous_t.py) differ by 1 - sum_k x_k, which sets su2_tpu's there;
    test_torch_pure_streams.py holds those states."""
    from su2_tpu.pallas import edge_kernels as ek, inlet_tc as jtc
    from su2_tpu_torch.ops import gradients
    text = th.case_variant(
        th.write_case(tmp_path, backward_rate=backward_rate), variant)
    text = (th.with_implicit(text, *implicit, prec=prec) if implicit
            else th.with_prec(text, prec))
    js, ts = th.jax_sim(text), th.torch_sim(text)
    if tiled:
        monkeypatch.setenv("SU2_TPU_TILED_GRAD", "1")
        monkeypatch.setenv("SU2_TPU_WIN_EDGE", "1")
        monkeypatch.setattr(gradients, "TILED_MIN_NODES", 0)
    ek.set_edge_kernel_mode(tiled or implicit is not None)
    jtc.set_inlet_tc_mode(variant == "total_conditions")
    try:
        step = jax.jit(js._make_rans_step())
        _three_steps(js, ts, step, mixed=implicit is not None)
    finally:
        ek.set_edge_kernel_mode(False)
        jtc.set_inlet_tc_mode(False)


def _three_steps(js, ts, step, mixed=False):
    from su2_tpu_torch.convert import state_from_numpy
    j_state = (js.u0, js.t0) + tuple(js.initial_turb_state())
    # the port starts from the JAX carry, which equals its own initial state
    t_state = state_from_numpy(*(np.asarray(x) for x in j_state))
    own = (ts.u0, ts.t0) + tuple(ts.initial_turb_state())
    for a, b in zip(t_state, own):
        assert torch.equal(a, b)
    if mixed:
        u = th.mixed_state(ts, ys=MIXED_YS)
        j_state = (jnp.asarray(u),) + j_state[1:]
        t_state = (th.tt(u),) + t_state[1:]
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


UNPORTED = [
    ({"LINEAR_SOLVER_PREC": "LU_SGS_WAVE"}, "su2_tpu.linalg.wavefront"),
    ({"LINEAR_SOLVER_PREC": "LU_SGS_SEQ"}, "su2_tpu.linalg.seq_sgs"),
    ({"MGLEVEL": "1"}, "su2_tpu.multigrid"),
    ({"SYSTEM_MEASUREMENTS": "US"}, "su2_tpu.units"),
    ({"CONV_NUM_METHOD_FLOW": "HLLC"}, "su2_tpu.ops"),
    ({"CONV_NUM_METHOD_FLOW": "ROE"}, "su2_tpu.ops"),
    ({"KIND_TURB_MODEL": "SA"}, "su2_tpu.turbulence"),
    ({"GRID_MOVEMENT": "YES"}, "su2_tpu.motion"),
]


@pytest.mark.parametrize("settings,where", [
    pytest.param(o, w, id="-".join(f"{k}-{v}" for k, v in o.items())
                 + f"-{w}") for o, w in UNPORTED])
def test_unported_options_raise(text, settings, where):
    """Options outside the port raise, naming the su2_tpu module that runs
    them: the wavefront and the sequential (host callback) LU-SGS sweeps,
    multigrid, US units, the HLLC and Roe schemes, the SA model and grid
    movement."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(tuple(settings))]
    with pytest.raises(NotImplementedError, match=where.replace(".", r"\.")):
        th.torch_sim("\n".join(lines + [f"{k}= {v}"
                                        for k, v in settings.items()]))


def _cli_case(tmp_path):
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io.mesh import write_su2_mesh
    write_su2_mesh(channel_mesh(*th.CHANNEL), str(tmp_path / "channel.su2"))
    text = th.write_case(tmp_path / "lib", mesh_file="channel.su2")
    cfg = tmp_path / "case.cfg"
    cfg.write_text(text)
    return cfg, dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def test_cli_two_iterations(tmp_path):
    """python -m su2_tpu_torch --cpu on a channel written as .su2: runs,
    and the history has 2 rows."""
    cfg, env = _cli_case(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(cfg), "2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "history.dat") as f:
        rows = [ln for ln in f.read().splitlines()
                if ln and ln[0].isdigit()]
    assert len(rows) == 2


def _cli_implicit(tmp_path, prec):
    """The implicit-flow case with prec through the CLI with --cpu: exits
    0, writes the restart and the volume file, and the history has 2
    finite rows."""
    cfg, env = _cli_case(tmp_path)
    cfg.write_text(th.with_implicit(cfg.read_text(), prec=prec))
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(cfg), "2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "restart_flow.dat").is_file()
    assert (tmp_path / "flow.dat").is_file()
    with open(tmp_path / "history.dat") as f:
        rows = [ln for ln in f.read().splitlines()
                if ln and ln[0].isdigit()]
    assert len(rows) == 2 and "nan" not in " ".join(rows).lower()


def test_cli_implicit_two_iterations(tmp_path):
    """The implicit-flow case (JACOBI) through the CLI: see _cli_implicit."""
    _cli_implicit(tmp_path, "JACOBI")


def test_cli_implicit_lusgs_two_iterations(tmp_path):
    """The implicit-flow case with LU_SGS for the flow's 13 x 13 and the
    SST's 2 x 2 systems (the reference flat plate's solver) through the
    CLI: see _cli_implicit."""
    _cli_implicit(tmp_path, "LU_SGS")


def test_cli_refuses_without_a_card(tmp_path):
    """Without --cpu and with no CUDA device visible the CLI exits nonzero
    and names --cpu; it never drops to the CPU by itself."""
    cfg, env = _cli_case(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", str(cfg),
                           "2"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "--cpu" in proc.stderr
    assert not (tmp_path / "history.dat").exists()
