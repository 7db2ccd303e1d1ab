"""Dual time stepping of the port against su2_tpu's on the 153-node
synthetic channel in float64: ns.add_dual_time (BDF1 and BDF2, with and
without the implicit system), Simulation.run_unsteady (explicit flow BDF2
from the freestream, implicit LU_SGS BDF1 from a state with every species
present), the unsteady solution files of WRT_SOL_FREQ_DUALTIME, and the
refusals (laminar dual time, run and the CLI with a dual-time cfg).
su2_tpu runs its XLA modes (explicit flow) or its fused implicit edge
kernel in interpret mode (implicit flow), as tests/test_torch_slice.py
does."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th
from test_torch_output import assert_text_close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL_FRAC = 1e-12, 1e-12
# the implicit flow's residual norms (test_torch_multistep.py)
IMPLICIT_RES_RTOL = 5e-12
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)
TURB = ("q", "mu_t", "grad_k", "sigma_k")
DUAL = {1: "DUAL_TIME_STEPPING-1ST_ORDER", 2: "DUAL_TIME_STEPPING-2ND_ORDER"}


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.write_case(tmp_path_factory.mktemp("dual"))


def dual_text(text, order, inner=3, dt="2e-5", **more):
    return th.with_lines(text, UNSTEADY_SIMULATION=DUAL[order],
                         UNST_TIMESTEP=dt, UNST_INT_ITER=str(inner), **more)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("with_jac", [False, True], ids=["explicit",
                                                         "implicit"])
def test_add_dual_time_matches_jax(order, with_jac):
    """The BDF source and the diagonal Vol/dt (3/2 Vol/dt at order 2) on
    random inputs: rtol 1e-12, atol 1e-12 max|field|."""
    from su2_tpu.linalg.blockcsr import StencilJacobianT as JJac
    from su2_tpu.solvers import ns as jns
    from su2_tpu.state import Layout as JLayout
    from su2_tpu_torch.linalg.blockcsr import StencilJacobianT
    from su2_tpu_torch.solvers import ns
    from su2_tpu_torch.state import Layout
    rng = np.random.default_rng(order + 2 * with_jac)
    n, nv = 40, 13
    vol = rng.uniform(1e-6, 1e-4, n)
    res, u, un, unm1 = (rng.normal(0.0, 1.0, (n, nv)) for _ in range(4))
    diag = rng.normal(0.0, 1.0, (n, nv, nv))
    sel_t = rng.normal(0.0, 1.0, (4 * nv * nv, n))
    jr, jj = jns.add_dual_time(
        JLayout(2, 9), SimpleNamespace(volume=jnp.asarray(vol)),
        jnp.asarray(res), JJac(jnp.asarray(diag), jnp.asarray(sel_t))
        if with_jac else None, *map(jnp.asarray, (u, un, unm1)), 3e-5,
        order)
    tr, tj = ns.add_dual_time(
        Layout(2, 9), SimpleNamespace(volume=th.tt(vol)), th.tt(res),
        StencilJacobianT(th.tt(diag), th.tt(sel_t)) if with_jac else None,
        *map(th.tt, (u, un, unm1)), 3e-5, order)
    th.assert_fields_close([tr], [np.asarray(jr)], RTOL, ATOL_FRAC, ["res"])
    if with_jac:
        th.assert_fields_close([tj.diag], [np.asarray(jj.diag)], RTOL,
                               ATOL_FRAC, ["diag"])
        assert torch.equal(tj.sel_t, th.tt(sel_t))
    else:
        assert tj is None and jj is None


def unsteady_both(text, n_steps, u=None, implicit=False, out=None):
    """run_unsteady of both packages (quiet) from u (numpy; None: the
    freestream), writing into out/{jax,port} when given: (port's result,
    su2_tpu's as numpy)."""
    from su2_tpu.pallas import edge_kernels as ek
    js, ts = th.jax_sim(text), th.torch_sim(text)
    if u is not None:
        js.u0, ts.u0 = jnp.asarray(u), th.tt(u)
    if out is not None:
        for sim, d in ((js, "jax"), (ts, "port")):
            (out / d).mkdir()
            sim.enable_output(str(out / d))
    ek.set_edge_kernel_mode(implicit)
    try:
        want = js.run_unsteady(n_steps, quiet=True)
    finally:
        ek.set_edge_kernel_mode(False)
    want = (np.asarray(want[0]), np.asarray(want[1]), want[2],
            [np.asarray(x) for x in want[3]])
    return ts.run_unsteady(n_steps, quiet=True), want


def test_run_unsteady_explicit_bdf2_matches_jax(text):
    """Explicit flow, BDF2: 2 physical steps of 3 inner iterations (the
    pseudo time step bounded by 2/3 of the physical one) from the
    freestream: the state, the history of log10 RMS per physical step and
    the turbulence state within rtol 1e-12, atol 1e-12 max|field|."""
    got, want = unsteady_both(dual_text(text, 2), 2)
    assert got[2].shape == (2, 13)
    th.assert_fields_close(got[:3], want[:3], RTOL, ATOL_FRAC,
                           ("u", "t", "hist"))
    th.assert_fields_close(got[3], want[3], RTOL, ATOL_FRAC, TURB)


def test_run_unsteady_implicit_lusgs_bdf1_matches_jax(text, monkeypatch):
    """Implicit flow (MUSCL + Venkatakrishnan) with LU_SGS, BDF1 (the dual
    diagonal on the 13 x 13 blocks): 2 physical steps of 2 inner
    iterations from th.mixed_state, as test_run_unsteady_explicit_*; the
    history (log10 of the implicit residual norm) within
    IMPLICIT_RES_RTOL.  su2_tpu runs its FGMRES loop over its
    per-iteration sweep + matvec kernel (SU2_TPU_FUSED_FGMRES_OFF: its
    one-launch cycle takes twice as long to trace in interpret mode), the
    arithmetic of the port's plain one-launch cycle
    (stencil_solve.fgmres_plain)."""
    monkeypatch.setenv("SU2_TPU_FUSED_FGMRES_OFF", "1")
    ts = th.torch_sim(text)
    u = th.mixed_state(ts, ys=MIXED_YS)
    t = dual_text(th.with_implicit(text, prec="LU_SGS"), 1, inner=2)
    got, want = unsteady_both(t, 2, u=u, implicit=True)
    th.assert_fields_close(got[:2], want[:2], RTOL, ATOL_FRAC, ("u", "t"))
    th.assert_fields_close([got[2]], [want[2]], IMPLICIT_RES_RTOL,
                           ATOL_FRAC, ["hist"])
    th.assert_fields_close(got[3], want[3], RTOL, ATOL_FRAC, TURB)


@pytest.mark.parametrize("freq", [1, 2])
def test_unsteady_files_match_jax(text, tmp_path, freq):
    """After enable_output, 3 physical steps of 1 inner iteration write
    every WRT_SOL_FREQ_DUALTIME physical steps: the same file names as
    su2_tpu's (restart_flow_%05d.dat of the step, the volume and surface
    files of the last write, the history header), each holding su2_tpu's
    text but for one unit of its format's last digit (the restarts at 15
    significant digits: tests/test_torch_output.py's comparison)."""
    from test_torch_output import assert_file_close
    t = dual_text(text, 2, inner=1, WRT_SOL_FREQ_DUALTIME=str(freq))
    got, _ = unsteady_both(t, 3, out=tmp_path)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    want_restarts = [f"restart_flow_{s:05d}.dat" for s in range(3)
                     if (s + 1) % freq == 0]
    assert [n for n in names if n.startswith("restart")] == want_restarts
    npoint = got[0].shape[0]
    for name in names:
        g, w = (str(tmp_path / d / name) for d in ("port", "jax"))
        if name.startswith("restart_flow_"):
            with open(g) as fg, open(w) as fw:
                assert_text_close(fg.read(), fw.read(), 15)
        else:
            assert_file_close(g, w, npoint, 128)


def test_laminar_dual_time_and_run_are_refused(text):
    """run_unsteady drives the RANS step only (su2_tpu asserts it);
    run() with a dual-time cfg raises and names run_unsteady."""
    ts = th.torch_sim(th.cases.with_laminar(dual_text(text, 1)))
    with pytest.raises(ValueError, match="REACTIVE_RANS"):
        ts.run_unsteady(1, quiet=True)
    with pytest.raises(ValueError, match="run_unsteady"):
        ts.run(1, quiet=True)
    ts = th.torch_sim(dual_text(text, 2))
    with pytest.raises(ValueError, match="run_unsteady"):
        ts.run(1, quiet=True)
    with pytest.raises(ValueError, match="u_n"):
        ts._step(ts.u0, ts.t0, *ts.initial_turb_state())


def test_cli_refuses_dual_time(tmp_path):
    """The CLI runs the steady loop: a dual-time cfg exits nonzero naming
    run_unsteady, before any file is written."""
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io.mesh import write_su2_mesh
    write_su2_mesh(channel_mesh(*th.CHANNEL), str(tmp_path / "channel.su2"))
    cfg = tmp_path / "case.cfg"
    cfg.write_text(dual_text(th.write_case(tmp_path / "lib",
                                           mesh_file="channel.su2"), 2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "su2_tpu_torch", "--cpu",
                           str(cfg), "2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "run_unsteady" in proc.stderr
    assert not (tmp_path / "history.dat").exists()


def test_unsteady_chunk_is_its_steps(text):
    """The port's physical step equals UNST_INT_ITER of its own steps
    with (u_n, u_nm1) bit for bit (the chunk of _multistep)."""
    ts = th.torch_sim(dual_text(text, 2, inner=2))
    u, t, hist, turb = ts.run_unsteady(2, quiet=True)
    state = (ts.u0, ts.t0) + tuple(ts.initial_turb_state())
    u_n = u_nm1 = ts.u0
    for _ in range(2):
        for _ in range(2):
            out = ts._step(*state, u_n=u_n, u_nm1=u_nm1)
            state = out[:6]
        u_nm1, u_n = u_n, state[0]
    for a, b in zip((u, t) + turb, state):
        assert torch.equal(a, b)
    assert np.array_equal(hist[-1], np.log10(np.maximum(
        out[6].numpy(), 1e-300)))
