"""The port's device-chunked main loop against su2_tpu's on the 153-node
synthetic channel in float64: Simulation.rans_multistep and
flow_multistep (the final carry and every stacked history), the chunked
run (state, history and the history file's numbering), IGNITION with a
window that ends inside a chunk, CFL_ADAPT (the CFL sequence and the
residual history) and the CLI's chunk (SU2_TPU_CHUNK).  On the CPU the
port runs the step eagerly; the chunked run also equals its own
per-iteration run bit for bit.  su2_tpu runs its XLA modes (explicit
flow) or its fused implicit edge kernel in interpret mode (implicit
flow), as tests/test_torch_slice.py does; JACOBI throughout, so no
one-launch FGMRES is traced."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

# |port - su2_tpu| <= RTOL |su2_tpu| + ATOL_FRAC max|su2_tpu|, per field;
# the implicit flow's residual norms (rms, rmax of the system's right-hand
# side, whose entries sum edge fluxes that cancel) at IMPLICIT_RES_RTOL:
# K10's edge flux itself holds at 1e-11 max|flux|
# (tests/test_torch_edge_implicit.py)
RTOL, ATOL_FRAC = 1e-12, 1e-12
IMPLICIT_RES_RTOL = 5e-12
# the mixed start of the implicit comparisons (test_torch_slice.MIXED_YS)
MIXED_YS = (0.01, 0.1, 0.59, 0.05, 0.15, 0.02, 0.03, 0.03, 0.02)
# a fuel-rich mixing composition: Y_fuel > 0.4 and Y_ox > 0.2, the nodes
# the IGNITION override selects
RICH_YS = (0.45, 0.05, 0.3, 0.04, 0.08, 0.02, 0.02, 0.02, 0.02)
RANS_HIST = ("rms", "rmax", "turb_rms", "nerr", "min_dt")
FLOW_HIST = ("rms", "rmax", "nerr", "min_dt")
CARRY = ("u", "t", "q", "mu_t", "grad_k", "sigma_k")


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return th.with_prec(th.write_case(tmp_path_factory.mktemp("multistep")),
                        "JACOBI")


with_lines = th.with_lines


def variant_text(text, kind):
    """explicit / implicit RANS, laminar-explicit / laminar-implicit."""
    if kind.startswith("laminar"):
        text = th.cases.with_laminar(text)
    if kind.endswith("implicit"):
        text = th.with_implicit(text)
    return text


def edge_mode(on):
    from su2_tpu.pallas import edge_kernels as ek
    ek.set_edge_kernel_mode(on)


def start_state(ts, implicit):
    """The numpy start (u, T) of both packages: the freestream, or with
    implicit flow the freestream with every species present."""
    u = th.mixed_state(ts, ys=MIXED_YS) if implicit else th.npy(ts.u0)
    return u, th.npy(ts.t0)


@pytest.mark.parametrize("kind", ["explicit", "implicit", "laminar-explicit",
                                  "laminar-implicit"])
def test_multistep_matches_jax(text, kind):
    """Three iterations of rans_multistep (RANS) or flow_multistep
    (laminar) of both packages from the same state: the final carry and
    each stacked history within RTOL (the implicit residual norms within
    IMPLICIT_RES_RTOL); the port's multistep equals three of its own
    steps bit for bit."""
    text = variant_text(text, kind)
    implicit = kind.endswith("implicit")
    js, ts = th.jax_sim(text), th.torch_sim(text)
    u, t = start_state(ts, implicit)
    k = 3
    edge_mode(implicit)
    try:
        if ts.turbulent:
            turb = [th.npy(x) for x in ts.initial_turb_state()]
            jc, jy = js.rans_multistep(jnp.asarray(u), jnp.asarray(t),
                                       *map(jnp.asarray, turb),
                                       jnp.zeros(k, bool))
        else:
            jc, jy = js.flow_multistep(jnp.asarray(u), jnp.asarray(t), k)
        jc, jy = [np.asarray(x) for x in jc], [np.asarray(x) for x in jy]
    finally:
        edge_mode(False)
    carry = (th.tt(u), th.tt(t))
    if ts.turbulent:
        carry += tuple(th.tt(x) for x in turb)
        tc, ty = ts.rans_multistep(*carry, np.zeros(k, bool))
        names = RANS_HIST
    else:
        tc, ty = ts.flow_multistep(*carry, k)
        names = FLOW_HIST
    assert all(y.shape[0] == k for y in ty)
    th.assert_fields_close(tc, jc, RTOL, ATOL_FRAC, CARRY)
    nres = 2 if implicit else 0
    th.assert_fields_close(ty[:nres], jy[:nres], IMPLICIT_RES_RTOL,
                           ATOL_FRAC, names[:nres])
    th.assert_fields_close(ty[nres:], jy[nres:], RTOL, ATOL_FRAC,
                           names[nres:])
    # the same iterations through the port's eager step
    nc = len(carry)
    state, rows = carry, []
    for _ in range(k):
        out = ts._step(*state)
        state, rows = out[:nc], rows + [out[nc:]]
    for a, b in zip(tc, state):
        assert torch.equal(a, b)
    for j, row in enumerate(rows):
        for name, y, want in zip(names, ty, row):
            assert torch.equal(y[j], want.to(y.dtype)), (name, j)


def history_iterations(path):
    with open(path) as f:
        return [int(float(ln.split(",")[0])) for ln in f.read().splitlines()
                if ln and ln[0].isdigit()]


def run_both(text, tmp_path, niter, chunk, u=None, implicit=False):
    """The run of both packages (quiet, with the history file) from u (or
    the freestream): (port's result, su2_tpu's as numpy, port's history
    iterations, su2_tpu's)."""
    js, ts = th.jax_sim(text), th.torch_sim(text)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    js.enable_output(str(tmp_path / "jax"))
    ts.enable_output(str(tmp_path / "torch"))
    edge_mode(implicit)
    try:
        want = js.run(niter, quiet=True, chunk=chunk,
                      u=None if u is None else jnp.asarray(u))
    finally:
        edge_mode(False)
    got = ts.run(niter, quiet=True, chunk=chunk,
                 u=None if u is None else th.tt(u))
    return (ts, got, want, history_iterations(tmp_path / "torch/history.dat"),
            history_iterations(tmp_path / "jax/history.dat"))


def assert_runs_close(got, want):
    th.assert_fields_close(got[:3], want[:3], RTOL, ATOL_FRAC,
                           ("u", "t", "hist"))
    if len(got) == 4:
        th.assert_fields_close(got[3], want[3], RTOL, ATOL_FRAC, CARRY[2:])


def assert_runs_equal(a, b):
    assert np.array_equal(a[2], b[2])
    for x, y in zip(a[:2] + tuple(a[3]), b[:2] + tuple(b[3])):
        assert torch.equal(x, y)


def test_chunked_run_matches_jax_and_per_iteration(text, tmp_path):
    """run(niter=7, chunk=3): two chunks and a tail chunk of one
    iteration (su2_tpu runs its tail through the per-iteration path, the
    port replays the same step): state, history and the history file's
    absolute iteration numbers 0..6 as su2_tpu's; bit for bit the port's
    run(niter=7, chunk=1)."""
    ts, got, want, it_t, it_j = run_both(text, tmp_path, 7, 3)
    assert got[2].shape == (7, ts.lay.nvar) and np.isfinite(got[2]).all()
    assert it_t == it_j == list(range(7))
    assert_runs_close(got, want)
    assert_runs_equal(got, th.torch_sim(text).run(7, quiet=True, chunk=1))


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_ignition_window_ends_inside_a_chunk(text, tmp_path, implicit):
    """IGNITION= YES with IGNITION_ITER= 4 and chunk 3: the window ends
    inside the second chunk.  From a mixing state with fuel-rich nodes
    (the override selects some: asserted), both packages' run(7) agree,
    with explicit flow and with implicit flow (where both recompute the
    transport and dp/du from the overridden state), the override changed
    the run (against the same run without IGNITION), and the port's
    chunked run equals its per-iteration run bit for bit."""
    from su2_tpu_torch import state as st
    if implicit:
        text = th.with_implicit(text)
    itext = with_lines(text, IGNITION="YES", IGNITION_ITER=4,
                       IGNITION_TEMPERATURE=1700.0, FUEL_INDEX=0,
                       OXIDIZER_INDEX=2)
    ts = th.torch_sim(itext)
    n = ts.mesh.npoint
    ys = np.where((np.arange(n) % 3 == 0)[:, None], RICH_YS, MIXED_YS)
    u = th.mixed_state(ts, ys=ys, seed=4)
    lay, cfg = ts.lay, ts.cfg
    v = st.node_state(ts.lib, lay, th.tt(u), ts.t0, ts.tparams,
                      turb_ke=ts.initial_turb_state()[0][:, 0]).v
    mask = ((v[:, lay.YS + cfg.fuel_index] > 0.4)
            & (v[:, lay.YS + cfg.oxidizer_index] > 0.2)
            & (v[:, lay.T] < cfg.ignition_temperature))
    assert int(mask.sum()) >= n // 4
    ts, got, want, it_t, it_j = run_both(itext, tmp_path, 7, 3, u=u,
                                         implicit=implicit)
    assert it_t == it_j == list(range(7))
    assert_runs_close(got, want)
    assert_runs_equal(got, th.torch_sim(itext).run(7, u=th.tt(u),
                                                   quiet=True, chunk=1))
    plain = th.torch_sim(text).run(7, u=th.tt(u), quiet=True, chunk=3)
    assert not torch.equal(plain[1], got[1])


def test_cfl_adapt_matches_jax(text, tmp_path):
    """CFL_ADAPT= YES for 6 iterations: the CFL each iteration runs with
    (recorded from the step's argument) and the residual history as
    su2_tpu's per-iteration run (which CFL_ADAPT selects whatever the
    chunk), the CFL moving within CFL_ADAPT_PARAM's bounds."""
    atext = with_lines(text, CFL_ADAPT="YES",
                       CFL_ADAPT_PARAM="( 1.5, 0.5, 0.05, 0.15 )")
    js, ts = th.jax_sim(atext), th.torch_sim(atext)
    seen = {"jax": [], "torch": []}

    def record(sim, key):
        step = sim._step

        def call(*args, cfl=None, **kw):
            seen[key].append(float(np.asarray(
                cfl.cpu() if isinstance(cfl, torch.Tensor) else cfl)))
            return step(*args, cfl=cfl, **kw)
        sim._step = call

    record(js, "jax")
    record(ts, "torch")
    want = js.run(6, quiet=True, chunk=5)
    got = ts.run(6, quiet=True, chunk=5)
    assert len(seen["torch"]) == len(seen["jax"]) == 6
    np.testing.assert_allclose(seen["torch"], seen["jax"], rtol=RTOL)
    assert seen["torch"][0] == 0.1 and len(set(seen["torch"])) > 2
    assert all(0.05 < c < 0.15 for c in seen["torch"][1:])
    np.testing.assert_allclose(ts.cfl_now, js.cfl_now, rtol=RTOL)
    assert_runs_close(got, want)


@pytest.mark.parametrize("env,adapt,want", [
    ({}, False, 25), ({}, True, 1), ({"SU2_TPU_CHUNK": "4"}, False, 4),
    ({"SU2_TPU_CHUNK": "5"}, True, 5), ({"SU2_TPU_CHUNK": "0"}, False, 1),
    ({}, "monitor", 1)])
def test_main_chunk(text, tmp_path, monkeypatch, env, adapt, want):
    """The CLI's chunk (su2_tpu's main): SU2_TPU_CHUNK where set (at least
    1), else 1 under CFL_ADAPT or MARKER_MONITORING ("monitor") and 25
    otherwise; main passes it to run (here a stub returning the start
    state, which main writes)."""
    from su2_tpu_torch import driver
    cfg_text = with_lines(text, CFL_ADAPT="YES" if adapt is True else "NO")
    if adapt == "monitor":
        cfg_text = with_lines(cfg_text, MARKER_MONITORING="( lower_wall )")
    cfg = tmp_path / "case.cfg"
    cfg.write_text(cfg_text.replace("CONFIG_LIB_FILE", "MESH_FILENAME= "
                                    "channel.su2\nCONFIG_LIB_FILE"))
    from su2_tpu_torch.geometry.structured import channel_mesh
    from su2_tpu_torch.io.mesh import write_su2_mesh
    write_su2_mesh(channel_mesh(*th.CHANNEL), str(tmp_path / "channel.su2"))
    monkeypatch.delenv("SU2_TPU_CHUNK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    chunks = []

    def run(self, niter, chunk=1, **kw):
        chunks.append((niter, chunk))
        return self.u0, self.t0, np.zeros((0, self.lay.nvar)), \
            self.initial_turb_state()
    monkeypatch.setattr(driver.Simulation, "run", run)
    assert driver.main([str(cfg), "3", "--cpu"]) == 0
    assert chunks == [(3, want)]
    assert driver.chunk_size(driver.Config(str(cfg)), env) == want


def test_nan_raises_at_its_iteration(text):
    """A NaN residual in the second iteration of a chunk raises naming
    that iteration, before the chunk's rows reach the history."""
    ts = th.torch_sim(text)
    step, calls = ts._step, []

    def poisoned(*args, **kw):
        out = list(step(*args, **kw))
        calls.append(1)
        if len(calls) == 5:
            out[6] = out[6] * float("nan")
        return tuple(out)
    ts._step = poisoned
    with pytest.raises(RuntimeError, match="NaN residual at iteration 4"):
        ts.run(7, quiet=True, chunk=3)


def test_residual_convergence_inside_a_chunk(text):
    """RESIDUAL convergence detected inside a chunk: the history is cut
    at that iteration (the per-iteration run's), the state is the
    chunk's last (su2_tpu's _run_chunked)."""
    ctext = with_lines(text, CONV_CRITERIA="RESIDUAL", STARTCONV_ITER=1,
                       RESIDUAL_MINVAL=10)
    per = th.torch_sim(ctext).run(7, quiet=True, chunk=1)
    chunked = th.torch_sim(ctext).run(7, quiet=True, chunk=4)
    assert per[2].shape[0] == chunked[2].shape[0] == 3
    assert np.array_equal(per[2], chunked[2])
    four = th.torch_sim(text).run(4, quiet=True, chunk=4)
    assert torch.equal(chunked[0], four[0])
    assert not torch.equal(per[0], four[0])


def test_multistep_refuses_the_other_kind(text):
    """rans_multistep belongs to a REACTIVE_RANS Simulation,
    flow_multistep to a laminar one."""
    ts = th.torch_sim(text)
    with pytest.raises(ValueError, match="flow_multistep"):
        ts.flow_multistep(ts.u0, ts.t0, 2)
    lam = th.torch_sim(th.cases.with_laminar(text))
    with pytest.raises(ValueError, match="rans_multistep"):
        lam.rans_multistep(lam.u0, lam.t0, None, None, None, None,
                           np.zeros(2, bool))
