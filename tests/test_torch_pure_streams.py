"""The implicit-flow step in the case's own pure fuel and oxygen streams,
where su2_tpu_torch departs from su2_tpu in one expression.

The viscous Jacobian's effective diffusion is D_s = f (1 - x_s) /
sum_{k!=s} den_sk x_k in su2_tpu and f sum_{k!=s} x_k / (the same sum) in
the port (ops/viscous_t.py).  The two forms differ by 1 - sum_k x_k, and
the implicit update does not keep sum_s rho_s equal to rho (the flow
system is solved to the FGMRES tolerance), so after one step the mole
fractions sum to 1 only to ~1e-9..1e-8.  Where one species is nearly pure
and the others are traces, that difference, not the traces, sets
su2_tpu's 1 - x_s.

These tests hold the port against su2_tpu from the freestream, where both
forms are exact, and against a copy of su2_tpu with that one expression
replaced by the port's form (written to a temporary directory; su2_tpu
itself is untouched), run in a subprocess with its fused implicit edge
kernel in interpret mode, as the other comparisons run su2_tpu.  The
conditioning check perturbs the state after WARM iterations by 1e-15
(relative) and measures how far one step moves, against the step checks'
tolerance rtol 1e-9, atol 1e-12 max|field|."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_helpers as th

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NITER, WARM = 20, 3
NOUT = 11               # outputs of one coupled step
# su2_tpu's 1 - x_s -> the port's sum_{k!=s} x_k, in the feature-major
# viscous Jacobian (the fused edge kernel's body) and the node-major one
# (the boundary Jacobians)
SUM_FORM = {
    os.path.join("ops", "viscous_t.py"): (
        "        ds_side = f_side[None] * (1.0 - xs_side) / "
        "jnp.where(q == 0.0, 1.0, q)\n",
        "        rest = sum((1.0 - eye_s)[:, k][:, None] * xs_side[k][None]\n"
        "                   for k in range(ns))\n"
        "        ds_side = f_side[None] * rest / jnp.where(q == 0.0, 1.0, q)\n"),
    os.path.join("ops", "viscous.py"): (
        "    ds = (1.0 - xs) / jnp.where(denom == 0.0, 1.0, denom)\n",
        "    rest = sum((1.0 - eye)[:, k] * xs[..., k:k + 1]\n"
        "               for k in range(lib.nspecies))\n"
        "    ds = rest / jnp.where(denom == 0.0, 1.0, denom)\n"),
}
# NITER coupled su2_tpu steps from the freestream (fused 1: the fused
# implicit edge kernel in interpret mode, as the driver runs it; 0: the
# XLA path), then the step from the state after WARM iterations perturbed
# by 1e-15; argv: cfg nx ny niter warm fused out.npz
RUNNER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from su2_tpu.config import Config
from su2_tpu.driver import Simulation
from su2_tpu.geometry.structured import channel_mesh
from su2_tpu.pallas import edge_kernels
cfg, out = sys.argv[1], sys.argv[7]
nx, ny, niter, warm, fused = (int(a) for a in sys.argv[2:7])
edge_kernels.set_edge_kernel_mode(bool(fused))
with open(cfg) as f:
    sim = Simulation(Config(text=f.read()), dtype=jnp.float64,
                     raw_mesh=channel_mesh(nx, ny))
step = jax.jit(sim._make_rans_step())
state = (sim.u0, sim.t0) + tuple(sim.initial_turb_state())
res = {"package": np.asarray(sys.modules["su2_tpu"].__file__)}
for it in range(niter):
    if it == warm:
        saved = state
    o = step(*state, jnp.asarray(False))
    res.update({f"{it}_{i}": np.asarray(x) for i, x in enumerate(o)})
    state = tuple(o[:6])
rng = np.random.default_rng(0)
d = 1e-15 * rng.standard_normal(np.asarray(saved[0]).shape)
o = step(saved[0] * (1.0 + jnp.asarray(d)), *saved[1:], jnp.asarray(False))
res.update({f"perturbed_{i}": np.asarray(x) for i, x in enumerate(o)})
np.savez(out, **res)
"""


def _worst(got, want):
    """Largest |got - want| / (1e-9 |want| + 1e-12 max|want|) over the
    fields (inf where either is not finite)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = np.abs(w).max() if w.size else 0.0
        if not np.isfinite(scale) or not np.isfinite(g).all():
            return np.inf
        if scale == 0.0:
            if (g != 0.0).any():
                return np.inf
            continue
        r = np.abs(g - w) / (1e-9 * np.abs(w) + 1e-12 * scale)
        worst = max(worst, float(r.max()))
    return worst


def _sum_y_error(u, lay):
    """max over nodes of |sum_s rho_s / rho - 1|."""
    u = np.asarray(u)
    return float(np.abs(u[:, lay.RHOS:].sum(1) / u[:, lay.RHO] - 1.0).max())


def _start_su2_tpu(root, cfg, shape, fused, out, cwd):
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", RUNNER, cfg, str(shape[0]), str(shape[1]),
         str(NITER), str(WARM), str(int(fused)), out], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _sum_form_copy(dst):
    """A copy of su2_tpu under dst with the port's form of D_s."""
    shutil.copytree(os.path.join(REPO, "su2_tpu"),
                    os.path.join(dst, "su2_tpu"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, (old, new) in SUM_FORM.items():
        path = os.path.join(dst, "su2_tpu", rel)
        with open(path) as f:
            src = f.read()
        assert src.count(old) == 1, rel
        with open(path, "w") as f:
            f.write(src.replace(old, new))


def pure_stream_runs(tmp, shape, xla=False):
    """su2_tpu as it is ("jax") and with the port's form ("sum_form"; with
    xla also "sum_form_xla", its XLA path), each in a subprocess, and the
    port ("port"), NITER implicit iterations from the freestream of the
    implicit case on channel_mesh(*shape), float64 on the CPU.  Each is
    {"steps": [outputs per iteration], "perturbed": outputs of the
    perturbed step}."""
    tmp = str(tmp)
    text = th.with_implicit(th.write_case(os.path.join(tmp, "case")))
    cfg = os.path.join(tmp, "case.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    copy = os.path.join(tmp, "sum_form")
    _sum_form_copy(copy)
    roots = {"jax": (REPO, True), "sum_form": (copy, True)}
    if xla:
        roots["sum_form_xla"] = (copy, False)
    procs = {}
    for name, (root, fused) in roots.items():
        out = os.path.join(tmp, f"{name}.npz")
        procs[name] = (_start_su2_tpu(root, cfg, shape, fused, out, tmp),
                       out)
    ts = th.torch_sim(text, shape=shape)
    state = (ts.u0, ts.t0) + tuple(ts.initial_turb_state())
    steps = []
    for it in range(NITER):
        if it == WARM:
            saved = state
        o = ts._step(*state)
        steps.append([th.npy(x) for x in o])
        state = tuple(o[:6])
    d = 1e-15 * np.random.default_rng(0).standard_normal(
        tuple(saved[0].shape))
    perturbed = ts._step(saved[0] * (1.0 + th.tt(d)), *saved[1:])
    runs = {"port": {"steps": steps,
                     "perturbed": [th.npy(x) for x in perturbed]},
            "lay": ts.lay}
    for name, (proc, out) in procs.items():
        log = proc.communicate(timeout=900)[0]
        assert proc.returncode == 0, log[-4000:]
        z = np.load(out)
        assert str(z["package"]).startswith(roots[name][0]), name
        runs[name] = {
            "steps": [[z[f"{it}_{i}"] for i in range(NOUT)]
                      for it in range(NITER)],
            "perturbed": [z[f"perturbed_{i}"] for i in range(NOUT)]}
    return runs


def conditioning(run):
    """How far the perturbed step moved, in units of the tolerance."""
    return _worst(run["perturbed"], run["steps"][WARM])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pure_stream_runs(tmp_path_factory.mktemp("pure"), th.CHANNEL)


def test_first_implicit_step_from_freestream_matches_jax(runs):
    """The first implicit step from the case's own freestream (pure fuel
    and oxygen streams, the traces of the other species exactly 0, so
    1 - x_s and sum_{k!=s} x_k are both exact): every output against
    su2_tpu as it is at rtol 1e-9, atol 1e-12 max|field|."""
    th.assert_fields_close(runs["port"]["steps"][0], runs["jax"]["steps"][0],
                           1e-9, 1e-12, [f"out{i}" for i in range(NOUT)])


def test_sum_form_su2_tpu_matches_port_at_pure_streams(runs):
    """su2_tpu with 1 - x_s replaced by sum_{k!=s} x_k runs NITER implicit
    iterations at CFL 1 from the freestream, finite, and every output of
    every iteration agrees with the port at rtol 1e-9, atol 1e-12
    max|field|; the mass fractions of both sum to 1 within 2e-9."""
    lay = runs["lay"]
    for it in range(NITER):
        got, want = runs["port"]["steps"][it], runs["sum_form"]["steps"][it]
        print(f"iteration {it}: port vs su2_tpu with the port's form "
              f"{_worst(got, want):.3e}, vs su2_tpu as it is "
              f"{_worst(got, runs['jax']['steps'][it]):.3e} (in units of "
              f"the step tolerance); max|sum y - 1| port "
              f"{_sum_y_error(got[0], lay):.2e}, su2_tpu with the port's "
              f"form {_sum_y_error(want[0], lay):.2e}, su2_tpu as it is "
              f"{_sum_y_error(runs['jax']['steps'][it][0], lay):.2e}")
        assert all(np.isfinite(w).all() for w in want), it
        assert _worst(got, want) <= 1.0, (it, _worst(got, want))
        assert _sum_y_error(want[0], lay) < 2e-9, it
        assert _sum_y_error(got[0], lay) < 2e-9, it


def test_su2_tpu_step_is_ill_conditioned_at_pure_streams(runs):
    """After WARM iterations from the freestream, a 1e-15 relative
    perturbation of the state moves one step of su2_tpu as it is by more
    than 1e3 times the step tolerance, and of su2_tpu with the port's form,
    like the port's, by less than the tolerance: the one expression
    accounts for it.  su2_tpu as it is departs from the port by more than
    1e3 times the tolerance within NITER iterations."""
    # the perturbed state has nodes of one nearly pure species with traces
    # of others
    u = runs["port"]["steps"][WARM - 1][0]
    lay = runs["lay"]
    ys = u[:, lay.RHOS:] / u[:, lay.RHO:lay.RHO + 1]
    assert ((ys.max(1) > 1.0 - 1e-12) & (np.sort(ys, 1)[:, -2] > 0.0)).any()
    print(f"conditioning: su2_tpu {conditioning(runs['jax']):.3e}, with "
          f"the port's form {conditioning(runs['sum_form']):.3e}, port "
          f"{conditioning(runs['port']):.3e}")
    assert conditioning(runs["jax"]) > 1e3
    assert conditioning(runs["sum_form"]) < 1.0
    assert conditioning(runs["port"]) < 1.0
    assert max(_worst(runs["port"]["steps"][it], runs["jax"]["steps"][it])
               for it in range(NITER)) > 1e3


@pytest.mark.slow
def test_pure_streams_at_9072_nodes(tmp_path):
    """The same runs at 9,072 nodes (channel_mesh(189, 48)).  su2_tpu as it
    is turns non-finite within NITER iterations; with the port's form it
    stays finite for NITER iterations at CFL 1, agrees with the port at
    the step tolerance for the first 3 iterations, and then departs from
    it by at most 10 times as much as its own two paths (the fused kernel
    and XLA, one formula) depart from each other."""
    runs = pure_stream_runs(tmp_path, (189, 48), xla=True)
    lay = runs["lay"]
    bad = [it for it in range(NITER)
           if not np.isfinite(runs["jax"]["steps"][it][0]).all()]
    assert bad
    print(f"su2_tpu as it is: non-finite state from iteration {bad[0] + 1} "
          f"of {NITER}")
    port, sub = runs["port"]["steps"], runs["sum_form"]["steps"]
    xla = runs["sum_form_xla"]["steps"]
    for it in range(NITER):
        assert all(np.isfinite(w).all() for w in sub[it] + xla[it]), it
        assert all(np.isfinite(g).all() for g in port[it]), it
        own, vs_port = _worst(xla[it], sub[it]), _worst(port[it], sub[it])
        print(f"iteration {it}: port vs su2_tpu with the port's form "
              f"{vs_port:.3e}, vs su2_tpu as it is "
              f"{_worst(port[it], runs['jax']['steps'][it]):.3e}, su2_tpu's "
              f"XLA vs fused path {own:.3e} (in units of the step "
              f"tolerance); max|sum y - 1| port "
              f"{_sum_y_error(port[it][0], lay):.2e}, su2_tpu with the "
              f"port's form {_sum_y_error(sub[it][0], lay):.2e}")
        if it < 3:
            assert vs_port <= 1.0, (it, vs_port)
        else:
            assert vs_port <= 10.0 * max(own, 1.0), (it, vs_port, own)
    print(f"conditioning: su2_tpu {conditioning(runs['jax']):.3e}, with "
          f"the port's form {conditioning(runs['sum_form']):.3e}, port "
          f"{conditioning(runs['port']):.3e}")
