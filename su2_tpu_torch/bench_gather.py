"""Times the two neighbour-block layouts of the gather solve on one GPU.

On a mesh without a static stencil the SST system is a BlockJacobian, and
linalg/blockcsr.py runs its matvec and multicolor sweep in torch gather
ops.  The neighbour block of every (node, slot) can be gathered

  node-major  (nP, D, v, v), the slot products summed in one reduction, or
  slot-major  (D*nP, v, v), the slots summed one by one in slot order (the
              JAX package's form from 16,384 nodes up).

For each size of the scrambled triangle channel (cases.tri_channel_mesh:
9,072 and 142,317 nodes) this script builds the explicit LU_SGS case in
float32 and runs Simulation.run with each layout patched into blockcsr, in
the order A B B A from the same initial state: ms/iter of the timed run,
then CUDA launches and device-busy ms per iteration from torch.profiler
over 3 steps, and the largest difference of the final state between the
layouts against the state's max.  The card's name and power limit head
the output.

Run from the repository root:  python3 -m su2_tpu_torch.bench_gather
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time

import torch

# (nx, ny) of the channel grid split into triangles, iterations per run
SIZES = {"9072": ((189, 48), 50), "142317": ((753, 189), 20)}
PROFILED_STEPS = 3


def _bmv(blocks, vecs):
    return (blocks * vecs[..., None, :]).sum(-1)


def _stacked(jac):
    pad = torch.zeros((1,) + jac.off_ij.shape[1:], dtype=jac.off_ij.dtype,
                      device=jac.off_ij.device)
    return torch.cat([jac.off_ij, jac.off_ji, pad], dim=0)


def node_major(mesh):
    """(gather_offdiag, _offdiag_apply) of the node-major layout."""
    return (lambda m, jac: _stacked(jac)[mesh.node_edges_sel],
            lambda m, sel, x: _bmv(sel, x[mesh.node_nbrs]).sum(1))


def slot_major(mesh):
    """(gather_offdiag, _offdiag_apply) of the slot-major layout, its
    slot-major index vectors made once per mesh."""
    sel_t = mesh.node_edges_sel.T.reshape(-1)
    nbrs_t = mesh.node_nbrs.T.reshape(-1)
    n = mesh.npoint

    def apply(m, sel, x):
        prod = _bmv(sel, x[nbrs_t])
        out = prod[0:n]
        for d in range(1, mesh.max_degree):
            out = out + prod[d * n:(d + 1) * n]
        return out

    return (lambda m, jac: _stacked(jac)[sel_t]), apply


LAYOUTS = {"node-major": node_major, "slot-major": slot_major}


def make_sim(tmp, nx, ny):
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    return Simulation(Config(text=cases.write_case(tmp)),
                      raw_mesh=cases.tri_channel_mesh(nx, ny),
                      dtype=torch.float32, device="cuda")


def profiled(sim, state):
    """(CUDA launches, device-busy ms) per step over PROFILED_STEPS."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            state = sim._step(*state)[:6]
        torch.cuda.synchronize()
    launches, busy_us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
        elif "LaunchKernel" in e.name or "LaunchCooperativeKernel" in e.name:
            launches += 1
    return launches / PROFILED_STEPS, busy_us / 1e3 / PROFILED_STEPS


def run_layout(sim, name, niter):
    """One timed run of `name` from the case's initial state: (ms/iter,
    launches/iter, busy ms/iter, final u)."""
    from su2_tpu_torch.linalg import blockcsr
    gather, apply = LAYOUTS[name](sim.mesh)
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return apply(*args)

    saved = blockcsr.gather_offdiag, blockcsr._offdiag_apply
    blockcsr.gather_offdiag, blockcsr._offdiag_apply = gather, counted
    try:
        sim.run(2, quiet=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, t, hist, ts = sim.run(niter, quiet=True, chunk=25)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / niter
        if not (torch.isfinite(u).all() and torch.isfinite(
                torch.as_tensor(hist)).all()):
            raise AssertionError(f"{name}: non-finite state or residuals")
        if not calls[0]:
            raise AssertionError(f"{name}: the gather solve never ran")
        launches, busy = profiled(sim, (u, t) + tuple(ts))
    finally:
        blockcsr.gather_offdiag, blockcsr._offdiag_apply = saved
    return ms, launches, busy, u


def main():
    if not torch.cuda.is_available():
        print("bench_gather: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    order = ("node-major", "slot-major", "slot-major", "node-major")
    with tempfile.TemporaryDirectory(prefix=".bench_gather_") as tmp:
        for label, ((nx, ny), niter) in SIZES.items():
            sim = make_sim(tmp, nx, ny)
            finals = {}
            for name in order:
                ms, launches, busy, u = run_layout(sim, name, niter)
                finals[name] = u
                print(f"{label} nodes LU_SGS f32 x {niter} {name}: "
                      f"{ms:.3f} ms/iter, {launches:.1f} CUDA launches/iter,"
                      f" device busy {busy:.3f} ms/iter", flush=True)
            a, b = finals["node-major"], finals["slot-major"]
            print(f"{label} nodes: max|u(node) - u(slot)| / max|u| = "
                  f"{float((a - b).abs().max() / a.abs().max()):.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
