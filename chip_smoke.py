#!/usr/bin/env python3
"""Smoke run of su2_tpu_torch on one NVIDIA GPU: build, check, drive.

Phases (one line each; any failure exits nonzero):
  1 device   the card's name and power limit, CUDA and nvcc versions
  2 build    nvcc builds the four kernels from su2_tpu_torch/csrc
  3 kernels  T1-T4 against their plain torch versions on the card, at the
             9,072-node case's shapes, in float64 and float32, with times
  4 step     5 coupled iterations of the 9,072-node case in float64 on the
             card (kernels) and on the CPU (plain versions) from one state
  5 slice    Simulation.run: 9,072 nodes x 50 and 142,317 nodes x 20
             iterations in float32; finite residuals, kernel launch counts,
             ms/iter and Mcell-updates/s
The line before the last is the JSON kernel report; the last line is
{"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel name -> (source in the repo, TPU kernel it replaces)
KERNELS = {
    "mixture_enthalpy": ("su2_tpu_torch/csrc/thermo.cu",
                         "su2_tpu/pallas/thermo.py:66"),
    "node_state": ("su2_tpu_torch/csrc/node_state.cu",
                   "su2_tpu/pallas/node_state.py:183"),
    "edge_flux": ("su2_tpu_torch/csrc/edge_flux.cu",
                  "su2_tpu/pallas/edge_fused.py:161"),
    "chem_source": ("su2_tpu_torch/csrc/chem_source.cu",
                    "su2_tpu/pallas/chem_source.py:62"),
}
# tolerances per kernel and dtype: |kernel - plain| <= rtol * |plain|
# + atol_frac * max|plain| (T3: per flux row, atol only, the row's max)
TOL = {
    ("mixture_enthalpy", "float64"): (1e-12, 1e-12),
    ("mixture_enthalpy", "float32"): (1e-5, 1e-5),
    ("node_state", "float64"): (1e-10, 1e-12),
    ("node_state", "float32"): (2e-4, 1e-6),
    ("edge_flux", "float64"): (0.0, 1e-10),
    ("edge_flux", "float32"): (0.0, 1e-4),
    ("chem_source", "float64"): (1e-9, 1e-12),
    ("chem_source", "float32"): (5e-3, 2e-5),
}
SIZES = {"flagship": (189, 48), "scaling": (753, 189)}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_summary(log):
    """One line per compiled kernel: registers and stack bytes."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"su2k\d+(\w+?_kernel)I([fd])(?:Lb([01]))?",
                          line.split("'")[1])
            name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                    f"{', lite' if m.group(3) == '1' else ''}>")
        elif "Used" in line and "registers" in line and name:
            stack = line.split("used 0 barriers")[-1].strip(", ")
            regs = line.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers {stack}".strip())
            name = None
    return out


def cuda_time(fn, reps=20, warm=3):
    """Median milliseconds of fn() over reps launches (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(name, dt, got, want, per_row=False):
    """(max abs error, max error relative to its field's max|plain|) of
    got vs want within TOL; raises if outside."""
    import torch
    rtol, afrac = TOL[(name, dt)]
    worst = scaled = 0.0
    for g, w in zip(got, want):
        if w.dtype == torch.bool or g.dtype == torch.bool:
            if not torch.equal(g, w):
                raise AssertionError(f"{name} {dt}: nonphys flags differ")
            continue
        g = g.double()
        w = w.double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {dt}: non-finite kernel output")
        err = (g - w).abs()
        if per_row:
            scale = w.abs().flatten(1).amax(1).clamp(min=1e-300)
            bound = afrac * scale.reshape((-1,) + (1,) * (w.ndim - 1))
        else:
            bound = rtol * w.abs() + afrac * w.abs().max()
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"{name} {dt}: max err {err.max().item():.3e} outside "
                f"rtol {rtol} atol {afrac}*scale")
        worst = max(worst, err.max().item())
        scaled = max(scaled, err.max().item()
                     / max(w.abs().max().item(), 1e-300))
    return worst, scaled


def make_case(tmp, nx, ny, dtype, device):
    import torch
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    cfg = Config(text=cases.write_case(tmp))
    return Simulation(cfg, raw_mesh=channel_mesh(nx, ny), dtype=dtype,
                      device=device)


def kernel_inputs(sim, seed=0):
    """A mixed, reacting state at the case's shapes (numpy seed -> card):
    random T, P, velocity and composition, and random SST fields."""
    import numpy as np
    import torch
    from su2_tpu_torch import state as st
    from su2_tpu_torch.chemistry import library as cl
    lib, lay, n = sim.lib, sim.lay, sim.mesh.npoint
    rng = np.random.default_rng(seed)
    kw = dict(dtype=sim.dtype, device=sim.device)
    t = torch.as_tensor(rng.uniform(500.0, 2500.0, n)).to(**kw)
    p = torch.as_tensor(rng.uniform(0.9e5, 1.2e5, n)).to(**kw)
    vel = torch.as_tensor(rng.normal(0.0, 20.0, (n, lay.ndim))).to(**kw)
    ys = torch.as_tensor(rng.dirichlet(np.full(lay.ns, 0.5), n)).to(**kw)
    rho = p / (cl.mixture_rgas(lib, ys) * t)
    e = cl.mixture_enthalpy_plain(lib, t, ys) - cl.mixture_rgas(lib, ys) * t
    u = torch.cat([rho[:, None], rho[:, None] * vel,
                   (rho * (e + 0.5 * (vel * vel).sum(1)))[:, None],
                   rho[:, None] * ys], dim=1)
    u[7, lay.RHOS] = -1e-4 * rho[7]          # flagged: negative rho_s
    t_guess = t * torch.as_tensor(1.0 + 0.02 * rng.standard_normal(n)).to(**kw)
    tke = torch.as_tensor(rng.uniform(0.0, 5.0, n)).to(**kw)
    omt = torch.as_tensor(rng.uniform(1.0, 1e4, n)).to(**kw)
    mu_t = torch.as_tensor(rng.uniform(1e-5, 1e-3, n)).to(**kw)
    grad_tke = torch.as_tensor(rng.normal(0.0, 10.0, (n, lay.ndim))).to(**kw)
    sigma_k = torch.as_tensor(rng.uniform(0.85, 1.0, n)).to(**kw)
    return dict(u=u, t_guess=t_guess, tke=tke, omt=omt, mu_t=mu_t,
                grad_tke=grad_tke, sigma_k=sigma_k,
                p=st.TSolveParams(tmin=sim.tparams.tmin,
                                  tmax=sim.tparams.tmax))


def kernel_phase(tmp, dtype_name, report):
    import torch
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.chemistry import library as cl
    from su2_tpu_torch.ops import edge_flux as ef, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    dtype = getattr(torch, dtype_name)
    sim = make_case(tmp, *SIZES["flagship"], dtype, "cuda")
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    x = kernel_inputs(sim)
    p = x["p"]
    nsd = st.node_state_plain(lib, lay, x["u"], x["t_guess"], p, x["tke"])
    v = nsd.v
    tt, rho, ys = v[:, lay.T], v[:, lay.PRHO], v[:, lay.YS:lay.YS + lay.ns]
    nb = sim.bcs[-1].nodes.shape[0]     # a flux-BC marker's batch (T1)
    tb, yb = tt[:nb].contiguous(), ys[:nb].contiguous()
    grad = es.compute_gradients(mesh, prm,
                                vis.ns_gradient_vars(lib, lay, v, nsd.xs))
    turb = vis.TurbFlowData(tke=x["tke"], mu_t=x["mu_t"],
                            grad_tke=x["grad_tke"], sigma_k=x["sigma_k"])
    f_all = ef.stack_inputs(lay, v, grad, vis.Transport(nsd.mu, nsd.kappa),
                            turb, x["sigma_k"], nsd.dpdu[:, lay.RHOE])
    sc = ef.species_consts_of(lib)
    consts = (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb, prm.lewis_turb)
    eargs = (lib, lay, sc, consts, f_all, mesh.fam_offsets, mesh.fam_normal,
             mesh.fam_evec)
    calls = {
        "mixture_enthalpy": (
            lambda: [kernels.mixture_enthalpy(lib, tb, yb)],
            lambda: [cl.mixture_enthalpy_plain(lib, tb, yb)], False),
        "node_state": (
            lambda: list(kernels.node_state(lib, lay, p, x["u"],
                                            x["t_guess"], x["tke"]))
            + list(kernels.node_state(lib, lay, p, x["u"], x["t_guess"],
                                      x["tke"], lite=True)),
            lambda: list(vars(st.node_state_plain(
                lib, lay, x["u"], x["t_guess"], p, x["tke"])).values())
            + list(vars(st.node_state_lite_plain(
                lib, lay, x["u"], x["t_guess"], p, x["tke"])).values()),
            False),
        "edge_flux": (lambda: list(kernels.edge_flux(*eargs)),
                      lambda: list(ef.edge_flux_plain(*eargs)), True),
        "chem_source": (
            lambda: [kernels.chem_source(lib, prm, tt, rho, ys, x["omt"]),
                     kernels.chem_source(lib, prm, tt, rho, ys, None)],
            lambda: [es.chemistry_source_plain(lib, prm, tt, rho, ys,
                                               x["omt"]),
                     es.chemistry_source_plain(lib, prm, tt, rho, ys, None)],
            False),
    }
    for name, (kfn, pfn, per_row) in calls.items():
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        if name == "edge_flux":
            got = [got[0].flatten(0, 1), got[1], got[2]]
            want = [want[0].flatten(0, 1), want[1], want[2]]
        err, scaled = compare(name, dtype_name, got, want, per_row)
        ms = cuda_time(kfn)
        plain_ms = cuda_time(pfn)
        phase("kernels", f"{name} {dtype_name}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its field's max) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms")
        report.setdefault(name, {})[dtype_name] = (err, ms, plain_ms)
    # bisection path and its flags (secant budget 1, far-off guess)
    if dtype_name == "float64":
        pb = st.TSolveParams(secant_iters=1, secant_tol=1e-30)
        tg = torch.full_like(x["t_guess"], 4999.0)
        got = list(kernels.node_state(lib, lay, pb, x["u"], tg, x["tke"]))
        want = list(vars(st.node_state_plain(lib, lay, x["u"], tg, pb,
                                             x["tke"])).values())
        err, scaled = compare("node_state", dtype_name, got, want)
        phase("kernels", f"node_state float64 bisection path: max_abs_err "
              f"{err:.3e} ({scaled:.2e} of its field's max)")


def step_phase(tmp):
    """5 coupled iterations, card vs CPU, from the state after 10 card
    iterations of the flagship-class case."""
    import torch
    gpu = make_case(tmp, *SIZES["flagship"], torch.float64, "cuda")
    cpu = make_case(tmp, *SIZES["flagship"], torch.float64, "cpu")
    s_gpu = (gpu.u0, gpu.t0) + tuple(gpu.initial_turb_state())
    for _ in range(10):
        s_gpu = gpu._step(*s_gpu)[:6]
    s_cpu = tuple(x.cpu() for x in s_gpu)
    names = ("u", "t", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
             "turb_rms", "nonphys", "min_dt")
    worst = 0.0
    for it in range(5):
        og = gpu._step(*s_gpu)
        oc = cpu._step(*s_cpu)
        for nm, a, b in zip(names, og, oc):
            a = a.cpu().double()
            b = b.double()
            if not torch.isfinite(a).all():
                raise AssertionError(f"step {it}: non-finite {nm}")
            err = (a - b).abs()
            bound = 1e-9 * b.abs() + 1e-12 * b.abs().max()
            if not bool((err <= bound).all()):
                raise AssertionError(
                    f"step {it} {nm}: card vs CPU max err "
                    f"{err.max().item():.3e} outside rtol 1e-9, "
                    "atol 1e-12*max|field|")
            scale = b.abs().max().item()
            if scale > 0.0:
                worst = max(worst, err.max().item() / scale)
        s_gpu, s_cpu = tuple(og[:6]), tuple(oc[:6])
    phase("step", f"5 iterations at {gpu.mesh.npoint} nodes f64, card vs "
          f"CPU within rtol 1e-9, atol 1e-12*max|field| (largest "
          f"difference {worst:.3e} of its field's max)")


def slice_phase(tmp, size, niter, card):
    import numpy as np
    import torch
    from su2_tpu_torch import kernels
    sim = make_case(tmp, *SIZES[size], torch.float32, "cuda")
    n = sim.mesh.npoint
    # warm-up outside the counted, timed run
    u, t, _, ts = sim.run(2, quiet=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    u, t, hist, ts = sim.run(niter, u=u, t_guess=t, turb_state=ts,
                             quiet=True, chunk=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    if len(hist) != niter or not np.isfinite(hist).all() \
            or not torch.isfinite(u).all():
        raise AssertionError(f"{size}: non-finite residual history or state")
    want = {"node_state": 2 * niter, "edge_flux": niter,
            "chem_source": niter}
    for k, c in want.items():
        if counts[k] != c:
            raise AssertionError(f"{size}: {k} launched {counts[k]} times "
                                 f"in {niter} iterations, expected {c}")
    if counts["mixture_enthalpy"] < niter:
        raise AssertionError(f"{size}: mixture_enthalpy launched "
                             f"{counts['mixture_enthalpy']} < {niter}")
    # the mixing layer reacts: species production of the final state
    from su2_tpu_torch import state as st
    lay = sim.lay
    v = st.node_state(sim.lib, lay, u, t, sim.tparams, turb_ke=ts[0][:, 0]).v
    omega = kernels.chem_source(sim.lib, sim.params, v[:, lay.T],
                                v[:, lay.PRHO], v[:, lay.YS:],
                                ts[0][:, 1])
    om_max = omega.abs().max().item()
    if not om_max > 0.0:
        raise AssertionError(f"{size}: no species production")
    ms = wall * 1e3 / niter
    phase("slice", f"{n} nodes f32 x {niter}: {ms:.3f} ms/iter, "
          f"{n / (ms * 1e3):.3f} Mcell-updates/s, log10 rms[rho] "
          f"{hist[0][0]:.4f} -> {hist[-1][0]:.4f}, max|omega| "
          f"{om_max:.4g} kg/(m^3 s), launches {counts} ({card})")
    return counts


def main():
    sys.path.insert(0, HERE)
    try:
        import torch
        from su2_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run it from "
              "the repository root", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    phase("device", f"{card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {nvcc}")

    t0 = time.perf_counter()
    path, log = kernels.build(verbose=True)
    phase("build", f"{os.path.relpath(path, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(log):
        phase("build", line)

    report = {}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_") as tmp:
        for dt in ("float64", "float32"):
            kernel_phase(tmp, dt, report)
        step_phase(tmp)
        counts = slice_phase(tmp, "flagship", 50, card)
        slice_phase(tmp, "scaling", 20, card)

    rows = []
    for name, (src, repl) in KERNELS.items():
        err, ms, plain_ms = report[name]["float32"]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
