#!/usr/bin/env python3
"""Smoke run of su2_tpu_torch on one NVIDIA GPU: build, check, drive.

Phases (one line each; any failure exits nonzero):
  1 device   the card's name and power limit, CUDA and nvcc versions
  2 build    nvcc builds the kernels from su2_tpu_torch/csrc (one nvcc per
             source, all started together)
  3 kernels  T1-T4 against their plain torch versions on the card, at the
             9,072-node case's shapes, in float64 and float32, with times;
             K7 (WLS and GG, beside torch.sparse.mm of the same operator)
             and K8 (beside T3 + the roll-subtract) at the 565,500-node
             case's shapes, K9 on a batch the size of that case's inlet
             (377 vertices), in float64 and float32
  4 stencil  K5 (sweep + matvec, sweep only, matvec only) and K6 (one
             FGMRES(10) cycle) against their plain versions, in float64,
             float32 and mixed (bf16 sweep blocks), on the SST systems the
             port assembles at 9,072 and 142,317 nodes and on band systems
             with round-robin (not proper) colorings, with times
  5 step     5 coupled iterations of the 9,072-node case in float64 on the
             card (kernels, K6 for the SST solve) and on the CPU (plain
             versions) from one state; again with the >= 200k-node tier
             forced on both sides (K7 and K8 against their plain versions
             inside the step), and with a TOTAL_CONDITIONS inlet (K9); the
             implicit-flow case (EULER_IMPLICIT, MUSCL + Venkatakrishnan,
             JACOBI: K10 once per iteration) the same way, also with the
             tier forced (K7's rows feeding K10)
  6 slice    Simulation.run: 9,072 nodes x 50, 142,317 nodes x 20 and
             565,500 nodes x 10 (the tier: K7 twice and K8 once per
             iteration, T3 never; profiled once) in float32 with LU_SGS;
             finite residuals, kernel launch counts (K6 once per iteration
             at 9,072 nodes, K5 ten times per iteration at the larger
             sizes), ms/iter and Mcell-updates/s; 9,072 nodes x 10 with a
             TOTAL_CONDITIONS inlet (K9 once per iteration, profiled);
             142,317 nodes x 3 in float64 (K5 ten times per iteration);
             each size with LINEAR_SOLVER_PREC= JACOBI (the path that
             bypasses K5/K6) and with LU_SGS in the order J, L, each timed
             and then profiled over 3 iterations (torch.profiler: CUDA
             launches and device-busy ms per iteration, the launches per
             stage of the step, step_groups); the implicit-flow
             case at 9,072 x 20, 142,317 x 10 and 565,500 x 3 nodes in
             float32, timed and profiled (K10 and T2 twice per iteration,
             T3, K8, T4, K5 and K6 never)
  K10 phase  (between 4 and 5) K10 against its plain version at 9,072 nodes
             in float64 and float32 for the four (MUSCL, limiter) variants
             and at 142,317 and 565,500 nodes in float32 (the latter's
             stack from K7's gradient rows, as the tier's ns_assemble builds
             it), per output row, with times
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
    "stencil_sgs_matvec": ("su2_tpu_torch/csrc/stencil_solve.cu",
                           "su2_tpu/pallas/stencil_solve.py:178,206,251,273,"
                           "554,643,741"),
    "stencil_fgmres": ("su2_tpu_torch/csrc/stencil_solve.cu",
                       "su2_tpu/pallas/stencil_solve.py:381,434"),
    "gradient_rows": ("su2_tpu_torch/csrc/gradients_tiled.cu",
                      "su2_tpu/pallas/gradients_tiled.py:55"),
    "edge_win": ("su2_tpu_torch/csrc/edge_win.cu",
                 "su2_tpu/pallas/edge_fused.py:346"),
    "inlet_tc": ("su2_tpu_torch/csrc/inlet_tc.cu",
                 "su2_tpu/pallas/inlet_tc.py:74"),
    "edge_implicit": ("su2_tpu_torch/csrc/edge_implicit.cu",
                      "su2_tpu/pallas/edge_fused.py:721"),
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
    # K5: f64 at the JAX package's own sweep/matvec pin (tests/test_stencil
    # .py:166-167); f32 and mixed: f32 rounding, fused multiply-adds in the
    # kernel, none in the plain version
    ("stencil_sgs_matvec", "float64"): (1e-11, 1e-13),
    ("stencil_sgs_matvec", "float32"): (1e-5, 1e-6),
    ("stencil_sgs_matvec", "mixed"): (1e-5, 1e-6),
    # K7: f64 at the JAX package's tiled-sweep pin (tests/test_gradients_
    # tiled.py:49-50); f32 as K5 (fused multiply-adds in the kernel only)
    ("gradient_rows", "float64"): (1e-11, 1e-13),
    ("gradient_rows", "float32"): (1e-5, 1e-6),
    # K8: as T3, per residual row against the row's max
    ("edge_win", "float64"): (0.0, 1e-10),
    ("edge_win", "float32"): (0.0, 1e-4),
    # K9: as T1 (built without fused multiply-adds: the plain operations)
    ("inlet_tc", "float64"): (1e-12, 1e-12),
    ("inlet_tc", "float32"): (1e-5, 1e-5),
    # K10: as T3, per output row (flux, j_i, j_j rows of each family)
    # against the row's max
    ("edge_implicit", "float64"): (0.0, 1e-10),
    ("edge_implicit", "float32"): (0.0, 1e-4),
}
# the (MUSCL, limiter) variants of the implicit case (cases.with_implicit_
# flow); the main path is the first
IMPLICIT_VARIANTS = {"venkatakrishnan": (True, "VENKATAKRISHNAN"),
                     "muscl": (True, None), "first_order": (False, None),
                     "barth_jespersen": (True, "BARTH_JESPERSEN")}
# the 9,072-node flagship class, the 142,317-node scaling point and the
# 565,500-node size of the >= 200k-node tier (the README's round-5 point)
SIZES = {"flagship": (189, 48), "scaling": (753, 189), "tier": (1500, 377)}
TC_T_TOT = 600.0        # T_tot of cases.with_total_conditions
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): HBM bytes/s
# and non-tensor FLOP/s per type, for the bound of each kernel
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "mixed": 67e12}
KRYLOV_M = 10           # LINEAR_SOLVER_ITER of the case (the cfg default)
# iterations of the implicit-flow slice runs per size
IMPLICIT_NITERS = {"flagship": 20, "scaling": 10, "tier": 3}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def demangle(sym):
    """su2k::name<args> of a mangled kernel symbol (float, double, bf16,
    integer and bool template arguments)."""
    m = re.match(r"_ZN4su2k(\d+)", sym)
    if not m:
        return sym
    i = m.end() + int(m.group(1))
    name, args = sym[m.end():i], []
    if sym[i:i + 1] == "I":
        i += 1
        while i < len(sym) and sym[i] != "E":
            if sym[i] in "fd":
                args.append("float" if sym[i] == "f" else "double")
                i += 1
            elif sym[i] == "L":
                j = sym.index("E", i)
                lit = sym[i + 1:j]
                if lit[0] != "b":
                    args.append(lit[1:])
                elif name == "node_state_kernel":
                    args.append("lite" if lit == "b1" else "full")
                else:
                    args.append("true" if lit == "b1" else "false")
                i = j + 1
            else:
                d = re.match(r"\d+", sym[i:]).group(0)
                k = i + len(d)
                args.append(sym[k:k + int(d)].replace("__nv_bfloat16",
                                                      "bf16"))
                i = k + int(d)
    return f"{name}<{', '.join(args)}>"


def ptxas_summary(log):
    """One line per compiled kernel: registers and stack bytes."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = demangle(line.split("'")[1])
        elif "Used" in line and "registers" in line and name:
            regs, tail = line.split("Used")[1].split("registers", 1)
            out.append(f"{name}: {regs.strip()} registers, "
                       f"{tail.strip(', ')}")
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


def make_case(tmp, nx, ny, dtype, device, prec="LU_SGS",
              total_conditions=False, implicit=None):
    """The synthetic case on channel_mesh(nx, ny); implicit: (muscl,
    limiter) of the implicit-flow variant (JACOBI for both systems)."""
    from su2_tpu_torch import cases
    from su2_tpu_torch.config import Config
    from su2_tpu_torch.driver import Simulation
    from su2_tpu_torch.geometry.structured import channel_mesh
    text = cases.write_case(tmp).replace("LINEAR_SOLVER_PREC= LU_SGS",
                                         f"LINEAR_SOLVER_PREC= {prec}")
    if total_conditions:
        text = cases.with_total_conditions(text)
    if implicit is not None:
        text = cases.with_implicit_flow(text, *implicit)
    return Simulation(Config(text=text), raw_mesh=channel_mesh(nx, ny),
                      dtype=dtype, device=device)


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
    # inputs each call reads (the tables included), for the bytes bound
    node_tab = list(kernels._node_tables(lib))
    chem_tab = list(kernels._chem_tables(lib))
    inputs = {
        "mixture_enthalpy": [tb, yb, lib.h_y, lib.h_y2, lib.mm],
        "node_state": 2 * [x["u"], x["t_guess"], x["tke"]] + 2 * node_tab,
        "edge_flux": [f_all, mesh.fam_normal, mesh.fam_evec, lib.h_y,
                      lib.h_y2, lib.cp_y, lib.cp_y2, lib.mm, sc.sm_den],
        "chem_source": [tt, rho, ys, x["omt"], tt, rho, ys] + 2 * chem_tab,
    }
    # operations: conservative per-element counts read off the kernels'
    # sources (a lower bound, like the byte count)
    n, kh = mesh.npoint, len(mesh.fam_offsets)
    flops = {"mixture_enthalpy": 12 * lib.nspecies * nb,
             "node_state": 2 * 500 * n, "edge_flux": 2000 * kh * n,
             "chem_source": 2 * 600 * n}
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
        bound = bound_of(nbytes(inputs[name] + got), flops[name], dtype_name)
        phase("kernels", f"{name} {dtype_name}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its field's max) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound[0]:.4f} ms "
              f"({bound[1]})")
        report.setdefault(name, {})[dtype_name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None)
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


def grad_operator(mesh, mode, dtype):
    """The gradient sweep as one (d n, n) CSR matrix (WLS, or GG with its
    boundary and volume terms folded in): row dd*n + p of A q is
    d(q)/dx_dd at p.  The yardstick of torch.sparse.mm, never called by the
    port."""
    import torch
    n, d = mesh.npoint, mesh.ndim
    gg = mode == "GG"
    coef = (mesh.gg_snormal if gg else mesh.wls_coeff).to(dtype)
    p = torch.arange(n, device=coef.device)
    inv = None
    if gg:
        vol = mesh.volume.to(dtype)
        inv = 1.0 / torch.where(vol > 0.0, vol, torch.ones_like(vol))
    diag = torch.zeros((d, n), dtype=dtype, device=coef.device)
    rows, cols, vals = [], [], []
    for k, o in enumerate(mesh.stencil_offsets):
        off = 0.5 * coef[k].T * inv if gg else coef[k].T
        diag = diag + off if gg else diag - off
        for dd in range(d):
            rows.append(dd * n + p)
            cols.append((p + int(o)) % n)
            vals.append(off[dd])
    if gg:
        diag = diag - mesh.bnd_accum_normal.to(dtype).T * inv
    for dd in range(d):
        rows.append(dd * n + p)
        cols.append(p)
        vals.append(diag[dd])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(idx, torch.cat(vals), (d * n, n)
                                   ).coalesce().to_sparse_csr()


def tier_kernel_phase(sim, dtype_name, report):
    """K7 (WLS and GG), K8 and K9 against their plain versions at the
    shapes of the 565,500-node case (its mesh and library converted to the
    dtype) on a random reacting state; K9 on a random inflow batch of the
    size of the case's inlet."""
    from types import SimpleNamespace
    import dataclasses
    import numpy as np
    import torch
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.ops import edge_flux as ef, gradients_tiled as tg
    from su2_tpu_torch.ops import viscous as vis
    from su2_tpu_torch.solvers import euler as es, inlet_tc as itc
    dtype = getattr(torch, dtype_name)
    mesh, lib = sim.mesh.to(dtype=dtype), sim.lib.to(dtype=dtype)
    lay, prm = sim.lay, sim.params
    x = kernel_inputs(SimpleNamespace(lib=lib, lay=lay, mesh=mesh,
                                      dtype=dtype, device=sim.device,
                                      tparams=sim.tparams))
    nsd = st.node_state(lib, lay, x["u"], x["t_guess"], x["p"],
                        turb_ke=x["tke"])
    q = vis.ns_gradient_vars(lib, lay, nsd.v, nsd.xs).contiguous()
    n, d, ng = mesh.npoint, mesh.ndim, q.shape[1]
    kk = len(mesh.stencil_offsets)

    def record(name, key, got, want, kfn, pfn, ins, nflop, per_row=False,
               lib_ms=None, extra=""):
        err, scaled = compare(name, dtype_name, got, want, per_row)
        ms, plain_ms = cuda_time(kfn), cuda_time(pfn)
        bound = bound_of(nbytes(ins + got), nflop, dtype_name)
        lib_txt = "" if lib_ms is None else f" library {lib_ms:.4f} ms"
        phase("kernels", f"{name} {key}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its field's max) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {bound[0]:.4f} ms ({bound[1]})"
              f"{lib_txt}{extra}")
        report.setdefault(name, {})[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=lib_ms)

    # K7: the flow gradient set's rows, both methods
    for mode in ("WLS", "GG"):
        gg = mode == "GG"
        kfn = lambda: [tg.gradient_rows(mesh, q, mode)]
        pfn = lambda: [tg.gradient_rows_plain(mesh, q, mode)]
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        op = grad_operator(mesh, mode, dtype)
        lib_ms = cuda_time(lambda: torch.sparse.mm(op, q))
        ref = torch.sparse.mm(op, q).reshape(d, n, ng).permute(2, 0, 1)
        dev = ((ref.reshape(ng * d, n) - want[0]).abs().max()
               / want[0].abs().max()).item()
        if dtype == torch.float64 and not dev < 1e-9:
            raise AssertionError(f"K7 {mode}: the sparse operator is off by "
                                 f"{dev:.2e} of the max")
        ins = [q, mesh.gg_snormal if gg else mesh.wls_coeff] + (
            [mesh.bnd_accum_normal, mesh.volume] if gg else [])
        record("gradient_rows", f"{dtype_name} {mode}", got, want, kfn, pfn,
               ins, 3 * kk * d * ng * n + (3 * d * ng * n if gg else 0),
               lib_ms=lib_ms, extra=f" (torch.sparse.mm CSR, off by "
               f"{dev:.1e} of the max)")
    # K8: the stack of the tier's main path, from K7's rows
    rows = es.compute_gradient_rows(mesh, prm, q)
    turb = vis.TurbFlowData(tke=x["tke"], mu_t=x["mu_t"],
                            grad_tke=x["grad_tke"], sigma_k=x["sigma_k"])
    f_all = ef.stack_inputs(lay, nsd.v, None, vis.Transport(nsd.mu,
                                                            nsd.kappa),
                            turb, x["sigma_k"], nsd.dpdu[:, lay.RHOE],
                            grad_rows=rows)
    sc = ef.species_consts_of(lib)
    eargs = (lib, lay, sc, (prm.m_infty, prm.prandtl_lam, prm.prandtl_turb,
                            prm.lewis_turb), f_all, mesh.fam_offsets,
             mesh.fam_normal, mesh.fam_evec)
    rowwise = lambda r: [r[0], r[1][None], r[2][None]]
    kfn = lambda: rowwise(kernels.edge_win(*eargs))
    pfn = lambda: rowwise(ef.edge_win_plain(*eargs))
    got, want = kfn(), pfn()
    torch.cuda.synchronize()
    kh = len(mesh.fam_offsets)
    # K8 evaluates every edge twice; T3 once, then the roll-subtract sums
    t3_ms = cuda_time(lambda: ef.roll_subtract(
        mesh.fam_offsets, *kernels.edge_flux(*eargs)))
    record("edge_win", dtype_name, got, want, kfn, pfn,
           [f_all, mesh.fam_normal, mesh.fam_evec, lib.h_y, lib.h_y2,
            lib.cp_y, lib.cp_y2, lib.mm, sc.sm_den], 2000 * kh * n,
           per_row=True,
           extra=f" (T3 + roll-subtract at these shapes {t3_ms:.4f} ms)")
    # K9: a random inflow batch about the 600 K fuel stream (the
    # distribution of tests/test_torch_inlet_tc.py), inlet-sized
    nv = int(mesh.markers["inlet"][0].shape[0])
    rng = np.random.default_rng(4)
    gamma = rng.uniform(1.06, 1.2, nv)
    a = np.sqrt(gamma * float(lib.ri[0]) * rng.uniform(450.0, 650.0, nv))
    rm = rng.uniform(-40.0, 0.0, nv) + 2.0 * a / (gamma - 1.0)
    rm[: nv // 4] *= rng.uniform(0.5, 1.5, nv // 4)
    al = rng.uniform(-1.0, -0.8, nv)
    tcx = [torch.as_tensor(v).to(sim.device, dtype) for v in (rm, gamma, al)]
    tc = itc.total_conditions_t(lib, np.eye(lib.nspecies)[0], TC_T_TOT)
    for sec in ((15, 1) if dtype == torch.float64 else (15,)):
        tcs = dataclasses.replace(tc, sec_iters=sec)
        kfn = lambda: [itc.solve(tcs, *tcx)]
        pfn = lambda: [itc.solve_plain(tcs, *tcx)]
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        # operations: a lower bound of two spline evaluations (~30
        # operations each) per vertex; the iterations depend on the data
        record("inlet_tc", dtype_name if sec == 15
               else f"{dtype_name} bisection path", got, want, kfn, pfn,
               tcx + [tc.y, tc.y2], 60 * nv,
               extra=f" ({nv} vertices, secant budget {sec})")


def k10_rows_read(lay, muscl, limiter):
    """Rows of the implicit stack (edge_implicit.implicit_rows) that K10
    reads in the variant: with MUSCL not the dP/dU rows (the face state
    recomputes dP/dU), without the limiter not its rows, and at first
    order not the pressure gradient (only the reconstruction reads it)."""
    from su2_tpu_torch.ops import edge_implicit as ei
    r, nd = ei.implicit_rows(lay), lay.ndim
    rows = r["total"]
    if muscl:
        rows -= lay.nvar
    else:
        rows -= nd
    if not limiter:
        rows -= 2 + nd
    return rows


def implicit_kernel_phase(sim, dtype_name, report, variants):
    """K10 against its plain version at the shapes of the implicit case sim
    (its mesh and library converted to the dtype) on a random reacting
    state: per output row of every family, the pad slots exactly 0.  In
    the >= 200k-node tier the stack's gradients are K7's rows, as
    ns_assemble builds it."""
    from types import SimpleNamespace
    import torch
    from su2_tpu_torch import kernels, state as st
    from su2_tpu_torch.ops import edge_flux as ef, edge_implicit as ei
    from su2_tpu_torch.ops import gradients, limiters, viscous as vis
    from su2_tpu_torch.solvers import euler as es
    dtype = getattr(torch, dtype_name)
    mesh, lib = sim.mesh.to(dtype=dtype), sim.lib.to(dtype=dtype)
    lay, prm = sim.lay, sim.params
    x = kernel_inputs(SimpleNamespace(lib=lib, lay=lay, mesh=mesh,
                                      dtype=dtype, device=sim.device,
                                      tparams=sim.tparams))
    nsd = st.node_state(lib, lay, x["u"], x["t_guess"], x["p"],
                        turb_ke=x["tke"])
    v = nsd.v
    nd = lay.ndim
    qg = vis.ns_gradient_vars(lib, lay, v, nsd.xs)
    grad = grad_rows = None
    if gradients.use_tiled(mesh):
        grad_rows = es.compute_gradient_rows(mesh, prm, qg)
        g = gradients.rows_to_grad(grad_rows[:(2 + nd) * nd], 2 + nd, nd)
    else:
        grad = es.compute_gradients(mesh, prm, qg)
        g = grad[:, :2 + nd]
    q = es.gradient_vars(lay, v)
    lims = {"VENKATAKRISHNAN": limiters.venkatakrishnan(
        mesh, q, g, prm.limiter_coeff, prm.ref_elem_length),
        "BARTH_JESPERSEN": limiters.barth_jespersen(mesh, q, g)}
    turb = vis.TurbFlowData(tke=x["tke"], mu_t=x["mu_t"],
                            grad_tke=x["grad_tke"], sigma_k=x["sigma_k"])
    trans = vis.Transport(nsd.mu, nsd.kappa)
    sc = ef.species_consts_of(lib)
    n, kh = mesh.npoint, len(mesh.fam_offsets)
    nvar, ns = lay.nvar, lay.ns
    pad = (mesh.fam_normal == 0).all(-1)                  # (Kh, N)
    # operations per slot, a lower bound read off the kernel: about 8 per
    # entry of the two Jacobian blocks, the Stefan-Maxwell Gauss-Jordan,
    # and the dJ/dr species blocks (about 8 per entry, for the species
    # rows and for the density and energy rows of both sides)
    flops = kh * n * (16 * nvar * nvar + 2 * ns * ns * (ns + 1)
                      + 64 * ns * ns)
    for name in variants:
        muscl, limiter = IMPLICIT_VARIANTS[name]
        f_all = ei.stack_inputs(lay, v, grad, lims.get(limiter), trans,
                                turb, x["sigma_k"], nsd.dtdu, nsd.dpdu,
                                grad_rows=grad_rows)
        args = (lib, lay, sc, (prm.m_infty, prm.prandtl_turb,
                               prm.lewis_turb), f_all, mesh.fam_offsets,
                mesh.fam_normal, mesh.fam_evec, muscl, limiter is not None)
        rows = lambda out: [t.flatten(0, 1) for t in out]
        kfn = lambda: rows(kernels.edge_implicit(*args))
        pfn = lambda: rows(ei.edge_implicit_plain(*args))
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        err, scaled = compare("edge_implicit", dtype_name, got, want,
                              per_row=True)
        for t in got:
            if not bool((t.reshape(kh, -1, n).permute(1, 0, 2)[:, pad]
                         == 0).all()):
                raise AssertionError(f"K10 {name} {dtype_name}: nonzero "
                                     "output on a pad slot")
        ms, plain_ms = cuda_time(kfn), cuda_time(pfn)
        # the stack's bytes: only the rows this variant reads
        ins = [mesh.fam_normal, mesh.fam_evec, lib.h_y, lib.h_y2,
               lib.cp_y, lib.cp_y2, lib.mm, sc.sm_den, lib.ri]
        stack = k10_rows_read(lay, muscl, limiter) * n * f_all.element_size()
        bound = bound_of(stack + nbytes(ins + got), flops, dtype_name)
        key = f"{dtype_name} {n} {name}"
        phase("k10", f"edge_implicit {key}: max_abs_err {err:.3e} "
              f"({scaled:.2e} of its row's max) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {bound[0]:.4f} ms ({bound[1]}); "
              f"one launch for {kh} families, pad slots exactly 0"
              + ("; the stack's gradients from K7's rows" if grad is None
                 else ""))
        report.setdefault("edge_implicit", {})[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_of(nbyte, nflop, variant):
    """(least ms the card could take, what sets it): the bytes that must
    move over the HBM rate against the operations over the type's peak."""
    t_bytes = nbyte / HBM_BPS * 1e3
    t_ops = nflop / PEAK_FLOPS[variant] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_sst_system(sim, steps=3):
    """The SST solve's operands (diag, sel_t, colors, rhs) of the
    port's own assembly, recorded around its solver calls during the
    steps-th coupled step from the freestream state."""
    from su2_tpu_torch.linalg import blockcsr, krylov
    rec = {}
    make_ops, fgmres = blockcsr.make_solver_ops_stencil_t, krylov.fgmres

    def rec_ops(mesh, diag, sel_t, kind, colors=None, ncolor=0,
                linear_iter=5):
        rec.update(diag=diag, sel_t=sel_t, colors=colors, ncolor=ncolor)
        mv, pc, pm, solve = make_ops(mesh, diag, sel_t, kind, colors, ncolor,
                                     linear_iter)
        if solve is None:
            return mv, pc, pm, None

        def rec_solve(b, m, tol):
            rec["rhs"] = b
            return solve(b, m, tol)
        return mv, pc, pm, rec_solve

    def rec_fgmres(matvec, precond, b, **kw):
        rec["rhs"] = b
        return fgmres(matvec, precond, b, **kw)

    state = (sim.u0, sim.t0) + tuple(sim.initial_turb_state())
    for _ in range(steps - 1):
        state = sim._step(*state)[:6]
    blockcsr.make_solver_ops_stencil_t = rec_ops
    krylov.fgmres = rec_fgmres
    try:
        sim._step(*state)
    finally:
        blockcsr.make_solver_ops_stencil_t, krylov.fgmres = make_ops, fgmres
    return rec


def sst_operands(sim, rec, variant):
    """K5/K6 operands of a captured SST system, laid out by the port's own
    StencilSolveOps: (kwargs, unit right side, right side)."""
    import torch
    from su2_tpu_torch.linalg import blockcsr, stencil_solve as ts
    dtype = torch.float64 if variant == "float64" else torch.float32
    diag, sel_t = rec["diag"].to(dtype), rec["sel_t"].to(dtype)
    ops = ts.StencilSolveOps(
        sim.mesh, sel_t, blockcsr.block_diag_inv(diag), diag, rec["colors"],
        rec["ncolor"], sel_dtype=torch.bfloat16 if variant == "mixed"
        else None)
    b = rec["rhs"].to(dtype).contiguous()
    args = dict(selp_t=ops.sel_t, selm_t=ops.selm_t, dinv_t=ops.dinv_t,
                diag_t=ops.diag_t, colors=ops.colors, offsets=ops.offsets,
                ncolor=ops.ncolor)
    return args, (b / torch.linalg.vector_norm(b)).contiguous(), b


def band_operands(v, offsets, variant, n=20000, ncolor=4, seed=11):
    """A random band block system with dense v x v blocks, zero blocks for
    out-of-range neighbours and round-robin colors, which are not a proper
    coloring for these offsets: the two-buffer rule decides the numbers."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dtype = torch.float64 if variant == "float64" else torch.float32
    k = len(offsets)
    sel = rng.standard_normal((k, v, v, n)) * 0.1
    p = np.arange(n)
    for kk, o in enumerate(offsets):
        sel[kk, :, :, (p + o < 0) | (p + o >= n)] = 0.0
    diag = rng.standard_normal((n, v, v)) * 0.1 + 3.0 * np.eye(v)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(
        "cuda", dtype)
    lanes = lambda blk: dev(blk.transpose(1, 2, 0).reshape(v * v, n))
    sel_t = dev(sel.reshape(k * v * v, n))
    colors = torch.as_tensor((p % ncolor).astype(np.int8)).to("cuda")
    b = dev(rng.standard_normal((n, v)))
    args = dict(selp_t=sel_t.to(torch.bfloat16) if variant == "mixed"
                else sel_t, selm_t=sel_t,
                dinv_t=lanes(np.linalg.inv(diag)), diag_t=lanes(diag),
                colors=colors, offsets=tuple(offsets),
                ncolor=ncolor)
    return args, (b / torch.linalg.vector_norm(b)).contiguous(), b


def bsr_operator(args, n, v):
    """The matvec operator D + sum_k B_k shift_k as one (n v, n v) block
    sparse matrix with v x v blocks: the yardstick of torch.sparse.mm,
    never called by the port."""
    import torch
    offs = [0] + list(args["offsets"])
    blocks = [args["diag_t"]] + list(args["selm_t"].reshape(
        len(args["offsets"]), v * v, n).unbind(0))
    p = torch.arange(n, device="cuda")
    order = sorted(range(len(offs)), key=lambda i: offs[i])
    cols = torch.stack([p + offs[i] for i in order], 1)         # (n, K+1)
    vals = torch.stack([blocks[i].T.reshape(n, v, v) for i in order], 1)
    ok = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = ok.sum(1).cumsum(0)
    return torch.sparse_bsr_tensor(crow, cols[ok], vals[ok].contiguous(),
                                   size=(n * v, n * v))


def k5_flops(args, n, v, sweep, matvec):
    """Multiply-adds of one K5 application as 2 operations each: a sweep
    pass updates its color's nodes (K v x v off-diagonal products, the
    subtraction and the dinv product; the first pass only dinv), the
    matvec every node."""
    k, nc = len(args["offsets"]), args["ncolor"]
    flops = 0
    if sweep:
        cnt = [int((args["colors"] == c).sum()) for c in range(nc)]
        order = list(range(nc)) + list(range(nc - 2, -1, -1))
        flops += 2 * v * v * cnt[order[0]]
        flops += sum(cnt[c] for c in order[1:]) * (2 * k * v * v + v
                                                   + 2 * v * v)
    if matvec:
        flops += n * (2 * k * v * v + 2 * v * v + v)
    return flops


def k6_flops(args, n, v, m):
    """One FGMRES(m) cycle: m sweeps and matvecs, the j + 1 Gram-Schmidt
    dots and updates and the norm of iteration j, the basis vector, and
    x = sum_j y_j z_j."""
    nv = n * v
    per = k5_flops(args, n, v, True, True)
    return m * per + sum(4 * nv * (j + 1) + 3 * nv for j in range(m)) \
        + 2 * m * nv


def k6_barriers(ncolor, m):
    """Grid-wide barriers of one K6 cycle (csrc/stencil_solve.cu)."""
    return 2 + m * (2 * ncolor + 1) + m * (m - 1) // 2


def stencil_phase(sims, report):
    """K5 and K6 against their plain versions: the SST systems the port
    assembles at both sizes and band systems with dense blocks, in f64,
    f32 and mixed."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    systems = {}
    for size, sim in sims.items():
        rec = capture_sst_system(sim)
        systems[f"sst{sim.mesh.npoint}"] = (
            lambda var, sim=sim, rec=rec: sst_operands(sim, rec, var))
    systems["band2"] = lambda var: band_operands(
        2, (-9, -8, -7, -1, 1, 7, 8, 9), var)
    systems["band3"] = lambda var: band_operands(3, (-5, -1, 1, 5), var)
    for sname, make in systems.items():
        for var in ("float64", "float32", "mixed"):
            args, r, b = make(var)
            n, v = r.shape
            rtol, afrac = TOL[("stencil_sgs_matvec", var)]
            for mode in ("sgs_matvec", "sgs", "matvec"):
                sweep, matvec = mode != "matvec", mode != "sgs"
                if mode == "matvec" and var == "mixed":
                    continue          # the matvec never reads bf16 blocks
                kfn = lambda: [t for t in kernels.stencil_sgs_matvec(
                    **args, r=r, sweep=sweep, matvec=matvec)
                    if t is not None and (sweep or t is not r)]
                pfn = lambda: [t for t in ts.sgs_matvec_plain(
                    **args, r=r, sweep=sweep, matvec=matvec)
                    if t is not None and (sweep or t is not r)]
                got, want = kfn(), pfn()
                torch.cuda.synchronize()
                err, worst = 0.0, 0.0
                for g, w in zip(got, want):
                    g, w = g.double(), w.double()
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"K5 {sname} {var} {mode}: "
                                             "non-finite output")
                    e = (g - w).abs()
                    if not bool((e <= rtol * w.abs()
                                 + afrac * w.abs().max()).all()):
                        raise AssertionError(
                            f"K5 {sname} {var} {mode}: max err "
                            f"{e.max().item():.3e} outside rtol {rtol} atol "
                            f"{afrac}*max")
                    err = max(err, e.max().item())
                    worst = max(worst, e.max().item()
                                / max(w.abs().max().item(), 1e-300))
                ms, plain_ms = cuda_time(kfn), cuda_time(pfn)
                ins = [r]
                if sweep:
                    ins += [args["selp_t"], args["dinv_t"], args["colors"]]
                if matvec:
                    ins.append(args["diag_t"])
                    if not sweep or args["selm_t"] is not args["selp_t"]:
                        ins.append(args["selm_t"])
                bound = bound_of(nbytes(ins + got),
                                 k5_flops(args, n, v, sweep, matvec), var)
                lib_ms, lib_txt = None, ""
                if mode == "matvec":
                    mat = bsr_operator(args, n, v)
                    xv = r.reshape(n * v, 1)
                    lib_ms = cuda_time(lambda: torch.sparse.mm(mat, xv))
                    lib_txt = f" torch.sparse.mm (BSR) {lib_ms:.4f} ms"
                phase("stencil", f"K5 {mode} {sname} {var}: max_abs_err "
                      f"{err:.3e} ({worst:.2e} of its field's max) kernel "
                      f"{ms:.4f} ms plain {plain_ms:.4f} ms bound "
                      f"{bound[0]:.4f} ms ({bound[1]}){lib_txt}")
                report.setdefault("stencil_sgs_matvec", {})[
                    (sname, var, mode)] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound[0], bound_by=bound[1],
                        library_ms=lib_ms)
            k6_check(sname, var, args, r, b, report)


def k6_check(sname, var, args, r, b, report):
    """K6 against the plain FGMRES(10) over the plain sweep: equal
    iterations; f64 x within rtol 1e-9 and atol 1e-12 of max|x|, rel
    within rtol 1e-8 (atol 1e-15); f32 and mixed x within 2e-5 of max|x|
    (the JAX package's pins, tests/test_stencil.py:259-262, 315-317).
    Cases: tol 1e-6, tol 1e-12 (all iterations in f32), the unit right
    side r times 1e18 (the pow2 scaling; b itself may reach 1e21 in f32)
    and, in f64, b = 0 (in f32 the reference's 1e-300 floor rounds to 0
    and its cycle divides 0 by 0)."""
    import torch
    from su2_tpu_torch import kernels
    from su2_tpu_torch.linalg import stencil_solve as ts
    n, v = b.shape
    cases = [("tol 1e-6", b, 1e-6), ("tol 1e-12", b, 1e-12),
             ("r x 1e18", r * 1e18, 1e-6)]
    if var == "float64":
        cases.append(("b = 0", torch.zeros_like(b), 1e-6))
    err = err_abs = 0.0
    iters = []
    for label, bb, tol in cases:
        x, rel, it = kernels.stencil_fgmres(**args, b=bb, m=KRYLOV_M,
                                            tol=tol)
        px, prel, pit = ts.fgmres_plain(**args, b=bb, m=KRYLOV_M, tol=tol)
        torch.cuda.synchronize()
        if int(it) != int(pit):
            raise AssertionError(f"K6 {sname} {var} {label}: {int(it)} "
                                 f"iterations, plain {int(pit)}")
        x, px = x.double(), px.double()
        if not torch.isfinite(x).all():
            raise AssertionError(f"K6 {sname} {var} {label}: non-finite x")
        scale = max(px.abs().max().item(), 1e-300)
        e = (x - px).abs()
        if var == "float64":
            # rel: atol 1e-15, since at tol 1e-12 it ends at rounding
            # level, where the summation orders of the dots show
            ok = bool((e <= 1e-9 * px.abs() + 1e-12 * scale).all()) and \
                abs(float(rel) - float(prel)) <= 1e-8 * abs(float(prel)) \
                + 1e-15
        else:
            ok = e.max().item() <= 2e-5 * scale
        if not ok:
            raise AssertionError(
                f"K6 {sname} {var} {label}: max err {e.max().item():.3e} "
                f"(x scale {scale:.3e}), rel {float(rel):.6e} vs plain "
                f"{float(prel):.6e}")
        err = max(err, e.max().item() / scale)
        if label == "tol 1e-6":
            err_abs = e.max().item()
        iters.append(int(it))
    kfn = lambda: kernels.stencil_fgmres(**args, b=b, m=KRYLOV_M, tol=1e-6)
    pfn = lambda: ts.fgmres_plain(**args, b=b, m=KRYLOV_M, tol=1e-6)
    ms, plain_ms = cuda_time(kfn, reps=10), cuda_time(pfn, reps=5)
    ins = [args["selp_t"], args["dinv_t"], args["diag_t"], args["colors"], b,
           None if args["selm_t"] is args["selp_t"] else args["selm_t"]]
    outs = nbytes([b]) + 2 * b.element_size()          # x and the stats
    bound = bound_of(nbytes(ins) + outs, k6_flops(args, n, v, KRYLOV_M), var)
    phase("stencil", f"K6 {sname} {var}: iterations {iters} equal to the "
          f"plain version's, max error {err:.2e} of max|x|; kernel {ms:.4f} "
          f"ms plain {plain_ms:.4f} ms bound {bound[0]:.4f} ms ({bound[1]});"
          f" {k6_barriers(args['ncolor'], KRYLOV_M)} grid barriers")
    report.setdefault("stencil_fgmres", {})[(sname, var)] = dict(
        max_abs_err=err_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], library_ms=None,
        barriers=k6_barriers(args["ncolor"], KRYLOV_M))


def step_phase(tmp, tier=False, total_conditions=False, implicit=None):
    """5 coupled iterations, card vs CPU, from the state after 10 card
    iterations of the flagship-class case; tier=True forces the
    >= 200k-node tier on both sides (TILED_MIN_NODES = 0: K7 and K8, or
    K7 feeding K10, on the card), total_conditions a TOTAL_CONDITIONS
    inlet (K9), implicit the implicit-flow variant (muscl, limiter) (K10
    once per iteration)."""
    from su2_tpu_torch.ops import gradients
    saved = gradients.TILED_MIN_NODES
    if tier:
        gradients.TILED_MIN_NODES = 0
    try:
        worst, counts, n = _step_compare(tmp, total_conditions, implicit)
    finally:
        gradients.TILED_MIN_NODES = saved
    imp = implicit is not None
    want = {"edge_win": 5 * (tier and not imp),
            "edge_flux": 5 * (not tier and not imp),
            "edge_implicit": 5 * imp, "chem_source": 5 * (not imp),
            "gradient_rows": 10 * tier, "inlet_tc": 5 * total_conditions}
    if imp:
        want.update(stencil_fgmres=0, stencil_sgs_matvec=0)
    for k, c in want.items():
        if counts[k] != c:
            raise AssertionError(f"step: {k} launched {counts[k]} times in "
                                 f"the 5 compared card iterations, "
                                 f"expected {c}")
    what = ("the >= 200k-node tier forced (K7, K8)" if tier and not imp else
            "a TOTAL_CONDITIONS inlet (K9)" if total_conditions else
            "the main path")
    if imp:
        what = ("the implicit flow (K10) with the >= 200k-node tier forced "
                "(K7 rows into K10)" if tier else "the implicit flow (K10)")
    phase("step", f"5 iterations at {n} nodes f64 with {what}, card vs CPU "
          f"within rtol 1e-9, atol 1e-12*max|field| (largest difference "
          f"{worst:.3e} of its field's max); card launches {counts}")


def _step_compare(tmp, total_conditions, implicit=None):
    import torch
    from su2_tpu_torch import kernels
    gpu = make_case(tmp, *SIZES["flagship"], torch.float64, "cuda",
                    total_conditions=total_conditions, implicit=implicit)
    cpu = make_case(tmp, *SIZES["flagship"], torch.float64, "cpu",
                    total_conditions=total_conditions, implicit=implicit)
    s_gpu = (gpu.u0, gpu.t0) + tuple(gpu.initial_turb_state())
    for _ in range(10):
        s_gpu = gpu._step(*s_gpu)[:6]
    s_cpu = tuple(x.cpu() for x in s_gpu)
    names = ("u", "t", "q", "mu_t", "grad_k", "sigma_k", "rms", "rmax",
             "turb_rms", "nonphys", "min_dt")
    worst = 0.0
    kernels.reset_launches()
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
    return worst, dict(kernels.launches), gpu.mesh.npoint


# the stencil kernel of each size's SST solve and its launches per
# iteration: one K6 cycle at 9,072 nodes, KRYLOV_M K5 (z, A z) at 142,317
# and 565,500 (the mixed tier)
STENCIL_PER_ITER = {"flagship": ("stencil_fgmres", 1),
                    "scaling": ("stencil_sgs_matvec", KRYLOV_M),
                    "tier": ("stencil_sgs_matvec", KRYLOV_M)}


def step_groups():
    """(module, function name, group) of the step's stages whose CUDA
    launches profile_steps counts apart; each call of one is wrapped in a
    torch.profiler range named by its group while the profile runs."""
    from su2_tpu_torch import state as st
    from su2_tpu_torch.linalg import blockcsr, krylov
    from su2_tpu_torch.ops import (ausm_t, edge_flux, edge_implicit,
                                   limiters, viscous_t)
    from su2_tpu_torch.solvers import euler as es, ns
    from su2_tpu_torch.turbulence import sst
    return [(st, "node_state", "node state"),
            (st, "node_state_lite", "node state"),
            (ns, "viscous_lambda", "viscous spectral radius"),
            (ns, "ns_assemble", "flow assembly"),
            (es, "compute_gradients", "gradients"),
            (es, "compute_gradient_rows", "gradients"),
            (limiters, "venkatakrishnan", "limiter"),
            (limiters, "barth_jespersen", "limiter"),
            (edge_implicit, "fused_implicit_family_terms", "edge terms"),
            (edge_flux, "fused_interior_terms", "edge terms"),
            (es, "flux_bc_batch", "flux-BC ghost states"),
            (es, "ghost_dpdu", "boundary flux and Jacobians"),
            (ausm_t, "ausm_flux_t", "boundary flux and Jacobians"),
            (viscous_t, "viscous_flux_t", "boundary flux and Jacobians"),
            (es, "chemistry_source_system", "chemistry source"),
            (es, "chemistry_source_residual", "chemistry source"),
            (blockcsr, "block_diag_inv", "block inverse"),
            (krylov, "fgmres", "FGMRES"),
            (sst, "sst_step", "SST solve")]


def launches_by_group(events, groups):
    """{nested group path: launches} from profiler events: each launch
    goes to the chain of group ranges that enclose it on the host (outer
    first, "/"-joined, a group called from itself named once; "other"
    outside every range).  The ranges' device-side copies are not
    used."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.name in groups and e.device_type == cpu)
    counts = {}
    for e in events:
        if "LaunchKernel" not in e.name \
                and "LaunchCooperativeKernel" not in e.name:
            continue
        t = e.time_range.start
        path = []
        for a, b, name in spans:
            if a <= t <= b and (not path or path[-1] != name):
                path.append(name)
        key = "/".join(path) if path else "other"
        counts[key] = counts.get(key, 0) + 1
    return counts


def profile_steps(sim, state, niter=3):
    """(CUDA kernel launches, device-busy ms, {su2k kernel: device ms},
    {other device op: device ms} of the three largest, {stage path:
    launches}) per iteration over niter coupled steps, from
    torch.profiler: launches are the runtime's launch calls, busy the
    summed device time of kernels, copies and sets; the stages are those
    of step_groups."""
    import functools
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, name):
        @functools.wraps(fn)
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    groups = step_groups()
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in groups]
    torch.cuda.synchronize()
    try:
        for mod, attr, name in groups:
            setattr(mod, attr, ranged(getattr(mod, attr), name))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(niter):
                state = sim._step(*state)[:6]
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    events = prof.events()
    names = {g for _, _, g in groups}
    by_group = launches_by_group(events, names)
    launches, busy_us, ours, other = 0, 0.0, {}, {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name in names:
                continue        # a range's device-side copy, not work
            us = e.time_range.elapsed_us()
            busy_us += us
            m = re.search(r"su2k::(\w+)_kernel", e.name)
            if m:
                ours[m.group(1)] = ours.get(m.group(1), 0.0) + us
            else:
                key = e.name[:60]
                other[key] = other.get(key, 0.0) + us
        elif "LaunchKernel" in e.name or "LaunchCooperativeKernel" in e.name:
            launches += 1
    top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
    return (launches / niter, busy_us / 1e3 / niter,
            {k: round(us / 1e3 / niter, 4) for k, us in sorted(ours.items())},
            {k: round(us / 1e3 / niter, 4) for k, us in top},
            {k: c / niter for k, c in sorted(by_group.items(),
                                             key=lambda kv: -kv[1])})


def slice_phase(sim, size, niter, card, prec="LU_SGS", profile=False):
    import numpy as np
    import torch
    from su2_tpu_torch import kernels
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
    # the tier runs K8 instead of T3 and sweeps its gradients with K7: the
    # flow sweep, plus the turbulence sweep (one merged sweep when the
    # flow and turbulence methods match, else two)
    from su2_tpu_torch.ops import gradients
    tier = gradients.use_tiled(sim.mesh)
    sweeps = 2 if sim.scfg.grad_method == sim.cfg.num_method_grad else 3
    n_tc = sum(bc.kind == "inlet" and bc.inlet_mode == "TOTAL_CONDITIONS"
               for bc in sim.bcs)
    # implicit flow: K10 instead of T3/K8, the source system in torch ops
    imp = sim.cfg.implicit_flow
    want = {"node_state": 2 * niter,
            "edge_flux": 0 if tier or imp else niter,
            "edge_win": niter if tier and not imp else 0,
            "edge_implicit": niter if imp else 0,
            "gradient_rows": sweeps * niter if tier else 0,
            "chem_source": 0 if imp else niter, "inlet_tc": n_tc * niter}
    for k, c in want.items():
        if counts[k] != c:
            raise AssertionError(f"{size}: {k} launched {counts[k]} times "
                                 f"in {niter} iterations, expected {c}")
    if counts["mixture_enthalpy"] < niter:
        raise AssertionError(f"{size}: mixture_enthalpy launched "
                             f"{counts['mixture_enthalpy']} < {niter}")
    name, per_iter = STENCIL_PER_ITER[size]
    for k in ("stencil_fgmres", "stencil_sgs_matvec"):
        want_k = per_iter * niter if (k == name and prec == "LU_SGS") else 0
        if counts[k] != want_k:
            raise AssertionError(f"{size} {prec}: {k} launched {counts[k]} "
                                 f"times in {niter} iterations, expected "
                                 f"{want_k}")
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
    prof = ""
    if profile:
        cuda_launches, busy, ours, top, by_group = profile_steps(
            sim, (u, t) + tuple(ts))
        prof = (f", profiled: {cuda_launches:.1f} CUDA launches/iter, "
                f"device busy {busy:.3f} ms/iter, su2k kernels' device "
                f"ms/iter {ours}, the largest other device ops' ms/iter "
                f"{top}, CUDA launches/iter by stage {by_group}")
    dt = str(sim.dtype).split(".")[-1]
    if n_tc:
        prec = f"{prec}, TOTAL_CONDITIONS inlet"
    if imp:
        prec = f"implicit flow ({sim.cfg.spatial_order_flow}), {prec}"
    phase("slice", f"{n} nodes {dt} {prec} x {niter}: {ms:.3f} ms/iter, "
          f"{n / (ms * 1e3):.3f} Mcell-updates/s, log10 rms[rho] "
          f"{hist[0][0]:.4f} -> {hist[-1][0]:.4f}, max|omega| "
          f"{om_max:.4g} kg/(m^3 s), kernel launches {counts}{prof} "
          f"({card})")
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
    niters = {"flagship": 50, "scaling": 20, "tier": 10}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_") as tmp:
        for dt in ("float64", "float32"):
            kernel_phase(tmp, dt, report)
        sims = {}
        for size in SIZES:
            t0 = time.perf_counter()
            sims[size] = make_case(tmp, *SIZES[size], torch.float32, "cuda")
            phase("kernels", f"{sims[size].mesh.npoint}-node case built in "
                  f"{time.perf_counter() - t0:.1f} s")
        for dt in ("float64", "float32"):
            tier_kernel_phase(sims["tier"], dt, report)
        stencil_phase({k: sims[k] for k in ("flagship", "scaling")}, report)
        # the implicit-flow case (MUSCL + Venkatakrishnan, JACOBI) at every
        # size; K10 against its plain version at every size
        main_imp = IMPLICIT_VARIANTS["venkatakrishnan"]
        imp = {}
        for size in SIZES:
            t0 = time.perf_counter()
            imp[size] = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                                  implicit=main_imp)
            phase("k10", f"{imp[size].mesh.npoint}-node implicit case built "
                  f"in {time.perf_counter() - t0:.1f} s")
        for dt in ("float64", "float32"):
            implicit_kernel_phase(imp["flagship"], dt, report,
                                  list(IMPLICIT_VARIANTS))
        for size in ("scaling", "tier"):
            implicit_kernel_phase(imp[size], "float32", report,
                                  ["venkatakrishnan"])
        step_phase(tmp)
        step_phase(tmp, tier=True)
        step_phase(tmp, total_conditions=True)
        step_phase(tmp, implicit=main_imp)
        step_phase(tmp, tier=True, implicit=main_imp)
        # each run: (label, launch counts, iterations)
        runs = []
        for size, niter in niters.items():
            runs.append((str(sims[size].mesh.npoint), slice_phase(
                sims[size], size, niter, card, profile=size == "tier"),
                niter))
        # the TOTAL_CONDITIONS inlet on the main path: K9 once per iteration
        runs.append(("9072 TOTAL_CONDITIONS", slice_phase(
            make_case(tmp, *SIZES["flagship"], torch.float32, "cuda",
                      total_conditions=True), "flagship", 10, card,
            profile=True), 10))
        # float64 past the full-precision gate: K5 at full precision inside
        # the Krylov loop, KRYLOV_M launches per iteration
        slice_phase(make_case(tmp, *SIZES["scaling"], torch.float64, "cuda"),
                    "scaling", 3, card)
        # JACOBI (the path without K5/K6) against LU_SGS in the order J, L,
        # each run profiled after its timed run
        for size, niter in niters.items():
            jac = make_case(tmp, *SIZES[size], torch.float32, "cuda",
                            prec="JACOBI")
            for sim, prec in ((jac, "JACOBI"), (sims[size], "LU_SGS")):
                slice_phase(sim, size, niter, card, prec=prec, profile=True)
        # the implicit flow: K10 once per iteration, profiled
        for size, niter in IMPLICIT_NITERS.items():
            runs.append((f"{imp[size].mesh.npoint} implicit", slice_phase(
                imp[size], size, niter, card, prec="JACOBI", profile=True),
                niter))

    # each kernel's numbers at its main-path use: T1-T4 in f32 at 9,072
    # nodes, K5 mixed at 142,317 nodes, K6 f32 at 9,072 nodes, K7 (WLS, the
    # case's method) and K8 in f32 at 565,500 nodes, K9 in f32 on the
    # 377-vertex batch, K10 f32 at 9,072 nodes (MUSCL + Venkatakrishnan)
    main_use = {"stencil_sgs_matvec": ("sst142317", "mixed", "sgs_matvec"),
                "stencil_fgmres": ("sst9072", "float32"),
                "gradient_rows": "float32 WLS",
                "edge_implicit": "float32 9072 venkatakrishnan"}
    rows = []
    for name, (src, repl) in KERNELS.items():
        rec = dict(report[name][main_use.get(name, "float32")])
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl,
               "launches": sum(c[name] for _, c, _ in runs),
               "launches_per_iter": {label: c[name] / it
                                     for label, c, it in runs}}
        row.update(rec)
        if name == "stencil_sgs_matvec":
            mv = report[name][("sst142317", "float32", "matvec")]
            row["matvec_only"] = {k: mv[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")}
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
