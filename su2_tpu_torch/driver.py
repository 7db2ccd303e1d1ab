"""Simulation driver for the coupled REACTIVE_RANS step (torch).

Port of the JAX package's Simulation for one configuration family:
reactive Navier-Stokes with SST and PaSR and the AUSM scheme, on meshes
with a static neighbour stencil.  The flow is explicit (first order), or
implicit (EULER_IMPLICIT, first order or MUSCL with or without a limiter,
solved by FGMRES with the JACOBI preconditioner); the SST system is
implicit, solved by FGMRES with the multicolor SGS (LU_SGS, ILU0) or
JACOBI preconditioner.  One
outer iteration is the segregated sequence of iteration_structure.cpp
:531-550: flow system (with SST closures), then the SST system on the
updated flow state.  Setup stays on
the host (NumPy); the step runs on the tensors' device — the CUDA kernels
on a card, their plain versions on the CPU.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from su2_tpu_torch import state as st
from su2_tpu_torch.chemistry import host as clh
from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.config import Config
from su2_tpu_torch.geometry import stencil as stn
from su2_tpu_torch.geometry.dual_grid import build_dual_grid
from su2_tpu_torch.geometry.mesh_data import mesh_arrays
from su2_tpu_torch.io.mesh import RawMesh
from su2_tpu_torch.linalg import blockcsr, krylov
from su2_tpu_torch.ops import timestep, viscous as vis
from su2_tpu_torch.solvers import euler as es
from su2_tpu_torch.solvers import ns
from su2_tpu_torch.state import Layout, TSolveParams
from su2_tpu_torch.turbulence import sst


def _permute_raw_mesh(mesh: RawMesh, perm: np.ndarray) -> RawMesh:
    """Renumber a RawMesh so node perm[k] becomes node k."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    elem_nodes = np.where(mesh.elem_nodes >= 0, inv[mesh.elem_nodes],
                          mesh.elem_nodes)
    markers = {tag: np.where(m >= 0, inv[m], m)
               for tag, m in mesh.markers.items()}
    return RawMesh(ndim=mesh.ndim, coords=mesh.coords[perm],
                   elem_types=mesh.elem_types, elem_nodes=elem_nodes,
                   markers=markers, marker_types=mesh.marker_types)


def _unported(cfg: Config):
    """Configurations outside the ported path, each with the su2_tpu
    module that runs it."""
    checks = [
        (not cfg.reactive, "non-reactive solvers", "su2_tpu.driver"),
        (cfg.kind_turb_model != "SST", f"KIND_TURB_MODEL= "
         f"{cfg.kind_turb_model}", "su2_tpu.turbulence"),
        (cfg.implicit_flow and cfg.linear_solver_prec in ("LU_SGS", "ILU0"),
         f"TIME_DISCRE_FLOW= EULER_IMPLICIT with LINEAR_SOLVER_PREC= "
         f"{cfg.linear_solver_prec} (the flow's 13-wide block sweep)",
         "su2_tpu.pallas.stencil_solve"),
        (not cfg.implicit_turb, "explicit turbulence", "su2_tpu.driver"),
        (cfg.muscl_flow and not cfg.implicit_flow,
         "MUSCL reconstruction with explicit flow (convective_residual)",
         "su2_tpu.solvers.euler"),
        (cfg.conv_num_method_flow != "AUSM",
         f"CONV_NUM_METHOD_FLOW= {cfg.conv_num_method_flow}",
         "su2_tpu.ops"),
        (cfg.mglevel > 0, "multigrid", "su2_tpu.multigrid"),
        (cfg.ignition, "IGNITION= YES", "su2_tpu.driver"),
        (cfg.unsteady_simulation not in ("NO", "STEADY", "TIME_STEPPING"),
         "dual time stepping", "su2_tpu.solvers.ns"),
        (bool(cfg.marker_periodic), "periodic markers",
         "su2_tpu.geometry.periodic"),
        (cfg.grid_movement, "grid movement", "su2_tpu.motion"),
        (cfg.axisymmetric or cfg.gravity_force, "axisymmetric/gravity "
         "sources", "su2_tpu.solvers.euler"),
        (cfg.system_measurements == "US", "US units", "su2_tpu.units"),
        (cfg.restart_sol, "RESTART_SOL= YES", "su2_tpu.io.restart"),
        (cfg.cfl_adapt, "CFL_ADAPT= YES", "su2_tpu.driver"),
        (cfg.linear_solver != "FGMRES", f"LINEAR_SOLVER= "
         f"{cfg.linear_solver}", "su2_tpu.linalg.krylov"),
        (cfg.linear_solver_prec not in ("JACOBI", "LU_SGS", "ILU0"),
         f"LINEAR_SOLVER_PREC= {cfg.linear_solver_prec}",
         blockcsr.UNPORTED_PREC.get(cfg.linear_solver_prec,
                                    "su2_tpu.linalg.blockcsr")),
    ]
    for bad, what, where in checks:
        if bad:
            raise NotImplementedError(f"{what}: not ported; {where} has it")


class Simulation:
    """One flow zone: reactive NS + SST on one device."""

    def __init__(self, cfg: Config, raw_mesh: RawMesh | None = None,
                 dtype=torch.float64, device="cuda"):
        _unported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        manifest = cfg.resolve(cfg.config_lib_file)
        # host copy in the run's precision (freestream scalars), then the
        # device copy the step reads
        self.lib_host = cl.load_library(manifest, cfg.library_path or None,
                                        dtype)
        if self.lib_host.nspecies != cfg.nspecies:
            raise ValueError(f"mixture has {self.lib_host.nspecies} species,"
                             f" cfg lists {cfg.nspecies}")
        self.lib = self.lib_host.to(self.device)

        if raw_mesh is None:
            if cfg.mesh_format != "SU2":
                raise NotImplementedError(
                    f"MESH_FORMAT= {cfg.mesh_format}: not ported; "
                    "su2_tpu.io.cgns_mesh has it")
            from su2_tpu_torch.io.mesh import read_su2_mesh
            raw_mesh = read_su2_mesh(cfg.resolve(cfg.mesh_filename))
        raw = raw_mesh
        self.raw = raw
        self.perm = None
        self.grid = build_dual_grid(raw)
        # static-stencil renumbering: when the as-read order has no small
        # neighbour-offset set but the mesh is logically structured,
        # renumber row-major (state arrays then live in the new order)
        if cfg.extra.get("STENCIL_ORDERING", "YES") != "NO" \
                and len(stn.edge_offsets(self.grid.edges)) > stn.MAX_OFFSETS:
            sperm = stn.structured_order(raw)
            if sperm is not None:
                raw2 = _permute_raw_mesh(raw, sperm)
                grid2 = build_dual_grid(raw2)
                if 0 < len(stn.edge_offsets(grid2.edges)) <= stn.MAX_OFFSETS:
                    raw, self.grid, self.perm = raw2, grid2, sperm
        if cfg.implicit_flow and self.grid.ndim == 3:
            raise NotImplementedError("3D implicit flow: not ported; "
                                      "su2_tpu.ops.viscous_t has it")
        self.mesh = mesh_arrays(self.grid, dtype, self.device)
        self.lay = Layout(self.grid.ndim, cfg.nspecies)
        self.tparams = TSolveParams(tmin=cfg.temperature_min,
                                    tmax=cfg.temperature_max,
                                    clip_temp=cfg.clipping_temprature)

        # reactive M_inf = |v_inf|/a_inf overrides the cfg Mach
        # (solver_direct_reactive.cpp:973); it feeds the AUSM+-up clamp
        m_infty = cfg.mach_number
        _, _, _, _, a_inf = clh.freestream_scalars(
            self.lib_host, cfg.freestream_temperature,
            cfg.freestream_mass_frac)
        modvel = float(np.linalg.norm(
            np.asarray(cfg.freestream_velocity[:self.grid.ndim])))
        if modvel > 0.0 and a_inf > 0.0:
            m_infty = modvel / a_inf

        self.params = ns.NSParams(
            lay=self.lay, tparams=self.tparams, m_infty=m_infty,
            cfl=cfg.cfl_number, max_dt=cfg.max_delta_time,
            grad_method=cfg.num_method_grad,
            reactive_sources=self.lib.nreactions > 0,
            pasr=cfg.kind_turb_model == "SST", pasr_lb=cfg.pasr_lb,
            c_mu=cfg.c_mu, prandtl_lam=cfg.prandtl_lam,
            prandtl_turb=cfg.prandtl_turb, lewis_turb=cfg.lewis_turb,
            muscl=cfg.muscl_flow, use_limiter=cfg.limiter_flow,
            limiter_kind=cfg.slope_limiter_flow,
            limiter_coeff=cfg.limiter_coeff,
            ref_elem_length=cfg.ref_elem_length)
        self.bcs = es.build_bc_markers(cfg, self.lib, self.mesh, self.lay)
        self.lower, self.upper = es.clip_limits(self.lay, dtype, self.device)

        # wall distance to the no-slip walls + freestream turbulence
        wall_pts = [self.grid.coords[self.grid.bnd_nodes[tag]]
                    for tag in list(cfg.marker_isothermal)
                    + list(cfg.marker_heatflux)]
        wall_pts = np.concatenate(wall_pts, axis=0) if wall_pts \
            else np.zeros((0, self.grid.ndim))
        wd = sst.wall_distance(self.grid.coords, wall_pts)
        self.wall_dist = torch.as_tensor(wd).to(self.device, dtype)
        ys, t_inf, p_inf, rho_inf, vel_inf, _ = self.freestream_primitives()
        self.kine_inf, self.omega_inf, self.mut_inf = sst.freestream(
            cfg, rho_inf, vel_inf, self._fs_mu_inf)
        self.params = replace(self.params, tke_inf=self.kine_inf)
        self.scfg = sst.SSTConfig(
            grad_method=cfg.num_method_grad,
            cfl_red=cfg.cfl_reduction_turb,
            relax=cfg.relaxation_factor_turb,
            linear_solver=cfg.linear_solver,
            linear_iter=cfg.linear_solver_iter,
            linear_tol=cfg.linear_solver_error,
            linear_prec=cfg.linear_solver_prec)
        # colors of the SGS-class preconditioners' multicolor sweep, taken
        # after the stencil renumbering
        if cfg.linear_solver_prec != "JACOBI":
            colors, ncolor = blockcsr.sweep_colors(self.grid.node_nbrs,
                                                   self.device)
            self.scfg = replace(self.scfg, colors=colors, ncolor=ncolor)
        self.history = None
        self.u0, self.t0 = self.freestream_solution()
        self._step = self._make_rans_step()

    # ------------------------------------------------------------------
    def freestream_primitives(self):
        """(Y, T, P, rho, velocity, total energy) of the freestream, from
        the host tables (chemistry/host.py); also stores mu_inf."""
        if getattr(self, "_fs_prims", None) is not None:
            return self._fs_prims
        cfg = self.cfg
        t_inf = cfg.freestream_temperature
        p_inf = cfg.freestream_pressure
        rgas, h, mu, _, _ = clh.freestream_scalars(
            self.lib_host, t_inf, cfg.freestream_mass_frac)
        self._fs_mu_inf = float(mu)
        rho_inf = p_inf / (rgas * t_inf)
        vel_inf = np.array(cfg.freestream_velocity[:self.lay.ndim])
        e_int = h - rgas * t_inf
        energy_inf = e_int + 0.5 * float(vel_inf @ vel_inf)
        ys = np.asarray(cfg.freestream_mass_frac, np.float64)
        self._fs_prims = (ys, t_inf, p_inf, rho_inf, vel_inf, energy_inf)
        return self._fs_prims

    def freestream_solution(self):
        """SetFreeStream_Solution (solver_direct_reactive.cpp:2499-2521)."""
        ys, t_inf, p_inf, rho_inf, vel_inf, energy_inf = \
            self.freestream_primitives()
        n = self.mesh.npoint
        lay = self.lay
        u = np.zeros((n, lay.nvar))
        u[:, lay.RHO] = rho_inf
        u[:, lay.RHOVX:lay.RHOVX + lay.ndim] = rho_inf * vel_inf
        u[:, lay.RHOE] = rho_inf * energy_inf
        u[:, lay.RHOS:lay.RHOS + lay.ns] = rho_inf * ys
        t_guess = np.full(n, t_inf)
        return (torch.as_tensor(u).to(self.device, self.dtype),
                torch.as_tensor(t_guess).to(self.device, self.dtype))

    def initial_turb_state(self):
        """(q, mu_t, grad_k, sigma_k) at the freestream turbulence state."""
        n = self.mesh.npoint
        kw = dict(dtype=self.dtype, device=self.device)
        q0 = torch.tensor([[self.kine_inf, self.omega_inf]], **kw).repeat(n, 1)
        mu_t0 = torch.full((n,), min(self.mut_inf, 1.0), **kw)
        grad_k0 = torch.zeros((n, 2, self.lay.ndim), **kw)
        sigma_k0 = torch.full((n,), sst.SIGMA_K1, **kw)
        return q0, mu_t0, grad_k0, sigma_k0

    # ------------------------------------------------------------------
    def _make_rans_step(self):
        """Segregated REACTIVE_RANS outer iteration: the flow system (with
        SST closures), explicit or implicit (EULER_IMPLICIT: the linearised
        system solved by FGMRES with the JACOBI preconditioner), then the
        implicit SST system."""
        lib, lay, mesh, prm, bcs = (self.lib, self.lay, self.mesh,
                                    self.params, self.bcs)
        tparams = self.tparams
        lower, upper = self.lower, self.upper
        cfg = self.cfg
        turb_phase = self._make_turb_phase()

        def flow_dt(v, lam_v, lam_c=None):
            dt, min_dt, _ = timestep.local_time_step(
                mesh, lay, v, prm.cfl, prm.max_dt, lam_visc=lam_v,
                lam_inv=lam_c)
            return timestep.apply_time_marching(
                dt, min_dt, cfg.unsteady_simulation, cfg.unst_timestep,
                cfg.unst_cfl_number), min_dt

        def implicit_flow(u, v, nsd, turb, omega_t):
            lam_v = ns.viscous_lambda(lib, mesh, lay, prm, v,
                                      vis.Transport(nsd.mu, nsd.kappa),
                                      nsd.dpdu, turb)
            dt, min_dt = flow_dt(v, lam_v)
            res, wall_mask, _, _, jac, flow_fb = ns.ns_assemble(
                lib, lay, mesh, prm, bcs, v, nsd, turb, omega_t, dt=dt)
            u = ns.enforce_wall_velocity(lay, u, wall_mask)
            rhs = -res
            mv, pc, pm, _ = blockcsr.make_solver_ops_stencil_t(
                mesh, jac.diag, jac.sel_t, cfg.linear_solver_prec,
                linear_iter=cfg.linear_solver_iter)
            sol, _, _ = krylov.fgmres(mv, pc, rhs,
                                      max_iter=cfg.linear_solver_iter,
                                      tol=cfg.linear_solver_error,
                                      precond_matvec=pm)
            u_new = u + cfg.relaxation_factor_flow * sol
            u_new = torch.minimum(torch.maximum(u_new, lower), upper)
            rms = torch.sqrt((rhs * rhs).mean(0))
            rmax = torch.abs(rhs).amax(0)
            return u_new, wall_mask, dt, min_dt, flow_fb, rms, rmax

        def explicit_flow(u, v, nsd, turb, omega_t):
            res, wall_mask, trans, _, lams, flow_fb = ns.ns_assemble(
                lib, lay, mesh, prm, bcs, v, nsd, turb, omega_t)
            lam_c = timestep.boundary_lambda_inv(mesh, lay, v, lams[0])
            lam_v = ns.viscous_lambda_boundary(lib, mesh, lay, prm, v, trans,
                                               nsd.dpdu, turb, lams[1])
            dt, min_dt = flow_dt(v, lam_v, lam_c)
            u = ns.enforce_wall_velocity(lay, u, wall_mask)
            u_new, rms, rmax = es.explicit_euler_update(
                lay, mesh, u, res, dt, lower, upper)
            return u_new, wall_mask, dt, min_dt, flow_fb, rms, rmax

        flow = implicit_flow if cfg.implicit_flow else explicit_flow

        def step(u, t_guess, q, mu_t, grad_k, sigma_k):
            tke = q[:, 0]
            omega_t = q[:, 1]
            nsd = st.node_state(lib, lay, u, t_guess, tparams, turb_ke=tke)
            u, v, nonphys = nsd.u, nsd.v, nsd.nonphys
            turb = vis.TurbFlowData(tke=tke, mu_t=mu_t,
                                    grad_tke=grad_k[:, 0, :], sigma_k=sigma_k)
            u_new, wall_mask, dt, min_dt, flow_fb, rms, rmax = flow(
                u, v, nsd, turb, omega_t)
            u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)
            return turb_phase(u_new, v, tke, q, mu_t, grad_k, dt, flow_fb,
                              rms, rmax, nonphys.sum(), min_dt)

        return step

    def _make_turb_phase(self):
        """Single-grid SST phase on the post-update flow state
        (CSingleGridIntegration, integration_time.cpp:777)."""
        lib, lay, mesh, prm = self.lib, self.lay, self.mesh, self.params
        bcs, cfg, scfg = self.bcs, self.cfg, self.scfg
        dist, tparams = self.wall_dist, self.tparams

        def turb_phase(u_new, v, tke, q, mu_t, grad_k, dt, flow_fb, rms,
                       rmax, nonphys0, min_dt):
            rho_old = v[:, lay.PRHO]
            nsd2 = st.node_state_lite(lib, lay, u_new, v[:, lay.T], tparams,
                                      turb_ke=tke)
            u_new, v_new, nonphys2 = nsd2.u, nsd2.v, nsd2.nonphys
            qgrad = vis.ns_gradient_vars(lib, lay, v_new, xs=nsd2.xs)
            nq = qgrad.shape[1]
            if scfg.grad_method == cfg.num_method_grad:
                # (k, omega) ride in the flow gradient sweep
                gall = es.compute_gradients(mesh, prm,
                                            torch.cat([qgrad, q], dim=1))
                grad_new, gq = gall[:, :nq, :], gall[:, nq:, :]
            else:
                grad_new = es.compute_gradients(mesh, prm, qgrad)
                gq = es.compute_gradients(
                    mesh, replace(prm, grad_method=scfg.grad_method), q)
            strain, _ = sst.strain_and_vorticity(lay, grad_new)
            q_new, turb_rms, outs = sst.sst_step(
                lay, mesh, scfg, bcs, q, v_new, nsd2.mu, mu_t, strain, dist,
                rho_old, dt, self.kine_inf, self.omega_inf, gq=gq,
                gvel=grad_new[:, 1:1 + lay.ndim, :], flow_fb=flow_fb,
                gq_prev=grad_k)
            return (u_new, v_new[:, lay.T], q_new, outs["mu_t"], outs["gq"],
                    outs["sigma_k"], rms, rmax, turb_rms,
                    nonphys0 + nonphys2.sum(), min_dt)

        return turb_phase

    # ------------------------------------------------------------------
    def enable_output(self, out_dir: str | None = None):
        """Write the convergence history (history writer of the JAX
        package's COutput role)."""
        from su2_tpu_torch.io.output import HistoryWriter
        base = out_dir or os.getcwd()
        self.history = HistoryWriter(
            os.path.join(base, self.cfg.conv_filename + ".dat"),
            self.lay.nvar, 2, cfl=self.cfg.cfl_number)

    def run(self, niter: int | None = None, log_every: int = 1, u=None,
            t_guess=None, turb_state=None, quiet=False, chunk: int = 1):
        """Main iteration loop.  Every `chunk` iterations the per-iteration
        residuals come back to the host in one copy, for the NaN check, the
        history file, the log and the convergence test.
        Returns (u, t_guess, hist (niter, nVar) log10 RMS, turb_state)."""
        cfg = self.cfg
        niter = niter if niter is not None else cfg.ext_iter
        u = self.u0 if u is None else u
        t_guess = self.t0 if t_guess is None else t_guess
        q, mu_t, grad_k, sigma_k = (turb_state if turb_state is not None
                                    else self.initial_turb_state())
        hist = []
        rms0 = None
        start = time.time()
        it = 0
        converged = False
        while it < niter and not converged:
            k = min(max(chunk, 1), niter - it)
            outs = []
            for _ in range(k):
                (u, t_guess, q, mu_t, grad_k, sigma_k, rms, _rmax, turb_rms,
                 nerr, min_dt) = self._step(u, t_guess, q, mu_t, grad_k,
                                            sigma_k)
                outs.append(torch.cat([rms, turb_rms, nerr[None].to(rms.dtype),
                                       min_dt[None]]))
            block = torch.stack(outs).cpu().double().numpy()
            nv = self.lay.nvar
            for j in range(k):
                gi = it + j
                rms_np, trms_np = block[j, :nv], block[j, nv:nv + 2]
                if np.isnan(rms_np).any():
                    raise RuntimeError(f"NaN residual at iteration {gi}")
                log_rms = np.log10(np.maximum(rms_np, 1e-300))
                log_trms = np.log10(np.maximum(trms_np, 1e-300))
                hist.append(log_rms)
                if rms0 is None:
                    rms0 = log_rms.copy()
                if self.history is not None and gi % cfg.wrt_con_freq == 0:
                    self.history.write(gi, log_rms, log_trms,
                                       lin_iters=cfg.linear_solver_iter)
                if not quiet and gi % log_every == 0:
                    print(f"{gi:6d}  Res[Rho]: {log_rms[self.lay.RHO]: .6f}  "
                          f"Res[RhoE]: {log_rms[self.lay.RHOE]: .6f}  "
                          f"Res[k]: {log_trms[0]: .4f}  "
                          f"Res[w]: {log_trms[1]: .4f}  "
                          f"dt_min: {block[j, nv + 3]:.3e}  "
                          f"nonphys: {int(block[j, nv + 2])}  "
                          f"({time.time() - start:.1f}s)")
                if cfg.conv_criteria == "RESIDUAL" \
                        and gi > cfg.startconv_iter:
                    cur = log_rms[self.lay.RHO]
                    if (cur < cfg.residual_minval
                            or rms0[self.lay.RHO] - cur
                            > cfg.residual_reduction):
                        converged = True
                        break
            it += k
        return u, t_guess, np.array(hist), (q, mu_t, grad_k, sigma_k)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    if not argv:
        print("usage: python -m su2_tpu_torch [--cpu] <config.cfg> [niter]")
        return 1
    if not cpu and not torch.cuda.is_available():
        print("su2_tpu_torch: no CUDA device is visible; pass --cpu to run "
              "the plain torch versions on the CPU", file=sys.stderr)
        return 2
    cfg = Config(argv[0])
    niter = int(argv[1]) if len(argv) > 1 else None
    dtype = torch.float64 if os.environ.get("SU2_TPU_DTYPE") == "float64" \
        else torch.float32
    sim = Simulation(cfg, dtype=dtype, device="cpu" if cpu else "cuda")
    sim.enable_output()
    sim.run(niter, chunk=25)
    return 0
