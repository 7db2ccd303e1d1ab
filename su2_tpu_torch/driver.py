"""Simulation driver for the coupled REACTIVE_RANS step and the laminar
REACTIVE_NAVIER_STOKES step (torch).

Port of the JAX package's Simulation for one configuration family:
reactive Navier-Stokes, with SST and PaSR (KIND_TURB_MODEL= SST) or
laminar (NONE), and the AUSM scheme, on meshes with a static neighbour
stencil and on meshes without one (the gather path: triangles or
tetrahedra, nodes in any order).  The flow is explicit (first order or
MUSCL; laminar also Runge-Kutta), or implicit (EULER_IMPLICIT, first
order or MUSCL with or without a limiter; 2D and 3D);
the flow and SST systems are solved by FGMRES or BCGSTAB with the
multicolor SGS (LU_SGS, ILU0), LINELET (the flow's system; the SST's takes
the sweep) or JACOBI preconditioner.  One RANS
outer iteration is the segregated sequence of iteration_structure.cpp
:531-550: flow system (with SST closures), then the SST system on the
updated flow state; a laminar one is the flow system alone
(_make_explicit_step, _make_implicit_step).  Setup stays on
the host (NumPy); the step runs on the tensors' device — the CUDA kernels
on a card, their plain versions on the CPU.  The main loop runs the step
in chunks (rans_multistep, flow_multistep): on a card each iteration is
one replay of a CUDA graph captured from the step (StepGraph), with one
copy of the chunk's residuals to the host; on the CPU the step runs
eagerly.  Between chunks the host writes the history, the solution
files (restart, volume, surface: write_solution) and the force
coefficients over MARKER_MONITORING (monitor_forces), and tests CAUCHY;
RESTART_SOL starts from a restart file.  Dual time stepping
(DUAL_TIME_STEPPING-1ST/2ND_ORDER) runs the RANS step as the inner
iterations of run_unsteady, on the card as replays of the same graph.
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
        (cfg.kind_turb_model not in ("SST", "NONE"), f"KIND_TURB_MODEL= "
         f"{cfg.kind_turb_model}", "su2_tpu.turbulence"),
        (cfg.turbulent and not cfg.implicit_turb, "explicit turbulence",
         "su2_tpu.driver"),
        (cfg.conv_num_method_flow != "AUSM",
         f"CONV_NUM_METHOD_FLOW= {cfg.conv_num_method_flow}",
         "su2_tpu.ops"),
        (cfg.mglevel > 0, "multigrid", "su2_tpu.multigrid"),
        (cfg.unsteady_simulation not in ("NO", "STEADY", "TIME_STEPPING")
         and not dual_time_order(cfg), f"UNSTEADY_SIMULATION= "
         f"{cfg.unsteady_simulation}", "su2_tpu.driver"),
        (bool(cfg.marker_periodic), "periodic markers",
         "su2_tpu.geometry.periodic"),
        (cfg.grid_movement, "grid movement", "su2_tpu.motion"),
        (cfg.axisymmetric or cfg.gravity_force, "axisymmetric/gravity "
         "sources", "su2_tpu.solvers.euler"),
        (cfg.system_measurements == "US", "US units", "su2_tpu.units"),
        (cfg.linear_solver_prec not in ("JACOBI",) + blockcsr.SGS_KINDS,
         f"LINEAR_SOLVER_PREC= {cfg.linear_solver_prec}",
         blockcsr.UNPORTED_PREC.get(cfg.linear_solver_prec,
                                    "su2_tpu.linalg.blockcsr")),
    ]
    for bad, what, where in checks:
        if bad:
            raise NotImplementedError(f"{what}: not ported; {where} has it")


# UNSTEADY_SIMULATION values of dual time stepping and their BDF order
DUAL_TIME_ORDERS = {"DUAL_TIME_STEPPING-1ST_ORDER": 1, "DT_STEPPING_1ST": 1,
                    "DUAL_TIME_STEPPING-2ND_ORDER": 2, "DT_STEPPING_2ND": 2}


def dual_time_order(cfg: Config) -> int:
    """The BDF order of the cfg's dual time stepping, 0 without it."""
    return DUAL_TIME_ORDERS.get(cfg.unsteady_simulation, 0)


# SU2_TPU_SST_ASSEMBLE, the reference's switch: its values and the SST
# assembly mode each selects
SST_ASSEMBLE_MODES = {"pallas": "fused", "xla": "unfused"}


class Simulation:
    """One flow zone: reactive NS (+ SST) on one device."""

    def __init__(self, cfg: Config, raw_mesh: RawMesh | None = None,
                 dtype=torch.float64, device="cuda"):
        _unported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and dtype == torch.float32:
            # the fused SST assembly (K12), the reference's switch for its
            # production (accelerator, float32) runs: off unless set
            mode = os.environ.get("SU2_TPU_SST_ASSEMBLE")
            if mode:
                if mode not in SST_ASSEMBLE_MODES:
                    raise ValueError(f"SU2_TPU_SST_ASSEMBLE={mode}: 'pallas' "
                                     "(fused) or 'xla' (unfused)")
                sst.set_assemble_mode(SST_ASSEMBLE_MODES[mode])
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
            from su2_tpu_torch.io.cgns_mesh import read_mesh
            raw_mesh = read_mesh(cfg.resolve(cfg.mesh_filename),
                                 cfg.mesh_format)
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
        # colors of the SGS-class preconditioners' multicolor sweep of the
        # implicit systems, taken after the stencil renumbering
        self.colors, self.ncolor = None, 0
        if cfg.linear_solver_prec != "JACOBI" \
                and (cfg.implicit_flow or cfg.turbulent):
            self.colors, self.ncolor = blockcsr.sweep_colors(
                self.grid.node_nbrs, self.device)
        # wall-normal lines of the flow system's LINELET preconditioner,
        # their index maps on the device (linelet.LineMaps) into the family
        # slots of a stencil system or, without a static stencil, the edge
        # list of a BlockJacobian
        self.lines = None
        if cfg.implicit_flow and cfg.linear_solver_prec == "LINELET":
            from su2_tpu_torch.linalg import linelet
            lines = linelet.build_linelets(self.mesh, self.bcs)
            if lines is not None:
                self.lines = linelet.line_maps(
                    self.mesh, lines,
                    family=self.mesh.fam_offsets is not None)
        self.dual_order = dual_time_order(cfg)
        self.turbulent = cfg.turbulent
        self.history = None
        self.out_dir = None         # enable_output: where solutions go
        self._cauchy_hist = []      # CAUCHY's functional, every run
        self._graph = None
        self.u0, self.t0 = self.freestream_solution()
        self.turb_restart = None
        if cfg.restart_sol:
            try:
                self.u0, self.turb_restart = self.load_restart_state()
            except FileNotFoundError:
                print(f"There is no flow restart file!! "
                      f"{cfg.resolve(cfg.solution_flow_filename)}.")
                raise
        if not self.turbulent:
            # laminar: no wall distance or SST state, tke_inf stays 0
            self._step = (self._make_implicit_step() if cfg.implicit_flow
                          else self._make_explicit_step())
            return

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
        if self.colors is not None:
            self.scfg = replace(self.scfg, colors=self.colors,
                                ncolor=self.ncolor)
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
        """(q, mu_t, grad_k, sigma_k) at the freestream turbulence state,
        or under RESTART_SOL q from the restart file and mu_t, grad_k and
        sigma_k recomputed from the restarted state (the reference's
        turbulent LoadRestart ends in Postprocessing): one node-state pass
        (T2 on the card) and two gradient sweeps."""
        n = self.mesh.npoint
        kw = dict(dtype=self.dtype, device=self.device)
        if self.turb_restart is not None:
            q0 = torch.as_tensor(self.turb_restart).to(**kw)
            lay = self.lay
            nsd = st.node_state(self.lib, lay, self.u0, self.t0,
                                self.tparams, turb_ke=q0[:, 0])
            v = nsd.v
            grad = es.compute_gradients(
                self.mesh, self.params,
                vis.ns_gradient_vars(self.lib, lay, v, xs=nsd.xs))
            strain, _ = sst.strain_and_vorticity(lay, grad)
            gq = es.compute_gradients(self.mesh, self.params, q0)
            f1, f2, _ = sst.blending(q0[:, 0], q0[:, 1], gq[:, 0, :],
                                     gq[:, 1, :], nsd.mu, v[:, lay.PRHO],
                                     self.wall_dist)
            mu_t0 = sst.eddy_viscosity(v[:, lay.PRHO], q0[:, 0], q0[:, 1],
                                       strain, f2)
            return (q0, mu_t0, gq,
                    f1 * sst.SIGMA_K1 + (1.0 - f1) * sst.SIGMA_K2)
        q0 = torch.tensor([[self.kine_inf, self.omega_inf]], **kw).repeat(n, 1)
        mu_t0 = torch.full((n,), min(self.mut_inf, 1.0), **kw)
        grad_k0 = torch.zeros((n, 2, self.lay.ndim), **kw)
        sigma_k0 = torch.full((n,), sst.SIGMA_K1, **kw)
        return q0, mu_t0, grad_k0, sigma_k0

    # ------------------------------------------------------------------
    def _make_rans_step(self):
        """Segregated REACTIVE_RANS outer iteration: the flow system (with
        SST closures), explicit or implicit (EULER_IMPLICIT: the linearised
        system solved by FGMRES or BCGSTAB with the JACOBI preconditioner,
        the multicolor SGS sweep of LU_SGS/ILU0 or LINELET's lines), then
        the implicit SST system.  step(u, t_guess, q, mu_t, grad_k,
        sigma_k, ignite=None, cfl=None, u_n=None, u_nm1=None): ignite, the
        IGNITION window flag
        (a 0-d bool tensor or a bool; None: off); cfl, the CFL number (a
        0-d tensor on the step's device or a float; None: CFL_NUMBER);
        u_n, u_nm1, under dual time stepping, the conserved states of the
        last two physical steps (ns.add_dual_time; the explicit pseudo
        time step at most 2/3 of the physical one)."""
        lib, lay, mesh, prm, bcs = (self.lib, self.lay, self.mesh,
                                    self.params, self.bcs)
        tparams = self.tparams
        lower, upper = self.lower, self.upper
        cfg = self.cfg
        turb_phase = self._make_turb_phase()
        ignition = cfg.ignition
        t_ign = cfg.ignition_temperature
        fuel_i = lay.YS + cfg.fuel_index
        ox_i = lay.YS + cfg.oxidizer_index
        dual_order, dt_phys = self.dual_order, cfg.unst_timestep

        def ignite_v(v, ignite):
            """T -> T_ign in the fuel-rich mixing nodes during the ignition
            window (SetPrimitive_Variables, solver_direct_reactive.cpp
            :1013-1024: only the primitive T is overridden): a select on a
            device mask, no host sync."""
            cond = (v[:, fuel_i] > 0.4) & (v[:, ox_i] > 0.2) \
                & (v[:, lay.T] < t_ign)
            if isinstance(ignite, torch.Tensor):
                cond = cond & ignite
            elif not ignite:
                cond = torch.zeros_like(cond)
            t_new = torch.where(cond, t_ign, v[:, lay.T])
            return torch.cat([t_new[:, None], v[:, lay.T + 1:]], dim=1)

        def flow_dt(v, cfl, lam_v, lam_c=None):
            dt, min_dt, _ = timestep.local_time_step(
                mesh, lay, v, cfl, prm.max_dt, lam_visc=lam_v,
                lam_inv=lam_c)
            dt = timestep.apply_time_marching(
                dt, min_dt, cfg.unsteady_simulation, cfg.unst_timestep,
                cfg.unst_cfl_number)
            if dual_order and not cfg.implicit_flow:
                # the pseudo time step bounded by the physical one
                # (SetTime_Step dual-time branch, :2160-2166)
                dt = torch.clamp(dt, max=2.0 / 3.0 * dt_phys)
            return dt, min_dt

        def implicit_flow(u, v, nsd, turb, omega_t, cfl, dual):
            lam_v = ns.viscous_lambda(lib, mesh, lay, prm, v,
                                      vis.Transport(nsd.mu, nsd.kappa),
                                      nsd.dpdu, turb)
            dt, min_dt = flow_dt(v, cfl, lam_v)
            u_new, wall_mask, flow_fb, rms, rmax = self._implicit_update(
                u, nsd, turb, omega_t, dt, dual)
            return u_new, wall_mask, dt, min_dt, flow_fb, rms, rmax

        def explicit_flow(u, v, nsd, turb, omega_t, cfl, dual):
            res, wall_mask, trans, _, lams, flow_fb = ns.ns_assemble(
                lib, lay, mesh, prm, bcs, v, nsd, turb, omega_t)
            if lams is None:
                # MUSCL: no fused edge pass, whose spectral radii the
                # explicit step reads; both are summed here
                lam_c = None
                lam_v = ns.viscous_lambda(lib, mesh, lay, prm, v, trans,
                                          nsd.dpdu, turb)
            else:
                lam_c = timestep.boundary_lambda_inv(mesh, lay, v, lams[0])
                lam_v = ns.viscous_lambda_boundary(lib, mesh, lay, prm, v,
                                                   trans, nsd.dpdu, turb,
                                                   lams[1])
            dt, min_dt = flow_dt(v, cfl, lam_v, lam_c)
            if dual:
                res, _ = ns.add_dual_time(lay, mesh, res, None, u, *dual,
                                          dt_phys, dual_order)
            u = ns.enforce_wall_velocity(lay, u, wall_mask)
            u_new, rms, rmax = es.explicit_euler_update(
                lay, mesh, u, res, dt, lower, upper)
            return u_new, wall_mask, dt, min_dt, flow_fb, rms, rmax

        flow = implicit_flow if cfg.implicit_flow else explicit_flow

        def step(u, t_guess, q, mu_t, grad_k, sigma_k, ignite=None,
                 cfl=None, u_n=None, u_nm1=None):
            cfl = prm.cfl if cfl is None else cfl
            dual = None
            if dual_order:
                if u_n is None:
                    raise ValueError("dual time stepping: the step needs "
                                     "u_n (and u_nm1); run_unsteady "
                                     "passes them")
                dual = (u_n, u_n if u_nm1 is None else u_nm1)
            tke = q[:, 0]
            omega_t = q[:, 1]
            nsd = st.node_state(lib, lay, u, t_guess, tparams, turb_ke=tke)
            u, v, nonphys = nsd.u, nsd.v, nsd.nonphys
            if ignition:
                # the derived fields follow the overridden T: the bundle is
                # recomputed from v, as su2_tpu's step does with nsd None
                v = ignite_v(v, ignite)
                nsd = st.derived_state(lib, lay, u, v, nonphys)
            turb = vis.TurbFlowData(tke=tke, mu_t=mu_t,
                                    grad_tke=grad_k[:, 0, :], sigma_k=sigma_k)
            u_new, wall_mask, dt, min_dt, flow_fb, rms, rmax = flow(
                u, v, nsd, turb, omega_t, cfl, dual)
            u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)
            return turb_phase(u_new, v, tke, q, mu_t, grad_k, dt, flow_fb,
                              rms, rmax, nonphys.sum(), min_dt)

        return step

    def _implicit_update(self, u, nsd, turb, omega_t, dt, dual=None):
        """The implicit flow update at the local time step dt: assemble
        the system (turb None: laminar; dual = (u_n, u_nm1): with the dual
        time source and diagonal), solve it by FGMRES (one K6 launch where
        the tier has one) or BCGSTAB, relax, clip.  Returns (u_new,
        wall_mask, flux-BC ghost batch, rms, rmax) of the residual."""
        cfg = self.cfg
        res, wall_mask, _, _, jac, flow_fb = ns.ns_assemble(
            self.lib, self.lay, self.mesh, self.params, self.bcs, nsd.v, nsd,
            turb, omega_t, dt=dt)
        if dual:
            res, jac = ns.add_dual_time(self.lay, self.mesh, res, jac, u,
                                        *dual, cfg.unst_timestep,
                                        self.dual_order)
        u = ns.enforce_wall_velocity(self.lay, u, wall_mask)
        rhs = -res
        ops = blockcsr.make_solver_ops(
            self.mesh, jac, cfg.linear_solver_prec, self.colors, self.ncolor,
            linear_iter=cfg.linear_solver_iter, lines=self.lines,
            solver=cfg.linear_solver)
        sol = krylov.solve(cfg.linear_solver, ops, rhs,
                           cfg.linear_solver_iter, cfg.linear_solver_error)
        u_new = u + cfg.relaxation_factor_flow * sol
        u_new = torch.minimum(torch.maximum(u_new, self.lower), self.upper)
        rms = torch.sqrt((rhs * rhs).mean(0))
        rmax = torch.abs(rhs).amax(0)
        return u_new, wall_mask, flow_fb, rms, rmax

    def _make_explicit_step(self):
        """Laminar explicit step (the JAX package's _make_explicit_step):
        explicit Euler, or the RUNGE-KUTTA_EXPLICIT stages (RK_ALPHA_COEFF,
        ExplicitRK_Iteration, solver_direct_reactive.cpp:2456) at the
        first stage's local time step, each stage from the stage-0 state
        with the wall velocity enforced.  step(u, t_guess) -> (u, T, rms,
        rmax, nonphysical count, min dt); cfl as the RANS step's."""
        lib, lay, mesh, prm, bcs = (self.lib, self.lay, self.mesh,
                                    self.params, self.bcs)
        tparams, lower, upper = self.tparams, self.lower, self.upper
        alphas = (tuple(self.cfg.rk_alpha_coeff)
                  if self.cfg.time_discre_flow == "RUNGE-KUTTA_EXPLICIT"
                  else (1.0,))

        def assemble(u, t_guess):
            nsd = st.node_state(lib, lay, u, t_guess, tparams)
            res, wall_mask, trans, _, _, _ = ns.ns_assemble(
                lib, lay, mesh, prm, bcs, nsd.v, nsd, None, None)
            return nsd, res, wall_mask, trans

        def step(u, t_guess, cfl=None):
            cfl = prm.cfl if cfl is None else cfl
            nsd, res, wall_mask, trans = assemble(u, t_guess)
            v, nonphys = nsd.v, nsd.nonphys
            lam_v = ns.viscous_lambda(lib, mesh, lay, prm, v, trans,
                                      nsd.dpdu, None)
            dt, min_dt, _ = timestep.local_time_step(
                mesh, lay, v, cfl, prm.max_dt, lam_visc=lam_v)
            u_old = ns.enforce_wall_velocity(lay, nsd.u, wall_mask)
            u_new, rms, rmax = es.explicit_euler_update(
                lay, mesh, u_old, res, dt, lower, upper, alpha=alphas[0])
            t_cur = v[:, lay.T]
            for alpha in alphas[1:]:
                u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)
                nsd_k, res, _, _ = assemble(u_new, t_cur)
                t_cur = nsd_k.v[:, lay.T]
                nonphys = nonphys | nsd_k.nonphys
                u_new, rms, rmax = es.explicit_euler_update(
                    lay, mesh, u_old, res, dt, lower, upper, alpha=alpha)
            u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)
            return u_new, t_cur, rms, rmax, nonphys.sum(), min_dt

        return step

    def _make_implicit_step(self):
        """Laminar implicit step (the JAX package's _make_implicit_step):
        the local time step from the viscous spectral radius (no time
        marching), then the implicit update, the flow system assembled on
        the family slots (K11) as a FamilyJacobian.  step(u, t_guess) ->
        (u, T, rms, rmax, nonphysical count, min dt); cfl as the RANS
        step's."""
        lib, lay, mesh, prm = self.lib, self.lay, self.mesh, self.params
        tparams = self.tparams

        def step(u, t_guess, cfl=None):
            cfl = prm.cfl if cfl is None else cfl
            nsd = st.node_state(lib, lay, u, t_guess, tparams)
            v = nsd.v
            lam_v = ns.viscous_lambda(lib, mesh, lay, prm, v,
                                      vis.Transport(nsd.mu, nsd.kappa),
                                      nsd.dpdu, None)
            dt, min_dt, _ = timestep.local_time_step(
                mesh, lay, v, cfl, prm.max_dt, lam_visc=lam_v)
            u_new, wall_mask, _, rms, rmax = self._implicit_update(
                nsd.u, nsd, None, None, dt)
            u_new = ns.enforce_wall_velocity(lay, u_new, wall_mask)
            return u_new, v[:, lay.T], rms, rmax, nsd.nonphys.sum(), min_dt

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
    def load_restart_state(self):
        """RESTART_SOL= YES: the conserved state (a tensor in the node
        order of the Simulation) and the SST's (k, omega) (numpy, None when
        laminar) of the SU2-format restart SOLUTION_FLOW_FILENAME
        (Load_Restart, solver_direct_reactive.cpp:566; SST columns
        solver_direct_turbulent.cpp:2839)."""
        from su2_tpu_torch.io import restart as rio
        path = self.cfg.resolve(self.cfg.solution_flow_filename)
        nturb = 2 if self.cfg.turbulent else 0
        u, turb = rio.read_restart(path, self.lay.ndim, self.lay.nvar, nturb)
        if self.perm is not None:
            u = u[self.perm]
            turb = turb[self.perm] if turb is not None else None
        return torch.as_tensor(u).to(self.device, self.dtype), turb

    def to_file_order(self, arr):
        """A per-node host array from the node order of the Simulation
        (stencil renumbering, self.perm) back to the mesh file's: the
        order of every file it writes or reads."""
        arr = np.asarray(arr)
        if self.perm is None:
            return arr
        out = np.empty_like(arr)
        out[self.perm] = arr
        return out

    def enable_output(self, out_dir: str | None = None):
        """Turn on the history file (no turbulence columns when laminar)
        and the solution files of write_solution, in out_dir (default: the
        working directory): the COutput role."""
        from su2_tpu_torch.io.output import HistoryWriter
        base = out_dir or os.getcwd()
        self.out_dir = base
        self.history = HistoryWriter(
            os.path.join(base, self.cfg.conv_filename + ".dat"),
            self.lay.nvar, 2 if self.turbulent else 0,
            cfl=self.cfg.cfl_number)

    def write_solution(self, u, t_guess, turb=None, suffix=""):
        """The restart file, the OUTPUT_FORMAT volume file and the surface
        file over MARKER_PLOTTING (every marker where it lists none) of
        the state (u, t_guess, turb = (q, mu_t) or None), in the mesh
        file's node order, into enable_output's directory: one node-state
        pass on the state's device (T2 on the card), then host NumPy.
        suffix: the restart file's unsteady name stem_<suffix>.ext
        (GetUnsteady_FileName; run_unsteady passes the physical step as
        %05d)."""
        from su2_tpu_torch.io import output as out, restart as rio
        cfg = self.cfg
        base = self.out_dir or os.getcwd()
        nsd = st.node_state(self.lib, self.lay, u, t_guess, self.tparams,
                            turb_ke=turb[0][:, 0] if turb is not None
                            else None)
        unpermute = self.to_file_order
        rname = cfg.restart_flow_filename
        if suffix:
            stem, ext = os.path.splitext(rname)
            rname = f"{stem}_{suffix}{ext}"
        rio.write_restart(os.path.join(base, rname),
                          self.raw.coords,
                          unpermute(nsd.u.cpu().numpy()),
                          unpermute(turb[0].cpu().numpy())
                          if turb is not None else None)
        fields = out._volume_fields(self, nsd.u, nsd.v, nsd.mu,
                                    *(turb if turb is not None else ()))
        fields = {k: unpermute(c) for k, c in fields.items()}
        vol = os.path.join(base, cfg.volume_flow_filename)
        if cfg.output_format == "PARAVIEW":
            out.write_paraview_volume(vol + ".vtk", self.raw, fields)
        elif cfg.output_format == "FIELDVIEW":
            out.write_fieldview_volume(vol + ".uns", self.raw, fields,
                                       mach=cfg.mach_number, aoa=cfg.aoa,
                                       reynolds=cfg.reynolds_number)
        elif cfg.output_format == "TECPLOT_BINARY":
            out.write_tecplot_binary_volume(vol + ".plt", self.raw, fields)
        elif cfg.output_format == "CGNS_SOL":
            from su2_tpu_torch.io.cgns_out import write_cgns_volume
            write_cgns_volume(vol + ".cgns", self.raw, fields)
        else:
            out.write_tecplot_volume(vol + ".dat", self.raw, fields)
        tags = [t for t in cfg.marker_plotting or list(self.raw.markers)
                if t in self.grid.bnd_nodes]
        if tags:
            nodes = np.unique(np.concatenate(
                [self.grid.bnd_nodes[t] for t in tags]))
            if self.perm is not None:
                nodes = np.sort(self.perm[nodes])
            out.write_surface_csv(
                os.path.join(base, cfg.surface_flow_filename + ".dat"),
                self.raw, fields, nodes)

    def forces_inputs(self, u, t_guess, turb=None):
        """(markers, v, grad, mu, kappa, coords, mu_t) of
        solvers.forces.surface_forces over MARKER_MONITORING: markers
        {tag: (row ids, normal)}, the rest host arrays at the monitored
        nodes' rows (grad: the NS gradient set's T and velocity rows; mu_t
        None when laminar).  One node-state pass (T2 on the card) and one
        gradient sweep (K7 from 200k nodes) on the state's device, then
        one copy of the rows to the host."""
        lay, nd = self.lay, self.lay.ndim
        tags = [t for t in self.cfg.marker_monitoring
                if t in self.grid.bnd_nodes]
        nodes = (np.unique(np.concatenate([self.grid.bnd_nodes[t]
                                           for t in tags]))
                 if tags else np.zeros(0, np.int64))
        nsd = st.node_state(self.lib, lay, u, t_guess, self.tparams,
                            turb_ke=turb[0][:, 0] if turb is not None
                            else None)
        grad = es.compute_gradients(
            self.mesh, self.params,
            vis.ns_gradient_vars(self.lib, lay, nsd.v, xs=nsd.xs))
        idx = torch.as_tensor(nodes, device=self.device)
        cols = [nsd.v, grad[:, :1 + nd, :].flatten(1), nsd.mu[:, None],
                nsd.kappa[:, None], self.mesh.coords]
        if turb is not None:
            cols.append(turb[1][:, None])
        widths = [c.shape[1] for c in cols]
        rows = torch.cat([c.index_select(0, idx) for c in cols],
                         dim=1).cpu().numpy()
        v, g, mu, kappa, coords, *mu_t = np.split(
            rows, np.cumsum(widths)[:-1], axis=1)
        np_dtype = rows.dtype
        markers = {t: (np.searchsorted(nodes, self.grid.bnd_nodes[t]),
                       self.grid.bnd_normal[t].astype(np_dtype))
                   for t in tags}
        return (markers, v, g.reshape(len(nodes), 1 + nd, nd), mu[:, 0],
                kappa[:, 0], coords, mu_t[0][:, 0] if mu_t else None)

    def monitor_forces(self, u, t_guess, turb=None):
        """Force coefficients over MARKER_MONITORING (COutput monitoring)
        of the state (u, t_guess, turb = (q, mu_t) or None)."""
        from su2_tpu_torch.solvers import forces as ff
        cfg = self.cfg
        markers, v, grad, mu, kappa, coords, mu_t = self.forces_inputs(
            u, t_guess, turb)
        _, _, p_inf, rho_inf, vel_inf, _ = self.freestream_primitives()
        ref_area = cfg.ref_area if cfg.ref_area > 0 else 1.0
        return ff.surface_forces(
            self.lay, v, grad, mu, kappa, markers, p_inf, rho_inf, vel_inf,
            ref_area, viscous=cfg.viscous, mu_t=mu_t, coords=coords,
            origin=(cfg.ref_origin_moment_x, cfg.ref_origin_moment_y,
                    cfg.ref_origin_moment_z),
            ref_len=cfg.ref_length, aoa_deg=cfg.aoa)

    def write_forces_breakdown(self, u, t_guess, turb=None, path=None):
        """forces_breakdown.dat at the end of a run (SetForces_Breakdown):
        BREAKDOWN_FILENAME (relative to the working directory) or path.
        Returns monitor_forces' coefficients."""
        from su2_tpu_torch.io import output as out
        forces = self.monitor_forces(u, t_guess, turb)
        _, t_inf, p_inf, rho_inf, vel_inf, e_inf = \
            self.freestream_primitives()
        fs = {
            "ndim": self.lay.ndim,
            "Free-stream static pressure": f"{p_inf:g} Pa.",
            "Free-stream temperature": f"{t_inf:g} K.",
            "Free-stream density": f"{rho_inf:g} kg/m^3.",
            "Free-stream velocity":
                f"({', '.join(f'{x:g}' for x in vel_inf)}) m/s. "
                f"Magnitude: {float(np.linalg.norm(vel_inf)):g} m/s.",
            "Free-stream total energy per unit mass":
                f"{e_inf:g} m^2/s^2.",
            "Mach number (non-dim)": f"{self.cfg.mach_number:g}",
            "Angle of attack (AoA)": f"{self.cfg.aoa:g} deg.",
            "Reference area": f"{self.cfg.ref_area:g} m^2.",
            "Reference length (moments)": f"{self.cfg.ref_length:g} m.",
        }
        out.write_forces_breakdown(
            path or self.cfg.breakdown_filename, self.cfg, forces, fs)
        return forces

    # ------------------------------------------------------------------
    def _hist_width(self):
        """Columns of a history row: rms and rmax (nVar each), the SST's
        rms (2, RANS only), the nonphysical count and min dt."""
        return 2 * self.lay.nvar + (2 if self.turbulent else 0) + 2

    def _body(self, carry, ignite, cfl, dual=None):
        """One iteration of self._step from carry (dual: (u_n, u_nm1) of
        dual time stepping): (the new carry, its history row, as
        _hist_width lays it out)."""
        if self.turbulent:
            kw = {} if dual is None else dict(u_n=dual[0], u_nm1=dual[1])
            out = self._step(*carry, ignite, cfl=cfl, **kw)
        else:
            out = self._step(*carry, cfl=cfl)
        nc = len(carry)
        *vecs, nerr, min_dt = out[nc:]
        return out[:nc], torch.cat([*vecs, nerr[None].to(min_dt.dtype),
                                    min_dt[None]])

    def _multistep(self, carry, k, ignites=None, cfl=None, dual=None):
        """k iterations from carry: (the final carry, the (k, W) history
        rows).  On a card k replays of the step's graph (StepGraph,
        captured at the first call, again where k outgrows its history);
        on the CPU the step k times.  ignites: (k,) IGNITION flags (None:
        off); cfl: a float or 0-d tensor (None: CFL_NUMBER); dual: (u_n,
        u_nm1) of dual time stepping, read by every iteration."""
        if self.device.type == "cuda":
            g = self._graph
            if g is None or k > g.hist.shape[0]:
                self._graph = None
                g = self._graph = StepGraph(
                    self._body, carry, self._hist_width(),
                    max(k, DEFAULT_CHUNK), self.params.cfl,
                    ignition=self.turbulent and self.cfg.ignition,
                    dual=dual)
            return g.run(carry, k, ignites,
                         self.params.cfl if cfl is None else cfl, dual)
        rows = []
        for j in range(k):
            carry, row = self._body(
                carry, None if ignites is None else bool(ignites[j]), cfl,
                dual)
            rows.append(row)
        return tuple(carry), torch.stack(rows)

    def _split_history(self, block):
        """The (k, W) history rows as su2_tpu's stacked histories: (rms,
        rmax, turb_rms (RANS only), nerr, min_dt)."""
        nv = self.lay.nvar
        parts = [block[:, :nv], block[:, nv:2 * nv]]
        if self.turbulent:
            parts.append(block[:, 2 * nv:2 * nv + 2])
        return tuple(parts) + (block[:, -2].to(torch.int64), block[:, -1])

    def rans_multistep(self, u, t_guess, q, mu_t, grad_k, sigma_k, ignites,
                       cfl=None):
        """K = len(ignites) coupled iterations as one device program (the
        JAX package's lax.scan; here replays of the step's CUDA graph on a
        card).  ignites: the (K,) per-iteration IGNITION window flags;
        cfl: None (CFL_NUMBER), a float or a 0-d tensor.  Returns the final
        carry (u, t, q, mu_t, grad_k, sigma_k) and the stacked
        per-iteration (rms, rmax, turb_rms, nerr, min_dt), (K, .) device
        tensors."""
        if not self.turbulent:
            raise ValueError("rans_multistep: a laminar Simulation runs "
                             "flow_multistep")
        carry, block = self._multistep(
            (u, t_guess, q, mu_t, grad_k, sigma_k), len(ignites), ignites,
            cfl)
        return carry, self._split_history(block)

    def flow_multistep(self, u, t_guess, k: int, cfl=None):
        """K flow-only (laminar) iterations as one device program, as
        rans_multistep.  Returns the final (u, t) and the stacked (rms,
        rmax, nerr, min_dt)."""
        if self.turbulent:
            raise ValueError("flow_multistep: a REACTIVE_RANS Simulation "
                             "runs rans_multistep")
        carry, block = self._multistep((u, t_guess), k, None, cfl)
        return carry, self._split_history(block)

    def drop_graph(self):
        """Free the captured step graph and its memory pool; the next chunk
        on the card captures it again."""
        self._graph = None

    def run(self, niter: int | None = None, log_every: int = 1, u=None,
            t_guess=None, turb_state=None, quiet=False, chunk: int = 1):
        """Main iteration loop (the JAX package's run and _run_chunked):
        chunks of `chunk` iterations through _multistep (on a card, replays
        of the step's CUDA graph).  Each chunk's residuals come back to
        the host in one copy, for the NaN check (raised at the first bad
        iteration, before any row of its chunk is written), the history
        file, the log and the RESIDUAL test (detected at its iteration,
        the history cut there; the state is the chunk's last).
        IGNITION: iteration it runs with the window flag it <
        IGNITION_ITER.  CFL_ADAPT runs one iteration per chunk: the host
        updates the CFL from the density residuals after each
        (SetCFL_Number) and the next iteration reads it.

        The host work follows su2_tpu's numbering.  su2_tpu runs whole
        chunks while one fits (_run_chunked: after a chunk, the solution
        where the iterations done divide by WRT_SOL_FREQ) and every other
        iteration alone (its run, which chunk 1 and CFL_ADAPT select
        throughout: after iteration it, the history row's forces under
        MARKER_MONITORING, the solution where it > 0 divides by
        WRT_SOL_FREQ, and CONV_CRITERIA= CAUCHY on the monitored CD or CL
        past STARTCONV_ITER).  Here those iterations run as one shorter
        chunk that ends at each iteration whose state the host reads; the
        host reads the chunk's final carry, outside the graph.  Solutions
        are written after enable_output only.
        Returns (u, t_guess, hist (niter, nVar) log10 RMS, turb_state), or
        laminar (u, t_guess, hist).  A dual time stepping cfg runs through
        run_unsteady; here it raises."""
        cfg = self.cfg
        if self.dual_order:
            raise ValueError(
                f"UNSTEADY_SIMULATION= {cfg.unsteady_simulation}: dual time "
                "stepping runs through Simulation.run_unsteady, not run")
        turbulent = self.turbulent
        niter = niter if niter is not None else cfg.ext_iter
        carry = (self.u0 if u is None else u,
                 self.t0 if t_guess is None else t_guess)
        if turbulent:
            carry += tuple(turb_state if turb_state is not None
                           else self.initial_turb_state())
        nv, nt = self.lay.nvar, 2 if turbulent else 0
        adapt = cfg.cfl_adapt
        per_chunk = 1 if adapt else max(chunk, 1)
        # the iterations su2_tpu runs in whole chunks
        nfull = niter // per_chunk * per_chunk if per_chunk > 1 else 0
        monitor = bool(cfg.marker_monitoring)
        cauchy = monitor and cfg.conv_criteria == "CAUCHY"
        writing = self.out_dir is not None

        def needs_forces(gi):
            """Forces after iteration gi (run alone by su2_tpu): for its
            history row, or for CAUCHY."""
            return ((self.history is not None and monitor
                     and gi % cfg.wrt_con_freq == 0)
                    or (cauchy and gi > cfg.startconv_iter))

        def reads_state(gi):
            """Host work after iteration gi (run alone by su2_tpu) that
            reads its state: forces, or a solution write."""
            return needs_forces(gi) or (writing and gi > 0
                                        and gi % cfg.wrt_sol_freq == 0)

        def turb_of(carry):
            return (carry[2], carry[3]) if turbulent else None

        cfl_now = float(cfg.cfl_number)
        rho_res_old = None
        hist = []
        rms0 = None
        start = time.time()
        it = 0
        converged = False
        while it < niter and not converged:
            k = min(per_chunk, niter - it)
            if it >= nfull:
                k = next((j + 1 for j in range(k) if reads_state(it + j)), k)
            ignites = (np.arange(it, it + k) < cfg.ignition_iter
                       if turbulent and cfg.ignition else None)
            carry, block = self._multistep(carry, k, ignites,
                                           cfl_now if adapt else None)
            block = block.cpu().double().numpy()
            bad = np.isnan(block[:, :nv]).any(axis=1)
            if bad.any():
                raise RuntimeError(f"NaN residual at iteration "
                                   f"{it + int(np.argmax(bad))}")
            for j in range(k):
                gi = it + j
                alone = gi >= nfull
                rms_np = block[j, :nv]
                log_rms = np.log10(np.maximum(rms_np, 1e-300))
                log_trms = np.log10(np.maximum(
                    block[j, 2 * nv:2 * nv + nt], 1e-300))
                hist.append(log_rms)
                if rms0 is None:
                    rms0 = log_rms.copy()
                if adapt:
                    # SetCFL_Number (output_structure.cpp:5975): CFL *=
                    # (res_old/res_new)^power, power from CFL_ADAPT_PARAM
                    p = cfg.cfl_adapt_param
                    rho_new = max(float(rms_np[self.lay.RHO]), 1e-300)
                    rho_old = rho_new if rho_res_old is None else rho_res_old
                    div = rho_old / rho_new
                    power = p[0] if div < 1.0 else p[1]
                    if abs(rho_new - rho_old) <= rho_new * 1e-8 and gi != 0:
                        div, power = 0.1, p[1]
                    cfl_now *= div ** power
                    cfl_now = min(max(cfl_now, 1.001 * p[2]), 0.999 * p[3])
                    rho_res_old = rho_new
                    self.cfl_now = cfl_now
                # an iteration run alone whose state the host reads ends
                # its chunk: carry is its state
                forces = (self.monitor_forces(carry[0], carry[1],
                                              turb_of(carry))
                          if alone and needs_forces(gi) else None)
                if self.history is not None and gi % cfg.wrt_con_freq == 0:
                    self.history.write(gi, log_rms,
                                       log_trms if turbulent else None,
                                       forces=forces,
                                       lin_iters=cfg.linear_solver_iter)
                if alone and writing and gi > 0 \
                        and gi % cfg.wrt_sol_freq == 0:
                    self.write_solution(carry[0], carry[1], turb_of(carry))
                if not quiet and gi % log_every == 0:
                    turb_cols = (f"Res[k]: {log_trms[0]: .4f}  "
                                 f"Res[w]: {log_trms[1]: .4f}  "
                                 if turbulent else "")
                    print(f"{gi:6d}  Res[Rho]: {log_rms[self.lay.RHO]: .6f}  "
                          f"Res[RhoE]: {log_rms[self.lay.RHOE]: .6f}  "
                          f"{turb_cols}dt_min: {block[j, -1]:.3e}  "
                          f"nonphys: {int(block[j, -2])}  "
                          f"({time.time() - start:.1f}s)")
                if cfg.conv_criteria == "RESIDUAL" \
                        and gi > cfg.startconv_iter:
                    cur = log_rms[self.lay.RHO]
                    if (cur < cfg.residual_minval
                            or rms0[self.lay.RHO] - cur
                            > cfg.residual_reduction):
                        converged = True
                        break
                elif cauchy and alone and gi > cfg.startconv_iter:
                    # a Cauchy series on the monitored functional
                    # (integration_structure.cpp:425)
                    self._cauchy_hist.append(
                        forces["CD"] if cfg.cauchy_func_flow == "DRAG"
                        else forces["CL"])
                    ne = cfg.cauchy_elems
                    if len(self._cauchy_hist) > ne and np.abs(np.diff(
                            self._cauchy_hist[-ne:])).mean() \
                            < cfg.cauchy_eps:
                        converged = True
                        break
            it += k
            if not converged and writing and it <= nfull \
                    and it % cfg.wrt_sol_freq == 0:
                self.write_solution(carry[0], carry[1], turb_of(carry))
        if not turbulent:
            return carry[0], carry[1], np.array(hist)
        return carry[0], carry[1], np.array(hist), tuple(carry[2:])


    def run_unsteady(self, n_steps: int | None = None, quiet=False):
        """Dual time stepping (the JAX package's run_unsteady): n_steps
        physical steps of UNST_TIMESTEP (default UNST_TIME / UNST_TIMESTEP,
        at least 1), each UNST_INT_ITER inner iterations of the RANS step
        in pseudo time from the freestream (or RESTART_SOL) state, with
        the BDF source of the last two physical steps' states.  The inner
        iterations of a physical step are one chunk (_multistep: on a card
        replays of the step's graph, which reads u_n and u_nm1 from two
        static buffers), then one copy of its last residual row to the
        host: the NaN check and the log.  After enable_output the solution
        is written every WRT_SOL_FREQ_DUALTIME physical steps, the restart
        as restart_flow_%05d.  Returns (u, t_guess, hist (n_steps, nVar)
        log10 RMS of each step's last inner iteration, turb_state)."""
        if not self.turbulent:
            raise ValueError("run_unsteady drives the REACTIVE_RANS step; "
                             "dual time stepping of the laminar step is not "
                             "run (su2_tpu.driver's run_unsteady neither)")
        if not self.dual_order:
            raise ValueError(
                f"run_unsteady: UNSTEADY_SIMULATION= "
                f"{self.cfg.unsteady_simulation} is not dual time stepping")
        cfg = self.cfg
        dt_phys = cfg.unst_timestep
        if n_steps is None:
            n_steps = max(1, int(cfg.unst_time / dt_phys))
        nv = self.lay.nvar
        carry = (self.u0, self.t0) + tuple(self.initial_turb_state())
        dual = (carry[0], carry[0])
        hist = []
        for step_i in range(n_steps):
            carry, block = self._multistep(carry, cfg.unst_int_iter,
                                           dual=dual)
            rms_np = block[-1, :nv].cpu().double().numpy()
            if np.isnan(rms_np).any():
                raise RuntimeError(f"NaN residual at physical step {step_i}")
            log_rms = np.log10(np.maximum(rms_np, 1e-300))
            hist.append(log_rms)
            if not quiet:
                print(f"phys step {step_i:5d} t={dt_phys * (step_i + 1):.4e}"
                      f"  Res[Rho]: {log_rms[self.lay.RHO]: .6f}")
            if self.out_dir is not None \
                    and (step_i + 1) % cfg.wrt_sol_freq_dualtime == 0:
                self.write_solution(carry[0], carry[1], (carry[2], carry[3]),
                                    suffix=f"{step_i:05d}")
            dual = (carry[0], dual[0])
        return carry[0], carry[1], np.array(hist), tuple(carry[2:])


class StepGraph:
    """One iteration of a Simulation's step captured as a CUDA graph,
    replayed on static buffers: the carry (copied back in place inside
    the graph), the (cap,) IGNITION flags, the 0-d CFL, under dual time
    stepping the states u_n and u_nm1 of the last two physical steps, and
    a (cap, W) history.  The iteration reads its flag at a 0-d int64
    slot, writes its history row there (index_copy_) and adds one to the
    slot.  A chunk of
    k iterations loads the carry and the flags, zeroes the slot and
    replays k times; the history's first k rows then hold the chunk's
    residuals.

    The capture follows one eager iteration on a side stream: it builds
    the kernels' library, their lazily made tables and the sweep's node
    orders outside the graph's memory pool.  Every host value the step
    reads (the SST assembly mode, the constants a kernel wrapper passes,
    K6's grid) is read at capture, as su2_tpu's jit reads it at trace.  A
    capture that fails raises its error; nothing runs the eager step in
    its place.  The kernel wrappers' counts during the capture, which
    launches nothing, are taken back out of kernels.launches and kept as
    per_replay; each replay adds them to kernels.launches, which no
    wrapper touches during a replay.

    A CUDA graph may not be destroyed while a stream captures: the call
    fails and invalidates that capture.  The cyclic collector can run
    inside a capture and free an unreachable Simulation with its graph
    (tests/test_torch_cuda.py::test_graph_capture_collects_another_graph
    shows it).  So every StepGraph's CUDA graph is also held in _graphs,
    outside any cycle, and the collector never frees one itself: a
    StepGraph's finalizer releases its graph, or, during a capture, leaves
    it in _parked, which the capture empties once it has ended."""

    _capturing = 0      # StepGraph captures under way
    _graphs = {}        # id(StepGraph) -> its CUDA graph
    _parked = []        # CUDA graphs of StepGraphs freed during a capture

    def __init__(self, body, carry, width, cap, cfl, ignition=False,
                 dual=None):
        from su2_tpu_torch import kernels
        dev = carry[0].device
        dtype = carry[0].dtype
        self.body = body
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            self.carry = tuple(x.clone() for x in carry)
            self.ignites = (torch.zeros((cap,), dtype=torch.bool,
                                        device=dev) if ignition else None)
            self.cfl = torch.full((), cfl, dtype=dtype, device=dev)
            self.dual = (None if dual is None
                         else tuple(x.clone() for x in dual))
            self.slot = torch.zeros((), dtype=torch.int64, device=dev)
            self.hist = torch.zeros((cap, width), dtype=dtype, device=dev)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._iteration()
            torch.cuda.current_stream().wait_stream(side)
            before = dict(kernels.launches)
            self.graph = StepGraph._graphs[id(self)] = torch.cuda.CUDAGraph()
            StepGraph._capturing += 1
            try:
                with torch.cuda.graph(self.graph):
                    self._iteration()
            finally:
                StepGraph._capturing -= 1
                self.per_replay = {name: kernels.launches[name] - c
                                   for name, c in before.items()}
                kernels.launches.update(before)
            torch.cuda.synchronize()
        if not StepGraph._capturing:
            StepGraph._parked.clear()
        self.capture_s = time.perf_counter() - t0

    def __del__(self):
        graph = StepGraph._graphs.pop(id(self), None)
        if graph is not None and StepGraph._capturing:
            StepGraph._parked.append(graph)

    def _iteration(self):
        at = self.slot.view(1)
        ignite = (None if self.ignites is None
                  else self.ignites.index_select(0, at).view(()))
        new, row = self.body(self.carry, ignite, self.cfl, self.dual)
        for buf, x in zip(self.carry, new):
            buf.copy_(x)
        self.hist.index_copy_(0, at, row[None])
        self.slot.add_(1)

    def run(self, carry, k, ignites, cfl, dual=None):
        """k iterations from carry with the flags ignites ((k,) numpy or
        tensor; None: off), the CFL cfl (float or 0-d tensor) and under
        dual time stepping dual = (u_n, u_nm1), copied into the buffers on
        the device: (the final carry, the (k, W) history rows), new
        tensors."""
        from su2_tpu_torch import kernels
        if k > self.hist.shape[0]:
            raise ValueError(f"StepGraph.run: {k} iterations; at most "
                             f"{self.hist.shape[0]}")
        for buf, x in zip(self.carry, carry):
            if buf is not x:
                buf.copy_(x)
        if (dual is None) != (self.dual is None):
            raise ValueError("StepGraph.run: the dual time states are "
                             "given where the capture had none, or missing")
        for buf, x in zip(self.dual or (), dual or ()):
            buf.copy_(x)
        if self.ignites is not None:
            if ignites is None:
                self.ignites.zero_()
            else:
                self.ignites[:k].copy_(torch.as_tensor(ignites))
        if isinstance(cfl, torch.Tensor):
            self.cfl.copy_(cfl)
        else:
            self.cfl.fill_(cfl)
        self.slot.zero_()
        for _ in range(k):
            self.graph.replay()
            for name, c in self.per_replay.items():
                kernels.launches[name] += c
        return tuple(x.clone() for x in self.carry), self.hist[:k].clone()


# the main loop's chunk where SU2_TPU_CHUNK sets none (su2_tpu's main)
DEFAULT_CHUNK = 25


def chunk_size(cfg: Config, env=None) -> int:
    """Iterations per chunk of the CLI's main loop (su2_tpu.driver.main):
    SU2_TPU_CHUNK=<K> where set (at least 1), else 1 under CFL_ADAPT (the
    host updates the CFL every iteration) or MARKER_MONITORING (forces in
    every history row) and DEFAULT_CHUNK otherwise."""
    env = os.environ if env is None else env
    val = env.get("SU2_TPU_CHUNK")
    if val is not None:
        return max(1, int(val))
    return 1 if cfg.cfl_adapt or cfg.marker_monitoring else DEFAULT_CHUNK


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
    if dual_time_order(cfg):
        print(f"su2_tpu_torch: UNSTEADY_SIMULATION= "
              f"{cfg.unsteady_simulation}: the CLI runs the steady loop "
              "(Simulation.run); dual time stepping runs through "
              "Simulation.run_unsteady", file=sys.stderr)
        return 2
    niter = int(argv[1]) if len(argv) > 1 else None
    dtype = torch.float64 if os.environ.get("SU2_TPU_DTYPE") == "float64" \
        else torch.float32
    sim = Simulation(cfg, dtype=dtype, device="cpu" if cpu else "cuda")
    sim.enable_output()
    out = sim.run(niter, chunk=chunk_size(cfg))
    u, t_guess = out[0], out[1]
    turb = (out[3][0], out[3][1]) if sim.turbulent else None
    sim.write_solution(u, t_guess, turb)
    if cfg.marker_monitoring:
        sim.write_forces_breakdown(u, t_guess, turb)
    return 0
