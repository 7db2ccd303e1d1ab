"""Convergence history file (COutput::SetConvHistory_Body equivalent,
reference SU2_CFD/src/output_structure.cpp) — the history-writer subset of
the JAX package's io/output.py, NumPy only."""

from __future__ import annotations

import time


HISTORY_HEADER = (
    'TITLE = "SU2 Simulation"\n'
    'VARIABLES = "Iteration","CLift","CDrag","CSideForce","CMx","CMy","CMz",'
    '"CFx","CFy","CFz","CL/CD","HeatFlux_Total","HeatFlux_Maximum",'
    '{res_names},"Linear_Solver_Iterations","CFL_Number","Time(min)"\n'
    'ZONE T= "Convergence history"\n')


class HistoryWriter:
    """Tecplot-style convergence history (SetConvHistory_Body equivalent)."""

    def __init__(self, path: str, nvar_flow: int, nvar_turb: int = 0,
                 cfl: float = 1.0):
        self.path = path
        # the reference prints exactly five flow residual columns
        # (output_structure.cpp:4241) regardless of nVar
        self.nflow = min(nvar_flow, 5)
        self.nturb = nvar_turb
        self.cfl = cfl
        self.t0 = time.time()
        res = [f'"Res_Flow[{k}]"' for k in range(self.nflow)]
        res += [f'"Res_Turb[{k}]"' for k in range(nvar_turb)]
        with open(path, "w") as f:
            f.write(HISTORY_HEADER.format(res_names=",".join(res)))

    def write(self, iteration: int, log_res_flow, log_res_turb=None,
              forces=None, lin_iters: int = 0):
        forces = forces or {}
        cl = forces.get("CL", 0.0)
        cd = forces.get("CD", 0.0)
        vals = [float(iteration), cl, cd, 0.0,
                forces.get("CMx", 0.0), forces.get("CMy", 0.0),
                forces.get("CMz", 0.0),
                forces.get("CFx", 0.0), forces.get("CFy", 0.0),
                forces.get("CFz", 0.0),
                cl / cd if cd != 0 else 0.0,
                forces.get("HF_total", 0.0), forces.get("HF_max", 0.0)]
        vals += [float(x) for x in log_res_flow[:self.nflow]]
        if log_res_turb is not None:
            vals += [float(x) for x in log_res_turb[:self.nturb]]
        vals += [float(lin_iters), self.cfl, (time.time() - self.t0) / 60.0]
        with open(self.path, "a") as f:
            f.write(", ".join(f"{v:.10g}" for v in vals) + "\n")
