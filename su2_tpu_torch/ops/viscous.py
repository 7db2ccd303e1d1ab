"""Per-node viscous inputs: the transport bundle, SST coupling data and the
NS gradient variable set (CReactiveNSVariable::SetPrimVar,
variable_direct_reactive.cpp:1188-1229).  The transport properties come
from the node-state pass (state.node_state); the face fluxes are in
ops/viscous_t.py."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from su2_tpu_torch.chemistry import library as cl
from su2_tpu_torch.chemistry.library import ChemLib
from su2_tpu_torch.state import Layout


@dataclass(frozen=True)
class Transport:
    mu: torch.Tensor      # (N,) laminar viscosity
    kappa: torch.Tensor   # (N,) thermal conductivity


@dataclass(frozen=True)
class TurbFlowData:
    """Per-node SST quantities the mean-flow viscous path consumes."""
    tke: torch.Tensor       # (N,) turbulent kinetic energy
    mu_t: torch.Tensor      # (N,) eddy viscosity
    grad_tke: torch.Tensor  # (N, d)
    sigma_k: torch.Tensor   # (N,) blended sigma_k


def ns_gradient_vars(lib: ChemLib, lay: Layout, v: torch.Tensor,
                     xs: torch.Tensor | None = None) -> torch.Tensor:
    """[T, u, v, (w), P, X_1..X_Ns]: the NS gradient set with MOLE
    fractions (solver_direct_reactive.cpp:4784)."""
    if xs is None:
        xs = cl.molar_from_mass(lib, v[:, lay.YS:lay.YS + lay.ns])
    return torch.cat([v[:, lay.T:lay.T + 1], v[:, lay.VX:lay.VX + lay.ndim],
                      v[:, lay.P:lay.P + 1], xs], dim=1)
