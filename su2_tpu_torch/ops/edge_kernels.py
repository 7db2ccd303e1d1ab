"""The AUSM+-up flux and both its Jacobians per edge: kernel K11
(csrc/ausm_jac.cu) on CUDA tensors, ops/ausm_t.py on CPU tensors.

The counterpart of the JAX package's pallas/edge_kernels.py:
``ausm_flux_jac_t`` takes and returns the feature-major layout (features,
E), which the family assembly of the laminar implicit step
(solvers/euler.convective_system_fam) consumes as it is (the slots of
family k are lanes k nP .. (k + 1) nP - 1); ``ausm_flux_jac`` takes and
returns the edge-major layout (E, features).  Zero-area edges (family pad
slots) give exact zeros.
"""

from __future__ import annotations

from su2_tpu_torch.ops import ausm_t


def ausm_flux_jac_t(lay, v_i, v_j, normal, m_infty: float, s_i, s_j):
    """v_* (nPrim, E), normal (d, E), s_* (nVar, E) dP/dU rows -> flux
    (nVar, E), jac_i, jac_j (nVar, nVar, E)."""
    if v_i.is_cuda:
        from su2_tpu_torch import kernels
        return kernels.ausm_flux_jac(lay, v_i, v_j, normal, m_infty, s_i,
                                     s_j)
    return ausm_t.ausm_flux_t(lay, v_i, v_j, normal, m_infty, s_i, s_j)


def ausm_flux_jac(lay, v_i, v_j, normal, m_infty: float, s_i, s_j):
    """v_* (E, nPrim), normal (E, d), s_* (E, nVar) -> flux (E, nVar),
    jac_i, jac_j (E, nVar, nVar)."""
    if v_i.is_cuda:
        from su2_tpu_torch import kernels
        return kernels.ausm_flux_jac(lay, v_i, v_j, normal, m_infty, s_i,
                                     s_j, edge_major=True)
    f, j_i, j_j = ausm_t.ausm_flux_t(lay, v_i.T, v_j.T, normal.T, m_infty,
                                     s_i.T, s_j.T)
    return f.T, j_i.permute(2, 0, 1), j_j.permute(2, 0, 1)
