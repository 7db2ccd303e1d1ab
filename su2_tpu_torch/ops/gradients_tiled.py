"""The stencil gradient sweep as feature-major rows (the >= 200k-node tier).

Port of su2_tpu/pallas/gradients_tiled.py: for q (nP, nG) it returns rows
(nG*d, nP) whose row g*d + dd is d(q_g)/dx_dd, WLS or GG, with the K
stencil offsets taken in order (the roll path's order) and neighbours
wrapped mod nP.  GG divides by the volume where it is positive and by 1
elsewhere, as the TPU kernel does.  The TPU kernel's lane windows and
tile plan are not ported: on CUDA tensors the sweep is kernel K7
(csrc/gradients_tiled.cu), reading q node-major in place: a block stages
its nodes' window of rows in shared memory, or, where no window fits,
each thread streams its node's taps (kernels.k7_plan); on CPU
tensors ``gradient_rows_plain``, whose elementwise arithmetic is that of
ops/gradients.green_gauss / weighted_least_squares, so its rows equal the
node-major gradient bitwise where every volume is positive.
"""

from __future__ import annotations

import torch


def gradient_rows_plain(mesh, q: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of kernel K7: (nP, nG) -> (nG*d, nP) rows."""
    n, ng = q.shape
    qt = q.T
    out = None
    for k, o in enumerate(mesh.stencil_offsets):
        qr = torch.roll(qt, -o, dims=1)
        if mode == "WLS":
            part = (qr - qt)[:, None, :] * mesh.wls_coeff[k].T[None]
        else:
            part = (0.5 * (qt + qr))[:, None, :] * mesh.gg_snormal[k].T[None]
        out = part if out is None else out + part
    if mode == "GG":
        vol = mesh.volume
        safe = torch.where(vol > 0.0, vol, torch.ones_like(vol))
        out = (out - qt[:, None, :] * mesh.bnd_accum_normal.T[None]) / safe
    return out.reshape(ng * mesh.ndim, n)


def gradient_rows(mesh, q: torch.Tensor, mode: str) -> torch.Tensor:
    """(nP, nG) -> (nG*d, nP): kernel K7 on CUDA tensors, the plain version
    on CPU tensors."""
    if mode not in ("WLS", "GG"):
        raise ValueError(f"gradient mode WLS or GG, got {mode}")
    if q.is_cuda:
        from su2_tpu_torch import kernels
        gg = mode == "GG"
        return kernels.gradient_rows(
            q, mesh.gg_snormal if gg else mesh.wls_coeff,
            mesh.stencil_offsets, mesh.bnd_accum_normal if gg else None,
            mesh.volume if gg else None)
    return gradient_rows_plain(mesh, q, mode)
