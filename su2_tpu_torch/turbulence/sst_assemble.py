"""Fused SST system assembly on static-stencil meshes (torch): the
counterpart of the JAX package's pallas/sst_assemble.py.

The SST step's assembly, the K-offset convective and corrected viscous
sweep, the source terms, the strong wall rows and the Vol/dt diagonal, in
one kernel (K12, csrc/sst_assemble.cu) that emits the system in the lane
layout the stencil solve consumes: res (2, N), the diagonal rows dd =
(d00, d11) (2, N) and sel (4K, N), rows [off0, 0, 0, off1] per offset.  On
a CPU tensor sst_assemble runs the plain version, assemble_plain, with the
reference body's groupings (CUpwSca_TurbSST + CAvgGradCorrected_TurbSST +
CSourcePieceWise_TurbSST, numerics_direct_turbulent.cpp:865-1257).

supported and tile_plan are the reference's size gates of its full-field
and windowed kernels.  They decide only whether the reference takes the
fused path (turbulence/sst.py sst_step), never a tiling: K12 reads p + o_k
wrapped mod N at any size.
"""

from __future__ import annotations

import torch

from su2_tpu_torch.linalg.stencil_solve import (_TILE_W_CAP, _VMEM_LIMIT,
                                                 _npad)

EPS = 1e-16


def supported(npoint: int, k: int, d: int) -> bool:
    """The reference's full-field working-set gate (~(30 + 4K + K d) f32
    rows)."""
    rows = 2 * (30 + 4 * k + k * (d + 1))
    return _npad(npoint) * rows * 4 <= _VMEM_LIMIT


def tile_plan(npoint: int, offsets, d: int):
    """The reference's (T, H, ntiles, E) of its windowed assembly, or
    None: windows of 2 KB per lane at K = 4 (scaled by K) under its VMEM
    limit, a halo of max|offset| rounded to 128 lanes."""
    k = len(offsets)
    h = _npad(max(abs(int(o)) for o in offsets))
    bpl = 2048 * max(1, k) // 4
    w = min(_TILE_W_CAP, (_VMEM_LIMIT // bpl) // 128 * 128)
    t = w - 2 * h
    if t < max(8 * 128, h):
        return None
    ntiles = -(-_npad(npoint) // t)
    return t, h, ntiles, ntiles * t + 2 * h


def assemble_plain(mesh, consts, q, rho, vel, gq, mu, mut, dist, strain,
                   diverg, dt, wall_mask, f1, f2, cdkw):
    """(res (2, N), dd (2, N), sel (4K, N)) of the fused assembly in torch
    ops: node p's neighbour p + o_k by a roll over N (rows without one have
    zero gg_snormal and stencil_pvec, which annihilates the wrapped
    terms); rho and omega guarded (<= 0 -> 1, 0 -> 1) as in the reference,
    so no wrapped value brings a 0/0.  consts = (sigma_k1, sigma_k2,
    sigma_om1, sigma_om2, beta_1, beta_2, beta_star, a1, alfa_1, alfa_2,
    CFL_red); f1/f2/cdkw: the blending of the previous step's gradients.
    The groupings are the reference body's (_assemble_body), op for op."""
    (sk1, sk2, so1, so2, b1, b2, bstar, a1c, al1, al2, cfl_red) = consts
    d = vel.shape[1]
    nbr = lambda x, o: torch.roll(x, -int(o), dims=0)
    q_k = q[:, 0]
    q_w = torch.where(q[:, 1] != 0.0, q[:, 1], 1.0)
    rho = torch.where(rho > 0.0, rho, 1.0)
    vel = [vel[:, a] for a in range(d)]
    gk = [gq[:, 0, a] for a in range(d)]
    gw = [gq[:, 1, a] for a in range(d)]
    coord = [mesh.coords[:, a] for a in range(d)]
    vol = mesh.volume
    sigk = f1 * sk1 + (1.0 - f1) * sk2
    sigw = f1 * so1 + (1.0 - f1) * so2
    diff_k = mu + sigk * mut
    diff_w = mu + sigw * mut
    rhoq0 = rho * q_k
    rhoq1 = rho * q_w

    res0 = res1 = dg0 = dg1 = None
    acc = lambda s, x: x if s is None else s + x
    zero = torch.zeros_like(rho)
    sel = []
    for k, o in enumerate(mesh.stencil_offsets):
        ns = [mesh.gg_snormal[k][:, a] for a in range(d)]
        pv = mesh.stencil_pvec[k]
        qt = 0.5 * sum((vel[a] + nbr(vel[a], o)) * ns[a] for a in range(d))
        a0p = 0.5 * (qt + torch.abs(qt))
        a1p = 0.5 * (qt - torch.abs(qt))
        dm0 = 0.5 * (diff_k + nbr(diff_k, o))
        dm1 = 0.5 * (diff_w + nbr(diff_w, o))
        gm_k = [0.5 * (gk[a] + nbr(gk[a], o)) for a in range(d)]
        gm_w = [0.5 * (gw[a] + nbr(gw[a], o)) for a in range(d)]
        ev = [nbr(coord[a], o) - coord[a] for a in range(d)]
        corr0 = pv * ((nbr(q_k, o) - q_k)
                      - sum(gm_k[a] * ev[a] for a in range(d)))
        corr1 = pv * ((nbr(q_w, o) - q_w)
                      - sum(gm_w[a] * ev[a] for a in range(d)))
        res0 = acc(res0, (a0p * rhoq0 + a1p * nbr(rhoq0, o))
                   - dm0 * (sum(gm_k[a] * ns[a] for a in range(d)) + corr0))
        res1 = acc(res1, (a0p * rhoq1 + a1p * nbr(rhoq1, o))
                   - dm1 * (sum(gm_w[a] * ns[a] for a in range(d)) + corr1))
        pv_rho = pv / rho
        dg0 = acc(dg0, a0p + dm0 * pv_rho)
        dg1 = acc(dg1, a0p + dm1 * pv_rho)
        pv_rro = pv / nbr(rho, o)
        # wall rows of the off-diagonal blocks are zero (strong rows)
        sel += [torch.where(wall_mask, 0.0, a1p - dm0 * pv_rro), zero, zero,
                torch.where(wall_mask, 0.0, a1p - dm1 * pv_rro)]

    # source (CSourcePieceWise_TurbSST)
    alfa_b = f1 * al1 + (1.0 - f1) * al2
    beta_b = f1 * b1 + (1.0 - f1) * b2
    pk = mut * strain * strain - 2.0 / 3.0 * rho * q_k * diverg
    pk = torch.minimum(torch.clamp(pk, min=0.0),
                       20.0 * bstar * rho * q_w * q_k)
    zeta = torch.maximum(q_w, strain * f2 / a1c)
    pw = torch.clamp(strain * strain - 2.0 / 3.0 * zeta * diverg, min=0.0)
    active = dist > 1e-10
    src_k = torch.where(active, pk - bstar * rho * q_w * q_k, 0.0)
    src_w = torch.where(active, alfa_b * rho * pw - beta_b * rho * q_w * q_w
                        + (1.0 - f1) * cdkw, 0.0)
    res0 = res0 - src_k * vol
    res1 = res1 - src_w * vol
    d00 = dg0 + torch.where(active, bstar * q_w * vol, 0.0)
    d11 = dg1 + torch.where(active, 2.0 * beta_b * q_w * vol, 0.0)

    # strong wall rows, then the Vol/dt diagonal
    res = torch.where(wall_mask, 0.0, torch.stack([res0, res1]))
    dd = torch.where(wall_mask, 1.0, torch.stack([d00, d11]))
    ok = dt > EPS
    delta = torch.where(ok, vol / (cfl_red * torch.where(ok, dt, 1.0)), 0.0)
    return res, dd + delta, torch.stack(sel)


def sst_assemble(mesh, consts, q, rho, vel, gq, mu, mut, dist, strain,
                 diverg, dt, wall_mask, f1, f2, cdkw):
    """The fused assembly, assemble_plain's contract: K12 on CUDA tensors
    (one launch), the plain version on CPU tensors."""
    if q.is_cuda:
        from su2_tpu_torch import kernels
        fields = dict(q=q, rho=rho, vel=vel, gq=gq, mu=mu, mut=mut,
                      dist=dist, strain=strain, diverg=diverg,
                      vol=mesh.volume, dt=dt, f1=f1, f2=f2, cdkw=cdkw,
                      coords=mesh.coords)
        return kernels.sst_assemble(consts, mesh.stencil_offsets, fields,
                                    wall_mask, mesh.gg_snormal,
                                    mesh.stencil_pvec)
    return assemble_plain(mesh, consts, q, rho, vel, gq, mu, mut, dist,
                          strain, diverg, dt, wall_mask, f1, f2, cdkw)
