"""Batched inverses of small dense blocks (torch)."""

from __future__ import annotations

import torch


def gauss_inv_t(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (B, n, n) blocks by pivot-free Gauss-Jordan, the
    batch axis innermost (same arithmetic order as the JAX package's
    gauss_inv_t): one elimination step per column over the whole (n, 2n, B)
    augmented system."""
    bsz, n = a.shape[0], a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    aug = torch.cat([a.permute(1, 2, 0),
                     eye[:, :, None].expand(n, n, bsz)], dim=1)
    rows = torch.arange(n, device=a.device)[:, None, None]
    for col in range(n):
        pivval = aug[col, col]
        safe = torch.where(pivval == 0.0, 1.0, pivval)
        prow = aug[col] / safe                           # (2n, B)
        f = aug[:, col][:, None]                         # (n, 1, B)
        aug = torch.where(rows == col, prow[None], aug - f * prow[None])
    return aug[:, n:].permute(2, 0, 1).contiguous()
