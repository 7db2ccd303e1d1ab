"""Batched inverses of small dense blocks (torch)."""

from __future__ import annotations

import torch


def gauss_inv_t(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (B, n, n) blocks by pivot-free Gauss-Jordan, the
    batch axis innermost (same arithmetic order as the JAX package's
    gauss_inv_t)."""
    bsz, n = a.shape[0], a.shape[-1]
    at = a.reshape(bsz, n * n).T
    one = torch.ones((bsz,), dtype=a.dtype, device=a.device)
    zero = torch.zeros((bsz,), dtype=a.dtype, device=a.device)
    aug = [[at[i * n + j] for j in range(n)]
           + [one if i == j else zero for j in range(n)]
           for i in range(n)]
    for col in range(n):
        pivval = aug[col][col]
        safe = torch.where(pivval == 0.0, 1.0, pivval)
        prow = [aug[col][j] / safe for j in range(2 * n)]
        for i in range(n):
            if i == col:
                continue
            f = aug[i][col]
            aug[i] = [aug[i][j] - f * prow[j] for j in range(2 * n)]
        aug[col] = prow
    inv_t = torch.stack([aug[i][n + j] for i in range(n) for j in range(n)])
    return inv_t.T.reshape(bsz, n, n)
