"""Randomized column sampling (the paper's I_j matrices).

I_j in R^{n x m} has one nonzero per column: X I_j selects m columns of X
uniformly at random. I_j is never built; indices are drawn and gathered. The
batch variant draws k independent index sets at once — the independence that
makes the k-step unrolling possible (paper §IV-B). Draws come from an
explicit ``torch.Generator`` on the target device; indices are int64.
"""
from __future__ import annotations

import torch


def sample_indices(gen: torch.Generator, n: int, m: int,
                   with_replacement: bool = True) -> torch.Tensor:
    """Indices of m columns drawn uniformly from [0, n), on ``gen``'s
    device."""
    if with_replacement:
        return torch.randint(0, n, (m,), generator=gen, device=gen.device)
    return torch.randperm(n, generator=gen, device=gen.device)[:m]


def sample_index_batch(gen: torch.Generator, k: int, n: int, m: int,
                       with_replacement: bool = True) -> torch.Tensor:
    """(k, m) independent index sets — one per unrolled iteration."""
    if with_replacement:
        return torch.randint(0, n, (k, m), generator=gen, device=gen.device)
    return torch.stack([sample_indices(gen, n, m, False) for _ in range(k)])


def gather_columns(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The columns idx (k, m) of A (r, n) as one contiguous (k, r, m)
    tensor: a single gather, A and the index broadcast as views, nothing of
    size k*r*m besides the result."""
    k, m = idx.shape
    r, n = A.shape
    return torch.gather(A.unsqueeze(0).expand(k, r, n), 2,
                        idx.unsqueeze(1).expand(k, r, m))


def sample_columns(X: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """Gather sampled columns: Xs = X I_j, ys = I_j^T y.

    idx (m,) gives Xs (d, m), ys (m,); a batch idx (k, m) gives one
    contiguous Xs (k, d, m) (:func:`gather_columns`) and ys (k, m).
    """
    if idx.dim() == 1:
        return X.index_select(1, idx), y.index_select(0, idx)
    return gather_columns(X, idx), y[idx]
