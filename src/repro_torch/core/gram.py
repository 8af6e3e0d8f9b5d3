"""Sampled Gram-matrix machinery.

G_j = (1/m) X I_j I_j^T X^T   (d x d),    R_j = (1/m) X I_j I_j^T y   (d,)

These are the only statistics through which the stochastic iteration
touches the data — the linchpin of the k-step reformulation: G/R for k
future iterations can be computed before any of the k updates run.

Both come from one rank-m product over the augmented data [X; y], whose
Gram matrix holds G as its top-left d x d block and R as the first d
entries of its last column. The solvers hold the augmented data
sample-major, Xy_rows (n, r_pad) with row i = [x_i, y_i] padded to a
16-byte pitch (``LassoProblem.Xy_rows``), and take a block's k pairs from
one ``gram_gather`` dispatch over it and the draws (the Hopper kernel for
CUDA tensors, which reads the sampled rows in place; its plain PyTorch
version on the CPU). The JAX package gathers the columns (``jnp.take``) and
takes R = Xs ys outside its kernel; here R comes from the same launch and
the same m-only summation order as G, so a draw's R, like its G, has the
same bits alone (classical) as in a block of k (CA).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry


def augment(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[X; y]: (d+1, n), y as the last row."""
    return torch.cat([X, y.unsqueeze(0)], 0)


def augment_rows(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[X; y] sample-major: (n, r_pad), row i = [X[:, i], y[i]] and zeros
    up to r_pad, d+1 rounded up to a multiple of 4 (16-byte rows)."""
    d, n = X.shape
    rows = torch.zeros(n, -(-(d + 1) // 4) * 4, dtype=X.dtype,
                       device=X.device)
    rows[:, :d] = X.T
    rows[:, d] = y
    return rows


def augmented_gram_blocks(Xy_rows: torch.Tensor, d: int,
                          idx_batch: torch.Tensor, m_norm=None, out=None):
    """G (k, d, d) and R (k, d) of k draws idx_batch (k, m) from the
    sample-major augmented data Xy_rows (:func:`augment_rows`): ONE
    ``gram_gather`` dispatch for the block, scaled by 1/m_norm.

    m_norm: the normalization, by default the draw size m. The distributed
    solvers pass the global sample count, so that the sum of the ranks'
    local pairs is the pair of the union of their draws. out: a flat
    float32 buffer of k (d^2 + d) that G and R are written into (G first),
    so that one all-reduce takes both."""
    m = idx_batch.shape[1] if m_norm is None else m_norm
    return registry.dispatch("gram_gather", Xy_rows, idx_batch, d + 1,
                             1.0 / m, out=out)


def gram_blocks(X: torch.Tensor, y: torch.Tensor, idx_batch: torch.Tensor,
                m_norm=None):
    """k independent Gram blocks at once: G (k, d, d), R (k, d).

    The paper's line 6 of Algorithm III. Builds the augmented rows on every
    call; solvers hold them once per problem (``LassoProblem.Xy_rows``) and
    call :func:`augmented_gram_blocks`.
    """
    return augmented_gram_blocks(augment_rows(X, y), X.shape[0], idx_batch,
                                 m_norm=m_norm)


def sampled_gram(X: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                 m_norm=None):
    """One (G_j, R_j) pair from one index draw idx (m,); m_norm as in
    :func:`augmented_gram_blocks`."""
    G, R = gram_blocks(X, y, idx.unsqueeze(0), m_norm=m_norm)
    return G[0], R[0]
