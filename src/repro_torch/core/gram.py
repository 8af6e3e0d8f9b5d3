"""Sampled Gram-matrix machinery.

G_j = (1/m) X I_j I_j^T X^T   (d x d),    R_j = (1/m) X I_j I_j^T y   (d,)

These are the only statistics through which the stochastic iteration
touches the data — the linchpin of the k-step reformulation: G/R for k
future iterations can be computed before any of the k updates run.

Both come from one rank-m product through the kernel registry (op
``gram``: the Hopper kernel for CUDA tensors, its plain PyTorch version on
the CPU), taken over the augmented data [X; y] (d+1, n): the top-left
d x d block of its Gram matrix is G, the first d entries of its last column
are R. The JAX package takes R = Xs ys outside the kernel; here R comes from
the same launch and the same m-only summation order as G, so a draw's R,
like its G, has the same bits alone (classical) as in a block of k (CA).
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import gather_columns
from repro_torch.kernels.gram import ops as gram_ops


def augment(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[X; y]: (d+1, n), y as the last row."""
    return torch.cat([X, y.unsqueeze(0)], 0)


def augmented_gram_blocks(Xy: torch.Tensor, idx_batch: torch.Tensor):
    """G (k, d, d) and R (k, d) of k draws idx_batch (k, m) from the
    augmented data Xy = [X; y] (d+1, n): one gather into a contiguous
    (k, d+1, m) tensor and ONE ``gram`` dispatch for the block."""
    d = Xy.shape[0] - 1
    Ga = gram_ops.gram(gather_columns(Xy, idx_batch))
    Ga = Ga * (1.0 / idx_batch.shape[1])
    return Ga[:, :d, :d].contiguous(), Ga[:, :d, d].contiguous()


def gram_blocks(X: torch.Tensor, y: torch.Tensor, idx_batch: torch.Tensor):
    """k independent Gram blocks at once: G (k, d, d), R (k, d).

    The paper's line 6 of Algorithm III. Builds [X; y] on every call;
    solvers hold it once per problem (``LassoProblem.Xy``) and call
    :func:`augmented_gram_blocks`.
    """
    return augmented_gram_blocks(augment(X, y), idx_batch)


def sampled_gram(X: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """One (G_j, R_j) pair from one index draw idx (m,)."""
    G, R = gram_blocks(X, y, idx.unsqueeze(0))
    return G[0], R[0]
