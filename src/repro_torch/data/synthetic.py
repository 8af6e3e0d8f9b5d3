"""Synthetic Lasso problems shaped like the paper's datasets (abalone /
covtype / susy, Table II), so every run works offline.

Data is drawn with a ``torch.Generator`` on the target device, in bulk; the
JAX package draws the same shapes with ``jax.random``, so the numbers
differ. The parity tests hand the JAX problem to the port instead.
"""
from __future__ import annotations

import math
import zlib
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.problem import LassoProblem

#: name -> (d features, n samples, lambda) mirroring the paper's datasets.
#: Sizes are scaled for CPU CI; the generator accepts overrides for full size.
PAPER_DATASETS = {
    "abalone": dict(d=8, n=4177, lam=0.1),
    "covtype": dict(d=54, n=58_101, lam=0.01),   # 1/10 covtype rows for CI
    "susy": dict(d=18, n=100_000, lam=0.01),     # subsampled susy for CI
}


def make_lasso_data(seed: int, d: int, n: int,
                    sparsity: float = 0.25, noise: float = 0.01,
                    lam_frac: float = 0.1, dtype=torch.float32, device=None):
    """X (d, n) with unit-variance columns, y = X^T w* + noise, w* sparse.
    Returns (problem, w*).

    lambda is lam_frac * lambda_max, where lambda_max = ||X y / n||_inf is
    the smallest lambda with an all-zero solution — a nontrivial sparse
    optimum for any data scaling. ``device`` defaults to the card (see
    :func:`repro_torch.resolve_device`); reading lambda back to the host is
    the one wait of the set-up.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    X = torch.randn(d, n, generator=gen, device=dev, dtype=dtype) \
        / math.sqrt(d)
    w_star = torch.randn(d, generator=gen, device=dev, dtype=dtype)
    mask = torch.rand(d, generator=gen, device=dev) < sparsity
    w_star = torch.where(mask, w_star, torch.zeros_like(w_star))
    y = X.T @ w_star + noise * torch.randn(n, generator=gen, device=dev,
                                           dtype=dtype)
    lam = float(lam_frac * torch.max(torch.abs(X @ y / n)))
    return LassoProblem(X=X, y=y, lam=lam), w_star


def make_dataset_like(name: str, seed: Optional[int] = None,
                      scale: float = 1.0, device=None):
    """A synthetic problem with the shape of a paper dataset; ``scale`` 10
    gives covtype's full 581,010 rows, 50 susy's 5,000,000."""
    spec = PAPER_DATASETS[name]
    if seed is None:
        # stable digest, not hash(): str hashing is salted per process
        seed = zlib.adler32(name.encode()) & 0x7FFFFFFF
    n = max(int(spec["n"] * scale), 64)
    # a data-dependent lambda (fraction of lambda_max) plays the role of the
    # paper's per-dataset tuned lambda
    return make_lasso_data(seed, spec["d"], n, device=device)
