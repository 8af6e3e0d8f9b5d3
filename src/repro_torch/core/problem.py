"""The Lasso problem and the solver configuration shared by the s-step
solvers.

  LassoProblem   f = (1/2n)||X^T w - y||^2     g = lam ||w||_1

X is (d, n): rows are features, columns are samples (the paper's
convention, n >> d). The problem carries the smooth/prox split the s-step
core (``repro_torch.core.sstep``) consumes: ``prox_params()``, sampled and
full-batch Gram statistics, the objective and the default 1/L step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LassoProblem:
    """The LASSO problem instance. X: (d, n) features x samples; y: (n,)."""
    X: torch.Tensor
    y: torch.Tensor
    lam: float = 0.1

    @property
    def d(self) -> int:
        return self.X.shape[0]

    @property
    def n(self) -> int:
        return self.X.shape[1]

    @property
    def dim(self) -> int:
        """Size of the iterate w."""
        return self.d

    @property
    def n_units(self) -> int:
        """Number of sampleable units (columns) for the Gram estimator."""
        return self.n

    @property
    def device(self) -> torch.device:
        return self.X.device

    def prox_params(self) -> Tuple[str, float, float, float, float]:
        return ("l1", self.lam, 0.0, 0.0, 0.0)

    @functools.cached_property
    def Xy(self) -> torch.Tensor:
        """[X; y] (d+1, n), built once: the sampled G and R of a draw are
        blocks of one Gram matrix of its columns (``core.gram``)."""
        from repro_torch.core.gram import augment
        return augment(self.X, self.y)

    @functools.cached_property
    def Xy_rows(self) -> torch.Tensor:
        """[X; y] sample-major (n, r_pad), built once by one transpose on
        first use: row i is sample i's d features and its y, zero-padded to
        a 16-byte pitch (r_pad = 56 for covtype, 20 for susy). The
        ``gram_gather`` kernel reads a draw's rows from it in place."""
        from repro_torch.core.gram import augment_rows
        return augment_rows(self.X, self.y)

    def block_stats(self, idx_block: torch.Tensor):
        """(G, R) of shapes (k, d, d), (k, d) for k draws idx_block (k, m):
        the batched counterpart of the JAX package's
        ``vmap(problem.gram_stats)``, one ``gram_gather`` dispatch."""
        from repro_torch.core.gram import augmented_gram_blocks
        return augmented_gram_blocks(self.Xy_rows, self.d, idx_block)

    def full_stats(self):
        """Full-batch (G, R): the gradient of f is G w - R."""
        return self.X @ self.X.T / self.n, self.X @ self.y / self.n

    def default_step(self, cfg: "SolverConfig") -> torch.Tensor:
        return lipschitz_step(self.X, cfg.power_iters)

    def smooth_objective(self, w: torch.Tensor) -> torch.Tensor:
        r = self.X.T @ w - self.y
        return 0.5 / self.n * torch.dot(r, r)

    def objective(self, w: torch.Tensor) -> torch.Tensor:
        return self.smooth_objective(w) + self.lam * torch.sum(torch.abs(w))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver hyper-parameters shared by all s-step algorithms.

    Attributes:
      T: total outer iterations (classical) / total effective iterations (CA).
      k: communication-avoiding step parameter; collectives fire every k
        iterations. T must be a multiple of k and k >= 1 — validated here at
        construction and (solver-named) in the s-step core. Classical solvers
        ignore k.
      b: sampling rate in (0, 1]; m = floor(b*n) columns drawn per iteration.
      Q: inner first-order iterations for the proximal-Newton subproblem.
      step_size: fixed step t; if None, 1/L via power iteration (computed
        once, outside the iteration loop).
      sigma: PDHG dual step (kept for field parity with the JAX package; the
        PDHG solvers are not ported yet).
      with_replacement: the paper's I_j samples columns with replacement.
      power_iters: power-iteration steps for the default step size.
    """
    T: int = 128
    k: int = 8
    b: float = 0.1
    Q: int = 5
    step_size: Optional[float] = None
    sigma: Optional[float] = None
    with_replacement: bool = True
    power_iters: int = 50

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"cfg.k must be >= 1, got k={self.k}")
        if self.T % self.k != 0:
            raise ValueError(
                f"T={self.T} must be a multiple of k={self.k} (the k-step "
                f"schedule runs T/k outer iterations of k updates each)")
        if not (0.0 < self.b <= 1.0):
            raise ValueError(f"sampling rate b={self.b} must be in (0, 1]")


def lasso_objective(problem, w: torch.Tensor) -> torch.Tensor:
    """Full-batch objective F(w)."""
    return problem.objective(w)


def lipschitz_step(X: torch.Tensor, iters: int = 100,
                   safety: float = 1.05) -> torch.Tensor:
    """t = 1/(safety*L), L = eigmax((1/n) X X^T) by power iteration, as a
    0-dim tensor on X's device (nothing is read back to the host).

    The start vector is drawn from seed 0 on X's device, so t differs from
    the JAX package's in the last digits unless the power iteration has
    converged; the parity tests hand both the same t."""
    d, n = X.shape
    G = (X @ X.T) / n
    generator = torch.Generator(device=X.device).manual_seed(0)
    v = torch.randn(d, generator=generator, device=X.device, dtype=G.dtype)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        v = G @ v
        v = v / torch.linalg.norm(v)
    L = torch.dot(v, G @ v)
    return 1.0 / (safety * L)
