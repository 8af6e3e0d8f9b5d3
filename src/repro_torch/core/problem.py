"""Composite convex problems min_w f(w) + g(w) and the solver
configuration shared by the s-step solvers.

Every problem carries the smooth/prox split the s-step core
(``repro_torch.core.sstep``) consumes:

* ``dim`` / ``n_units`` — iterate size and the number of sampleable units
  the stochastic Gram estimator draws from (columns for the primal
  problems, features for the dual SVM);
* ``prox_params()`` — the element-wise prox of g, ``(variant, lam, mu, lo,
  hi)``, which the prox kernels take as their variant and scalars;
* ``block_stats(idx_block)`` / ``full_stats()`` — the sampled Gram pairs
  (G_j, R_j) of a k-block of draws and the full-batch pair, the only way
  the gram-schedule iterations touch the data;
* ``coord_view()`` — the block-coordinate factorization BCD uses;
* ``objective`` / ``default_step`` — the full-batch objective and 1/L step.

Problems:

  LassoProblem       f = (1/2n)||X^T w - y||^2   g = lam ||w||_1
  ElasticNetProblem  f = (1/2n)||X^T w - y||^2   g = lam||w||_1 + (mu/2)||w||^2
  DualSVMProblem     f = (1/2d) a^T Z^T Z a - (1/d) 1^T a
                                                 g = 1_{[0, C]}(a)

X is (d, n): rows are features, columns are samples (the paper's
convention, n >> d). The dual SVM iterates over a (n,) with Z = X * y
(label-signed features); its smooth part is the SVM dual scaled by 1/d, so
that sampling features gives an unbiased Gram estimate with the same 1/m
normalization the primal problems use.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch


class CoordView(NamedTuple):
    """Block-coordinate factorization consumed by the BCD solvers.

    The smooth gradient restricted to a coordinate block U is

        grad_U = inv_rho * (B[U] @ v - lin[U]),   v = B^T w - offset,

    and the auxiliary residual v is kept incrementally: ``v += B[U]^T
    delta`` after the block update. B's rows are coordinates of the
    iterate; its columns (and v) lie on the data axis, so in the
    distributed form B[U] @ v and B[U] @ B[U]^T reduce over the sharded
    axis: the one collective per (outer) iteration.
    """
    B: torch.Tensor         # (dim, n_aux)
    offset: torch.Tensor    # (n_aux,): v = B^T w - offset
    lin: torch.Tensor       # (dim,) linear term of the gradient
    inv_rho: float          # gradient normalization (1/n primal, 1/d dual)


class _CompositeProblem:
    """What the problem dataclasses below share."""

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
        """Number of sampleable units for the stochastic Gram estimator."""
        return self.n

    @property
    def device(self) -> torch.device:
        return self.X.device

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

    def block_stats(self, idx_block: torch.Tensor, m_norm=None, out=None):
        """(G, R) of shapes (k, d, d), (k, d) for k draws idx_block (k, m):
        the batched counterpart of the JAX package's
        ``vmap(problem.gram_stats)``, one ``gram_gather`` dispatch.
        ``m_norm`` (default m): the normalization, the global sample count
        in a distributed solve; ``out``: a flat float32 buffer of k (d^2 +
        d) that G and R are written into, G first (what one all-reduce
        takes)."""
        from repro_torch.core.gram import augmented_gram_blocks
        return augmented_gram_blocks(self.Xy_rows, self.d, idx_block,
                                     m_norm=m_norm, out=out)

    def full_stats(self):
        """Full-batch (G, R): the gradient of f is G w - R."""
        return self.X @ self.X.T / self.n, self.X @ self.y / self.n

    def coord_view(self) -> CoordView:
        return CoordView(B=self.X, offset=self.y,
                         lin=torch.zeros(self.d, dtype=self.X.dtype,
                                         device=self.device),
                         inv_rho=1.0 / self.n)

    def default_step(self, cfg: "SolverConfig") -> torch.Tensor:
        return lipschitz_step(self.X, cfg.power_iters)

    def smooth_objective(self, w: torch.Tensor) -> torch.Tensor:
        r = self.X.T @ w - self.y
        return 0.5 / self.n * torch.dot(r, r)


@dataclasses.dataclass(frozen=True)
class LassoProblem(_CompositeProblem):
    """The LASSO problem instance. X: (d, n) features x samples; y: (n,)."""
    X: torch.Tensor
    y: torch.Tensor
    lam: float = 0.1

    def prox_params(self) -> Tuple[str, float, float, float, float]:
        return ("l1", self.lam, 0.0, 0.0, 0.0)

    def objective(self, w: torch.Tensor) -> torch.Tensor:
        return self.smooth_objective(w) + self.lam * torch.sum(torch.abs(w))


@dataclasses.dataclass(frozen=True)
class ElasticNetProblem(_CompositeProblem):
    """Elastic net: LASSO's smooth part, g = lam||w||_1 + (mu/2)||w||^2.

    The same Gram statistics and Lipschitz constant as LASSO (the quadratic
    penalty rides in the prox: S_{lam t}(x) / (1 + mu t)), so every s-step
    solver runs unchanged with only the prox variant swapped.
    """
    X: torch.Tensor
    y: torch.Tensor
    lam: float = 0.1
    mu: float = 0.05

    def prox_params(self) -> Tuple[str, float, float, float, float]:
        return ("elastic_net", self.lam, self.mu, 0.0, 0.0)

    def objective(self, w: torch.Tensor) -> torch.Tensor:
        return (self.smooth_objective(w) + self.lam * torch.sum(torch.abs(w))
                + 0.5 * self.mu * torch.dot(w, w))


@dataclasses.dataclass(frozen=True)
class DualSVMProblem(_CompositeProblem):
    """Soft-margin SVM dual (the CoCoA-style dual framing of 1512.04011).

    X: (d, n) features x samples; y: (n,) labels in {-1, +1}; the box
    constraint 0 <= a_i <= C. With Z = X * y the (1/d)-scaled dual
    objective is

        f(a) = (1/2d) ||Z a||^2 - (1/d) 1^T a,    g = indicator of [0, C]^n,

    so grad f = G a - R with G = (1/d) Z^T Z and R = (1/d) 1. The estimator
    samples FEATURES (rows of Z): G_j = (1/m) Z_S^T Z_S is unbiased for G,
    and R is deterministic. The prox runs at d = n, the sample count.
    """
    X: torch.Tensor
    y: torch.Tensor
    C: float = 1.0

    @functools.cached_property
    def Z(self) -> torch.Tensor:
        return self.X * self.y[None, :]

    @functools.cached_property
    def Zt(self) -> torch.Tensor:
        """Z^T (n, d), contiguous: a draw of features is a gather of its
        columns."""
        return self.Z.T.contiguous()

    @property
    def dim(self) -> int:
        return self.n            # dual iterate: one multiplier per sample

    @property
    def n_units(self) -> int:
        return self.d            # the Gram estimator samples features

    def prox_params(self) -> Tuple[str, float, float, float, float]:
        return ("box", 0.0, 0.0, 0.0, self.C)

    def block_stats(self, idx_block: torch.Tensor, m_norm=None):
        """G (k, n, n) = (1/m) Z_S^T Z_S of each draw of features and R
        (k, n) = 1/d: the sampled columns of Z^T gathered into one (k, n, m)
        copy, as the JAX package takes them (``jnp.take``) outside its
        kernel, then one ``gram`` dispatch."""
        from repro_torch.core.sampling import gather_columns
        from repro_torch.kernels import registry
        k, m = idx_block.shape
        Bs = gather_columns(self.Zt, idx_block)          # (k, n, m)
        m = m if m_norm is None else m_norm
        G = registry.dispatch("gram", Bs) * (1.0 / m)
        R = torch.full((k, self.n), 1.0 / self.d, dtype=self.X.dtype,
                       device=self.device)
        return G, R

    def full_stats(self):
        Z = self.Z
        return Z.T @ Z / self.d, torch.full((self.n,), 1.0 / self.d,
                                            dtype=self.X.dtype,
                                            device=self.device)

    def coord_view(self) -> CoordView:
        return CoordView(B=self.Zt, offset=torch.zeros(
            self.d, dtype=self.X.dtype, device=self.device),
            lin=torch.ones(self.n, dtype=self.X.dtype, device=self.device),
            inv_rho=1.0 / self.d)

    def default_step(self, cfg: "SolverConfig") -> torch.Tensor:
        # lipschitz_step(Z) targets eigmax(Z Z^T)/n; f's Hessian is
        # (1/d) Z^T Z with the same top eigenvalue scaled by n/d
        return lipschitz_step(self.Z, cfg.power_iters) * (self.d / self.n)

    def smooth_objective(self, a: torch.Tensor) -> torch.Tensor:
        v = self.Z @ a
        return 0.5 / self.d * torch.dot(v, v) - torch.sum(a) / self.d

    def objective(self, a: torch.Tensor) -> torch.Tensor:
        return self.smooth_objective(a)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver hyper-parameters shared by all s-step algorithms.

    Attributes:
      T: total outer iterations (classical) / total effective iterations (CA).
      k: communication-avoiding step parameter; collectives fire every k
        iterations. T must be a multiple of k and k >= 1 — validated here at
        construction and (solver-named) in the s-step core. Classical solvers
        ignore k.
      b: sampling rate in (0, 1]; m = floor(b*units) units drawn per
        iteration (columns for the gram-schedule solvers, coordinates for
        BCD).
      Q: inner first-order iterations for the proximal-Newton subproblem.
      step_size: fixed step t; if None, 1/L via power iteration (computed
        once, outside the iteration loop).
      sigma: PDHG dual step; if None, 0.5/t (sigma = 1/t makes PDHG collapse
        to plain proximal gradient, the tests' oracle).
      with_replacement: the paper's I_j samples columns with replacement.
        BCD always draws each coordinate block without replacement (a
        repeated coordinate inside one draw would double-apply its update).
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
