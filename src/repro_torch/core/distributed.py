"""Distributed solvers on torch.distributed (paper Algorithm V).

Data layout (paper §III): X (d, n) is partitioned column-wise over the ranks
of a process group (each holds n/P samples, :func:`shard_problem`); y
likewise; the iterates w, v are replicated. The gram-schedule solvers draw
from each rank's own columns (paper §IV-B: "randomly selecting b.n
different subset of the columns by each processor"), from a generator
seeded from (seed, rank); BCD's coordinate draws are shared by every rank
(the coordinates of the replicated iterate are not data-parallel: a rank
folded into the seed would update other coordinates and diverge).

The only communication is one ``all_reduce`` of one contiguous buffer per
block, holding the block's local statistics (``sstep.run``'s ``reduce``):
  - classical gram: (d^2 + d) words          per iteration    -> T all-reduces
  - CA gram:        k (d^2 + d) words        per k iterations -> T/k
  - classical BCD:  (m_c^2 + m_c) words      per iteration    -> T
  - CA BCD:         ((k m_c)^2 + k m_c)      per k iterations -> T/k
The gram family moves the same words either way, T (d^2 + d): Table I of
the paper. CA-BCD trades a factor-k inflation of its (small) cross-Gram's
words for the factor-k fewer messages (1612.04003 §3). A
:class:`CollectiveCount` handed to the solver counts both.

All eight solve the LASSO/l1 framing (this module's (X, y, lam) API); the
dual SVM is not data-parallel in this layout (its iterate lies on the sample
axis) and is not supported here, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import sstep
from repro_torch.core.problem import LassoProblem, SolverConfig
from repro_torch.kernels import registry

GRAM_ALGORITHMS = ("sfista", "spnm", "pdhg", "ca_sfista", "ca_spnm",
                   "ca_pdhg")
COORD_ALGORITHMS = ("bcd", "ca_bcd")
ALGORITHMS = GRAM_ALGORITHMS + COORD_ALGORITHMS
_RULES = {"sfista": sstep.FISTA_RULE, "spnm": sstep.PNM_RULE,
          "pdhg": sstep.PDHG_RULE, "bcd": sstep.BCD_RULE}


@dataclasses.dataclass
class CollectiveCount:
    """What a distributed solve or train step communicated: its collectives
    by kind and the words they moved (each rank's buffer size: the input of
    an all-reduce or a reduce-scatter, the output of an all-gather)."""
    all_reduces: int = 0
    words: int = 0
    all_gathers: int = 0
    reduce_scatters: int = 0


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own draws in the gram family."""
    return int(seed) * 1_000_003 + int(rank)


def make_distributed_solver(algorithm: str, cfg: SolverConfig, lam: float,
                            *, group=None,
                            counter: Optional[CollectiveCount] = None
                            ) -> Callable:
    """Build a distributed solver for one rank of ``group`` (default: the
    default process group).

    algorithm: one of 'sfista' | 'spnm' | 'pdhg' | 'bcd' or its 'ca_'-
    prefixed k-step form. Returns ``solve(X_local, y_local, w0, t, *,
    gen=None, idx=None)`` on this rank's shard (:func:`shard_problem`),
    w0 and the step t replicated; it returns the replicated w_T. The draws
    come from ``idx`` when given: (T, m_local) this rank's own for the gram
    family, (T, m_c) shared for BCD; else from ``gen``, an int seed (the
    gram family seeds rank r's generator from (seed, r), BCD every rank's
    from seed) or a ``torch.Generator`` taken as it is. Every all-reduce is
    counted in ``counter``. The backend policy is resolved once a solve and
    pinned for it.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"expected one of {ALGORITHMS}")
    ca = algorithm.startswith("ca_")
    rule = _RULES[algorithm.removeprefix("ca_")]
    if ca:
        sstep.validate_schedule(cfg, algorithm)
    block = cfg.k if ca else 1

    def reduce(buf: torch.Tensor) -> None:
        # THE collective: one all-reduce of one contiguous buffer a block
        dist.all_reduce(buf, group=group)
        if counter is not None:
            counter.all_reduces += 1
            counter.words += buf.numel()

    def solve(X_local, y_local, w0, t, *, gen=None, idx=None):
        world = dist.get_world_size(group)
        problem = LassoProblem(X=X_local, y=y_local, lam=lam)
        t = torch.as_tensor(t, dtype=X_local.dtype, device=problem.device)
        with registry.use(registry.resolved_backend(problem.device)):
            if rule.schedule == "coord":
                draws = sstep.draws(problem, cfg, gen, idx, "coord")
                return sstep.run(problem, cfg, rule, draws, block, t, w0,
                                 reduce=reduce,
                                 inv_rho=1.0 / (problem.n * world))
            if idx is None and isinstance(gen, int):
                gen = rank_seed(gen, dist.get_rank(group))
            draws = sstep.draws(problem, cfg, gen, idx)
            # the union of the ranks' draws: the global normalization
            return sstep.run(problem, cfg, rule, draws, block, t, w0,
                             reduce=reduce, m_norm=draws.shape[1] * world)

    return solve


def shard_problem(X: torch.Tensor, y: torch.Tensor, rank: int, world: int):
    """Rank ``rank``'s column block (X_local (d, n/P), y_local (n/P,)) of
    (X, y) over ``world`` ranks. The sample count is trimmed to a multiple
    of ``world`` (dropping < P samples, the usual distributed-data
    convention, as the JAX package's sharding needs)."""
    n_local = X.shape[1] // world
    cols = slice(rank * n_local, (rank + 1) * n_local)
    return X[:, cols].contiguous(), y[cols].contiguous()
