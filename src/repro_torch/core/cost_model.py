"""Alpha-beta-gamma cost model (paper §II-C, eq. 4, and Table I).

T = gamma * F + alpha * L + beta * W

A copy of the JAX package's model with the paper's Comet/MPI machine and,
where the JAX package has a TPU's, the H100's constants as measured on
four cards (``MachineParams.h100``); the launcher prints its predicted CA
speedup, as the JAX launcher does.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Machine constants for the alpha-beta model.

    gamma: seconds per flop; alpha: seconds per message; beta: seconds/word.
    """
    name: str
    gamma: float
    alpha: float
    beta: float

    @staticmethod
    def comet_like() -> "MachineParams":
        # Xeon E5-2680v3 node: ~0.5 TF/s/node sustained; IB FDR nominal
        # 1.2us, but effective MPI small-message latency incl. software
        # overhead and collective software stack is ~5us (matches the
        # latency-dominated behavior the paper measures on Comet).
        return MachineParams("comet", gamma=2.0e-12, alpha=5.0e-6, beta=1.4e-9)

    @staticmethod
    def h100() -> "MachineParams":
        # Four NVIDIA H100 80GB HBM3 (SXM) of one host at their 700 W
        # limit, joined by NVLink, measured by tools/machine_params.py
        # under torchrun (one process a card, NCCL). alpha and beta: an
        # eager dist.all_reduce of float32 words (the buffer the
        # distributed solvers reduce) from 1 to 2^26 words, fitted jointly
        # at worlds 2 and 4 as T_P(w) = log2(P) (alpha + beta w), the hops
        # CostModel counts; alpha is host-bound (one eager call's cost).
        # gamma: seconds per flop of the covtype CA block's gram_gather
        # (32, 55, 58,101) over the k d^2 m flops flops() counts for it.
        return MachineParams("h100", gamma=5.3001e-14, alpha=3.7003e-05,
                             beta=1.2217e-11)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Costs of T iterations on P processors (paper Table I).

    d: features; n: samples; b: sampling rate; k: CA step parameter;
    Q: inner iterations (PNM); eps-terms folded into Q.
    """
    d: int
    n: int
    b: float
    T: int
    k: int = 1
    Q: int = 1

    @property
    def _m_c(self) -> int:
        """BCD coordinate-block size (coordinates drawn per iteration)."""
        return max(int(self.b * self.d), 1)

    # --- Table I rows -----------------------------------------------------
    def flops(self, P: int, newton: bool = False, solver: str = "fista",
              ca: bool = False) -> float:
        if solver == "bcd":
            m_c = self._m_c
            # cross-Gram + block gradient against the sharded residual
            f = self.T * (m_c * m_c + m_c) * self.n / P
            if ca:
                # in-block gradient replay: C_j @ delta is m_c x (k m_c)
                f += self.T * self.k * m_c * m_c
            return f
        m = max(int(self.b * self.n), 1)
        f = self.T * self.d * self.d * m / P          # Gram: O(T d^2 b n / P)
        f += self.T * self.d * self.d                  # redundant grad/update
        if newton:
            f += self.T * self.Q * self.d * self.d     # O(T d^2 / eps)
        if solver == "pdhg":
            f += 4 * self.T * self.d                   # dual ascent + correction
        return f

    def words(self, P: int, solver: str = "fista", ca: bool = False) -> float:
        if solver == "bcd":
            # classical: T reductions of m_c^2 + m_c words; CA: T/k reductions
            # of (k m_c)^2 + k m_c — the factor-k word inflation CA-BCD trades
            # for its factor-k message reduction (1612.04003 Table 1).
            m_c = self._m_c
            if ca:
                km = self.k * m_c
                return (self.T / self.k) * (km * km + km) * max(math.log2(P), 1.0)
            return self.T * (m_c * m_c + m_c) * max(math.log2(P), 1.0)
        # All-reduce of d^2+d words, T times (classical) or T/k times of
        # k*(d^2+d) (CA): identical volume O(T d^2 log P).
        return self.T * (self.d * self.d + self.d) * max(math.log2(P), 1.0)

    def messages(self, P: int, ca: bool = False, solver: str = "fista") -> float:
        # identical for every solver in the family: one collective per
        # iteration, or per k iterations under the CA schedule
        rounds = self.T / self.k if ca else self.T
        return rounds * max(math.log2(P), 1.0)

    def memory(self, P: int, ca: bool = False, solver: str = "fista") -> float:
        base = self.d * self.n / P + 4 * self.d
        if solver == "bcd":
            km = (self.k if ca else 1) * self._m_c
            return base + self.n / P + km * km         # residual + block Gram
        return base + (self.k * self.d * self.d if ca else 0.0)

    # --- predicted runtime (eq. 4) ---------------------------------------
    def time(self, P: int, machine: MachineParams, ca: bool = False,
             newton: bool = False, solver: str = "fista") -> float:
        return (machine.gamma * self.flops(P, newton, solver=solver, ca=ca)
                + machine.alpha * self.messages(P, ca, solver=solver)
                + machine.beta * self.words(P, solver=solver, ca=ca))

    def speedup(self, P: int, machine: MachineParams, newton: bool = False,
                solver: str = "fista") -> float:
        """Predicted CA speedup over the classical algorithm at scale P."""
        classical = self.time(P, machine, ca=False, newton=newton, solver=solver)
        ca = self.time(P, machine, ca=True, newton=newton, solver=solver)
        return classical / ca
