"""Convergence metrics: the paper's relative solution error (§V-A).

rel_err(w) = ||w - w_opt|| / ||w_opt||, with w_opt from a high-accuracy
deterministic full-batch run (standing in for TFOCS at tol 1e-8).
``composite_reference`` is plain FISTA on the problem's ``full_stats()``
with its own ``prox_params()`` element-wise prox. It is plain tensor code on
the problem's device, as the JAX package's is plain XLA: no kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.soft_threshold import fista_momentum, prox_elem


def composite_reference(problem, iters: int = 4000, step_size=None):
    """Deterministic full-batch FISTA (b=1, no sampling): the oracle every
    stochastic solver is scored against."""
    G, R = problem.full_stats()
    variant, lam, mu, lo, hi = problem.prox_params()
    if step_size is None:
        # 1/(1.05 * eigmax(G)) by power iteration, as lipschitz_step does
        gen = torch.Generator(device=G.device).manual_seed(0)
        v = torch.randn(G.shape[0], generator=gen, device=G.device,
                        dtype=G.dtype)
        v = v / torch.linalg.norm(v)
        for _ in range(100):
            v = G @ v
            v = v / torch.linalg.norm(v)
        t = 1.0 / (1.05 * torch.dot(v, G @ v))
    else:
        t = torch.tensor(step_size, dtype=G.dtype, device=G.device)
    w_prev = w = torch.zeros(G.shape[0], dtype=G.dtype, device=G.device)
    for j in range(1, iters + 1):
        z = w + fista_momentum(j) * (w - w_prev)
        w_prev, w = w, prox_elem(z - t * (G @ z - R), t, variant=variant,
                                 lam=lam, mu=mu, lo=lo, hi=hi)
    return w


def solve_reference(problem, iters: int = 4000):
    """High-accuracy solution w_opt (the TFOCS stand-in)."""
    return composite_reference(problem, iters=iters)


def relative_solution_error(w, w_opt):
    return torch.linalg.norm(w - w_opt) / torch.clamp_min(
        torch.linalg.norm(w_opt), 1e-30)
