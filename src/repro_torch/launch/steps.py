"""The serve step builder (the counterpart of
``repro.launch.steps.make_serve_step``; ``make_train_step`` comes with
training)."""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.models import decode_step


def make_serve_step(cfg):
    """Returns serve_step(params, cache, tokens, positions=None,
    page_table=None) -> (next_tokens (B,1) int32, logits, cache).

    positions: optional (B,) per-slot decode depths (the continuous-batching
    engine); page_table: optional (B, pages_per_slot) int32 when the K/V
    leaves are a paged pool. The registry policy active when the step is
    built is pinned for every call (``auto`` still resolves by device).
    The next token is the greedy argmax; sampling comes with the rest of
    serving (ROADMAP queue 1 item 8)."""
    backend = registry.policy()

    def serve_step(params, cache, tokens, positions=None, page_table=None):
        with registry.use(backend):
            logits, cache = decode_step(params, cfg, cache, tokens,
                                        positions=positions,
                                        page_table=page_table)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step
