"""Position bookkeeping for the modality front ends (the counterpart of
``repro.models.frontend``). The front ends themselves are stubs in the JAX
package too: callers provide frame and patch embeddings."""
from __future__ import annotations

from typing import Optional

import torch


def mrope_positions(n_patches: int, text_len: int, batch: int,
                    grid_w: Optional[int] = None, device=None):
    """Qwen2-VL M-RoPE (t, h, w) position streams for a [vision | text] seq.

    Vision patches: t=0, (h, w) from the patch grid. Text tokens: all three
    streams advance together starting after the vision span. Returns
    (3, B, n_patches + text_len) int32.
    """
    if grid_w is None:
        grid_w = max(int(n_patches ** 0.5), 1)
    p = torch.arange(n_patches, dtype=torch.int32, device=device)
    vis_t = torch.zeros_like(p)
    vis_h = p // grid_w
    vis_w = p % grid_w
    start = max((n_patches + grid_w - 1) // grid_w, grid_w)
    t = torch.arange(text_len, dtype=torch.int32, device=device) + start
    pos = torch.stack([
        torch.cat([vis_t, t]),
        torch.cat([vis_h, t]),
        torch.cat([vis_w, t]),
    ])                                                   # (3, S)
    return pos[:, None, :].expand(3, batch, pos.shape[-1])
