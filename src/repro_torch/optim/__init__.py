"""Optimizer of the port: AdamW with float32 masters and the cosine
schedule. The multi-process CA solvers (``repro.optim.ca_sync``) and
gradient compression come with ``torch.distributed`` (ROADMAP)."""
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule"]
