"""Optimizer of the port: AdamW with float32 masters and the cosine
schedule; the CA-sync solvers on ``torch.distributed`` (``ca_sync``) and
gradient compression (``compression``), as in ``repro.optim``."""
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.optim.ca_sync import (StaleKSolver, ca_local_sgd_solver,
                                       ca_stale_k_solver)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule",
           "StaleKSolver", "ca_local_sgd_solver", "ca_stale_k_solver"]
