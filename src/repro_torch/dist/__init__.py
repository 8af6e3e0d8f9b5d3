"""Distribution helpers of the port: so far the ``DeadlineGate`` the serve
scheduler sheds load with."""
from repro_torch.dist.fault_tolerance import DeadlineGate

__all__ = ["DeadlineGate"]
