"""Distribution helpers of the port: the ``DeadlineGate`` the serve
scheduler sheds load with, and the single-device fault-tolerant training
runner."""
from repro_torch.dist.fault_tolerance import (DeadlineGate, FailureSource,
                                              NodeFailure, TrainingRunner)

__all__ = ["DeadlineGate", "FailureSource", "NodeFailure", "TrainingRunner"]
