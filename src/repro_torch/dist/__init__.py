"""Distribution helpers of the port: the ``DeadlineGate`` the serve
scheduler sheds load with, the fault-tolerant training runner, the
sharding rules (``sharding``: logical axes, FSDP/TP specs as shape logic,
the data-parallel group) and the elastic remesh (``elastic``)."""
from repro_torch.dist.elastic import largest_mesh_shape, remesh
from repro_torch.dist.fault_tolerance import (DeadlineGate, FailureSource,
                                              NodeFailure, TrainingRunner)
from repro_torch.dist.sharding import (Mesh, Rules, cache_specs, data_rules,
                                       fit_spec, make_rules, param_specs)

__all__ = ["DeadlineGate", "FailureSource", "NodeFailure", "TrainingRunner",
           "Mesh", "Rules", "cache_specs", "data_rules", "fit_spec",
           "make_rules", "param_specs", "largest_mesh_shape", "remesh"]
