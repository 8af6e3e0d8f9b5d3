"""Distribution helpers of the port: the ``DeadlineGate`` the serve
scheduler sheds load with, the fault-tolerant training runner, the
sharding rules (``sharding``: logical axes, JAX's FSDP/TP specs, the
mesh's process groups, and the specs applied to a training state by
``Layout``) and the elastic remesh (``elastic``)."""
from repro_torch.dist.elastic import largest_mesh_shape, remesh
from repro_torch.dist.fault_tolerance import (DeadlineGate, FailureSource,
                                              NodeFailure, TrainingRunner)
from repro_torch.dist.sharding import (Layout, Mesh, Rules, cache_specs,
                                       data_rules, fit_spec, make_rules,
                                       param_specs, shard_coords,
                                       shard_shape, shard_slice)

__all__ = ["DeadlineGate", "FailureSource", "NodeFailure", "TrainingRunner",
           "Mesh", "Rules", "cache_specs", "data_rules", "fit_spec",
           "make_rules", "param_specs", "largest_mesh_shape", "remesh",
           "Layout", "shard_coords", "shard_shape", "shard_slice"]
