"""Models of the port (the dense and ssm families): ``init_params``,
``forward``, ``loss_fn``, ``init_cache``, ``decode_step``, and
``params_from_numpy`` and ``train_state_from_numpy`` to carry the JAX
package's weights and training state across."""
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params, loss_fn, param_count)

__all__ = ["init_params", "param_count", "forward", "loss_fn", "init_cache",
           "decode_step", "params_from_numpy", "train_state_from_numpy"]
