"""Models of the port (dense family): ``init_params``, ``forward``,
``init_cache``, ``decode_step``, and ``params_from_numpy`` to carry the
JAX package's weights across."""
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params, param_count)

__all__ = ["init_params", "param_count", "forward", "init_cache",
           "decode_step", "params_from_numpy"]
