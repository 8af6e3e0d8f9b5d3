"""Models of the port, all six families (dense, moe, ssm, hybrid, audio,
vlm): ``init_params``, ``forward``, ``loss_fn``, ``init_cache``,
``decode_step``, ``prefill_audio_cache`` (whisper), and
``params_from_numpy``, ``train_state_from_numpy`` and
``shard_state_from_numpy`` to carry the JAX package's weights and training
state across (the last as one rank's shard)."""
from repro_torch.models.convert import (params_from_numpy,
                                      shard_state_from_numpy,
                                      train_state_from_numpy)
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params, loss_fn, param_count,
                                            prefill_audio_cache)

__all__ = ["init_params", "param_count", "forward", "loss_fn", "init_cache",
           "decode_step", "prefill_audio_cache", "params_from_numpy",
           "train_state_from_numpy", "shard_state_from_numpy"]
