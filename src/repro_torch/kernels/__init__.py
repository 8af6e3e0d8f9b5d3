"""The port's kernels: each op has a hand-written Hopper kernel (backend
``cuda``, sources in ``repro_torch/csrc``) and its plain PyTorch version
(backend ``torch``, the ``ref.py`` beside it).

  gram/             ``gram``, ``gram_gather``     csrc/gram.cu
  prox_step/        ``prox_step_block``,          csrc/prox_step.cu
                    ``prox_loop_block``, and
                    their k = 1 instances
                    ``prox_step``, ``prox_loop``;
                    ``pdhg_block``; for large d
                    all of them take the rows
                    route (kernel ``prox_rows``)
  flash_attention/  ``flash_attention``,          csrc/flash_attention.cu
                    ``flash_dq``, ``flash_dkv``,
                    ``paged_attention`` (kernel ``paged_decode``)
  ssd/              ``ssd``, ``ssd_bwd``          csrc/ssd.cu

  registry.py  the op table, backend policy and dispatch counts
  _build.py    nvcc at first use into ``build/repro_torch/``, ctypes binding

Each CUDA wrapper carries a plain-integer ``launches`` count that it bumps
once per kernel launch and nowhere else; :func:`launch_counts` reads them.
A wrapper with more than one body (``ssd``, ``ssd_bwd``) also counts each
body's launches (``launches_bf16``, ``launches_f32``), which
:func:`body_launch_counts` reads.
"""
from typing import Dict

from repro_torch.kernels import registry


def _cuda_wrappers():
    registry.ensure_loaded()
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"gram": gram_ops.gram_cuda,
            "gram_gather": gram_ops.gram_gather_cuda,
            "prox_step": prox_ops.prox_step_cuda,
            "prox_loop": prox_ops.prox_loop_cuda,
            "prox_step_block": prox_ops.prox_step_block_cuda,
            "prox_loop_block": prox_ops.prox_loop_block_cuda,
            "pdhg_block": prox_ops.pdhg_block_cuda,
            "prox_rows": prox_ops.prox_rows_cuda,
            "flash_attention": fa_ops.flash_attention_cuda,
            "paged_decode": fa_ops.paged_decode_cuda,
            "flash_dq": fa_ops.flash_dq_cuda,
            "flash_dkv": fa_ops.flash_dkv_cuda, "ssd": ssd_ops.ssd_cuda,
            "ssd_bwd": ssd_ops.ssd_bwd_cuda}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _cuda_wrappers().items()}


def body_launch_counts() -> Dict[str, int]:
    """Launches per op and body (``"ssd.launches_bf16"``, ...) since the
    last :func:`reset_launch_counts`, for the ops that have more than one
    body."""
    return {f"{name}.{attr}": getattr(fn, attr)
            for name, fn in _cuda_wrappers().items()
            for attr in ("launches_bf16", "launches_f32")
            if hasattr(fn, attr)}


def reset_launch_counts() -> None:
    for fn in _cuda_wrappers().values():
        fn.launches = 0
        for attr in ("launches_bf16", "launches_f32"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


__all__ = ["registry", "launch_counts", "body_launch_counts",
           "reset_launch_counts"]
