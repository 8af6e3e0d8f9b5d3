"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA Hopper card.

A second package beside ``repro``: the same paths, PyTorch idiom inside.
It imports ``torch`` and never ``jax`` or anything of ``repro``.

Subpackages ported so far:
  core        the paper's solvers on Lasso (SFISTA, CA-SFISTA, SPNM,
              CA-SPNM), the shared s-step schedule, the Comet cost model
  kernels     the op registry and the hand-written Hopper kernels
              (``gram``, ``gram_gather``, ``prox_step``, ``prox_loop``,
              ``prox_step_block``, ``prox_loop_block``,
              ``flash_attention``, ``flash_dq``, ``flash_dkv``,
              ``paged_decode``, ``ssd``, ``ssd_bwd``) beside their plain
              PyTorch versions
  configs     the ten architecture configs
  models      the six model families: init, forward, loss, decode, and
              the dense family's tensor parallelism (``models.tp``)
  serve       the continuous-batching engine over slot and paged caches
  optim       AdamW and the cosine schedule, the CA-sync solvers
              (local-SGD, stale-k), gradient compression
  checkpoint  async, atomic checkpoints
  dist        the serve scheduler's deadline gate, the training runner,
              the sharding rules and their layout of a training state,
              the elastic remesh
  data        the paper's Table II dataset stand-ins, the token stream
  obs         spans, metrics and the host<->device sync audit
  launch      ``python -m repro_torch.launch.{lasso_solve,
              distributed_lasso,serve,train,grad_smoke}``

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; with no card and no such request they raise.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and there is
    no card, rather than carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA card by default and this host has "
            "none (torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU")
    return dev


def to_device(a, device) -> torch.Tensor:
    """A host array or tensor as a tensor on ``device``, copied without
    blocking the host: on a card through a pinned snapshot (a copy from
    pageable memory waits for the stream, a host sync), so the host may
    reuse its buffer at once."""
    t = torch.as_tensor(a).clone(memory_format=torch.contiguous_format)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
