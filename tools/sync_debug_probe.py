"""Which torch calls the CUDA runtime's sync-debug check reports, and which
of them ``repro_torch.obs.sync_audit`` counts.

  python tools/sync_debug_probe.py

Each case runs once to warm up, then once inside an audit of the card
(which sets ``torch.cuda.set_sync_debug_mode("warn")`` for its duration),
after one ``mark_dispatch``. Per case it prints the audit's counted reads
(``transfers``), its round trips (``syncs``), the runtime's warnings
(``runtime``) and those raised outside a counted read (``uncounted``), then
the sync-debug mode left behind (the one found: 0). It needs a CUDA card and
imports no JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.obs.sync_audit import block_until_ready  # noqa: E402


def _event_sync():
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("sync_debug_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    x = torch.arange(1024, dtype=torch.float32, device=dev) - 3
    host = np.arange(1024, dtype=np.int64)
    cases = {
        "torch.cuda.synchronize": lambda: torch.cuda.synchronize(),
        "block_until_ready": lambda: block_until_ready(dev),
        "Stream.synchronize":
            lambda: torch.cuda.current_stream().synchronize(),
        "Event.synchronize": _event_sync,
        ".cpu()": lambda: x.cpu(),
        ".to('cpu')": lambda: x.to("cpu"),
        ".to('cpu', non_blocking=True)":
            lambda: x.to("cpu", non_blocking=True),
        ".item()": lambda: x[0].item(),
        ".tolist()": lambda: x[:4].tolist(),
        "float()": lambda: float(x[0]),
        "int()": lambda: int(x[0]),
        "bool()": lambda: bool(x[0] > 0),
        "np.asarray(.cpu())": lambda: np.asarray(x.cpu()),
        "nonzero": lambda: torch.nonzero(x),
        "mask index": lambda: x[x > 0],
        "H2D pageable .to(cuda)": lambda: torch.from_numpy(host).to(dev),
        "H2D torch.tensor(list, device)":
            lambda: torch.tensor([1, 2, 3], device=dev),
        "H2D pinned non_blocking":
            lambda: torch.from_numpy(host).pin_memory().to(
                dev, non_blocking=True),
        "copy_ to host": lambda: torch.empty(1024).copy_(x),
    }
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        with obs.sync_audit(dev) as a:
            obs.mark_dispatch()
            fn()
        print(f"  {name:34s} transfers={a.transfers} syncs={a.syncs} "
              f"runtime={a.runtime_syncs} uncounted={a.runtime_uncounted}")
    print("sync-debug mode after:", torch.cuda.get_sync_debug_mode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
