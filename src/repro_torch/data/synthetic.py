"""Synthetic data, so every run works offline: Lasso problems shaped like
the paper's datasets (abalone / covtype / susy, Table II), and the LM token
pipeline of the trainer.

Lasso data is drawn with a ``torch.Generator`` on the target device, in
bulk; the JAX package draws the same shapes with ``jax.random``, so the
numbers differ. The parity tests hand the JAX problem to the port instead.
The token stream draws with numpy exactly as the JAX package's does, so its
tokens are the same bits.
"""
from __future__ import annotations

import math
import queue
import threading
import zlib
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.problem import LassoProblem

#: name -> (d features, n samples, lambda) mirroring the paper's datasets.
#: Sizes are scaled for CPU CI; the generator accepts overrides for full size.
PAPER_DATASETS = {
    "abalone": dict(d=8, n=4177, lam=0.1),
    "covtype": dict(d=54, n=58_101, lam=0.01),   # 1/10 covtype rows for CI
    "susy": dict(d=18, n=100_000, lam=0.01),     # subsampled susy for CI
}


def make_lasso_data(seed: int, d: int, n: int,
                    sparsity: float = 0.25, noise: float = 0.01,
                    lam_frac: float = 0.1, dtype=torch.float32, device=None):
    """X (d, n) with unit-variance columns, y = X^T w* + noise, w* sparse.
    Returns (problem, w*).

    lambda is lam_frac * lambda_max, where lambda_max = ||X y / n||_inf is
    the smallest lambda with an all-zero solution — a nontrivial sparse
    optimum for any data scaling. ``device`` defaults to the card (see
    :func:`repro_torch.resolve_device`); reading lambda back to the host is
    the one wait of the set-up.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    X = torch.randn(d, n, generator=gen, device=dev, dtype=dtype) \
        / math.sqrt(d)
    w_star = torch.randn(d, generator=gen, device=dev, dtype=dtype)
    mask = torch.rand(d, generator=gen, device=dev) < sparsity
    w_star = torch.where(mask, w_star, torch.zeros_like(w_star))
    y = X.T @ w_star + noise * torch.randn(n, generator=gen, device=dev,
                                           dtype=dtype)
    lam = float(lam_frac * torch.max(torch.abs(X @ y / n)))
    return LassoProblem(X=X, y=y, lam=lam), w_star


def make_dataset_like(name: str, seed: Optional[int] = None,
                      scale: float = 1.0, device=None):
    """A synthetic problem with the shape of a paper dataset; ``scale`` 10
    gives covtype's full 581,010 rows, 50 susy's 5,000,000."""
    spec = PAPER_DATASETS[name]
    if seed is None:
        # stable digest, not hash(): str hashing is salted per process
        seed = zlib.adler32(name.encode()) & 0x7FFFFFFF
    n = max(int(spec["n"] * scale), 64)
    # a data-dependent lambda (fraction of lambda_max) plays the role of the
    # paper's per-dataset tuned lambda
    return make_lasso_data(seed, spec["d"], n, device=device)


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------

def make_token_batch(seed: int, batch: int, seq: int, vocab: int,
                     device=None) -> dict:
    """One next-token batch, dict(tokens, labels) of (batch, seq) int32,
    drawn by ``np.random.default_rng(seed)``. The JAX package's
    ``make_token_batch`` draws from a ``jax.random`` key instead, so the
    parity tests carry its draws across."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    dev = resolve_device(device)
    return dict(tokens=torch.from_numpy(toks[:, :-1].copy()).to(dev),
                labels=torch.from_numpy(toks[:, 1:].copy()).to(dev))


class TokenStream:
    """Deterministic, restartable token stream with background prefetch
    (the counterpart of ``repro.data.synthetic.TokenStream``).

    Batch ``step`` is drawn by ``np.random.default_rng(seed * 1,000,003 +
    step)``, as the JAX stream draws it, so the tokens are the same bits,
    and a stream started at ``start_step`` continues exactly where another
    left off. A thread draws ahead (``prefetch`` batches) into pinned host
    memory when the stream feeds a card; :meth:`__next__` copies the next
    batch to the device without blocking the host. :meth:`close` stops the
    thread.
    """

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 prefetch: int = 2, start_step: int = 0, device=None):
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.seed = seed
        self.step = start_step
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> dict:
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + step))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        out = {}
        for name, part in (("tokens", toks[:, :-1]), ("labels", toks[:, 1:])):
            t = torch.from_numpy(np.ascontiguousarray(part))
            out[name] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            item = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        self.step += 1
        return {k: v.to(self.device, non_blocking=True)
                for k, v in item.items()}

    def state(self) -> dict:
        return dict(step=self.step, seed=self.seed)

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
