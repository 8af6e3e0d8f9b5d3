"""Communication-avoiding k-step decode (the counterpart of
``repro.serve.decode``).

The classic serving loop pays one host<->device round trip per generated
token. The k-step block runs k decode steps on device tensors and reads
nothing back; the engine then makes one device->host fetch per block
(arXiv:1710.08883's regrouping, on the serve path). FLOPs are unchanged;
host syncs per token drop by k. JAX fuses the k steps into one
``lax.scan`` under ``jit``; here the block is a Python loop of k eager
serve steps that enqueue kernels and never wait on the card. A CUDA graph
over the block is later performance work.

Prefill rides the same schedule: slots still consuming their prompt feed
prompt tokens into the shared step while decoding slots feed their last
token, so a freshly admitted request needs no separate prefill dispatch.

Within a block, per-slot EOS / max-length masks freeze finished slots:
their ``done`` flag lifts, they stop emitting and advancing, and the host
retires them at the next sync. A frozen slot still flows through the step,
writing its K/V in place at a position at or past its own ``kv_valid``
horizon (or, once freed, into the paged pool's scratch page 0), so nothing
it writes is ever read.

Sampling rides the same schedule: when a ``SlotSampling`` bundle is
passed, all k next-token draws (temperature / top-p / top-k, per-slot PRNG
keys) happen inside the block (``repro_torch.serve.sampling``), so a
sampled block costs exactly as many host syncs as a greedy one: none
inside, one fetch after.

Overlap contract (the engine's double-buffered loop, ``overlap=True``): a
block reads only its launch-time inputs (every host-side argument is
copied to the card at the call, from a snapshot of its own) and the cache
and state tensors the stream's earlier work left, and everything runs in
one stream, so a later admission's in-place writes (a zeroed slot row, a
copied page) are ordered after the in-flight block with no host barrier.
While a block is in flight its slot rows are *owned*: the engine must not
free or reallocate them (stale-slot fencing) nor permute them (defrag
flushes the pipeline first).

``sync_debug=True`` runs the block's steps under
``torch.cuda.set_sync_debug_mode("error")``: any hidden host sync inside
the block (``.item()``, a Python ``if`` on a CUDA tensor, an index built on
the host) raises. The block's host inputs are copied to the card before it
starts.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.launch.steps import make_serve_step
from repro_torch.serve.sampling import SlotSampling, sample_tokens


@dataclasses.dataclass
class DecodeState:
    """Device-side per-slot decode state (the block's carry)."""
    cache: dict              # pool cache (per-slot rows or page pool)
    lengths: torch.Tensor    # (B,) int32: tokens written == next write pos
    last_tok: torch.Tensor   # (B,) int32: last sampled token per slot
    n_out: torch.Tensor      # (B,) int32: tokens emitted per slot
    done: torch.Tensor       # (B,) bool: EOS / length / cache-full reached
    eos_hit: torch.Tensor    # (B,) bool: done fired on the EOS branch (and
                             # no length cause fired the same step)


def decode_dtypes(cfg) -> dict:
    """Leaf name -> the dtype a decode step writes it in, where that is
    not its ``init_cache`` dtype: the mamba2 conv window (ssm and hybrid
    families), which a step computes in the bf16 stream."""
    return {"conv": torch.bfloat16} if cfg.family in ("ssm", "hybrid") \
        else {}


def cast_cache(cache: dict, cfg) -> dict:
    """``cache`` with its leaves in their decode dtypes (the leaves already
    in them are kept, not copied)."""
    want = decode_dtypes(cfg)
    if not want:
        return cache

    def walk(tree):
        return {name: walk(leaf) if isinstance(leaf, dict)
                else leaf.to(want.get(name, leaf.dtype))
                for name, leaf in tree.items()}
    return walk(cache)


def init_decode_state(cache: dict, num_slots: int, device=None) -> DecodeState:
    z = lambda: torch.zeros(num_slots, dtype=torch.int32, device=device)
    f = lambda: torch.zeros(num_slots, dtype=torch.bool, device=device)
    return DecodeState(cache=cache, lengths=z(), last_tok=z(), n_out=z(),
                       done=f(), eos_hit=f())


@contextlib.contextmanager
def _sync_debug(on: bool):
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def make_decode_block(cfg, *, k: int, max_len: int,
                      eos_id: Optional[int] = None,
                      sync_debug: bool = False):
    """Build the k-step block.

    block(params, state, prompts, prompt_len, max_new, active,
          samp=None, page_table=None) -> (state', tokens (k, B) int32,
                                          emitted (k, B) bool)

    prompts (B, P) holds each slot's prompt; a slot is *prefilling* while
    ``lengths < prompt_len`` and *decoding* after. ``tokens[t, b]`` is valid
    iff ``emitted[t, b]`` (non-emitting steps carry -1). All inputs are
    device tensors; the block reads nothing back.

    samp: optional ``SlotSampling`` — per-slot temperature/top-p/top-k and
    PRNG keys; every draw happens inside the block (``sample_tokens``), so
    the sync count is unchanged. None is the greedy path (the engine passes
    None when every slot is greedy), bit-identical to the argmax.

    page_table: optional (B, pages_per_slot) int32 when the K/V leaves are a
    paged pool; the engine reserves pages covering the block's k steps
    before it starts, so the table is constant within the block.

    The cache leaves are cast to their decode dtypes once, before the first
    step (:func:`decode_dtypes`: the mamba2 conv window comes out of a step
    in bf16 inside a float32-initialised buffer, as JAX's block casts its
    carry through ``eval_shape``); after the first block that is no copy.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    serve = make_serve_step(cfg)

    def block(params, state: DecodeState, prompts, prompt_len, max_new,
              active, samp: Optional[SlotSampling] = None, page_table=None):
        P = prompts.shape[1]
        state.cache = cast_cache(state.cache, cfg)
        # a slot whose prompt overflows the prompt buffer or the cache can
        # never satisfy ``lengths >= prompt_len - 1``; admission rejects
        # these, and this guard retires a stray one at the next sync
        unservable = prompt_len > min(P, max_len - 1)
        toks, emitted = [], []
        st = state
        with _sync_debug(sync_debug):
            for _ in range(k):
                done0 = st.done | (active & unservable)
                live = active & ~done0
                in_prefill = st.lengths < prompt_len
                idx = st.lengths.clamp(0, P - 1).long()
                ptok = prompts.gather(1, idx[:, None])[:, 0]
                tok = torch.where(in_prefill, ptok, st.last_tok)
                pos = st.lengths.clamp(max=max_len - 1)
                nxt, logits, cache = serve(params, st.cache, tok[:, None],
                                           pos, page_table)
                nxt = nxt[:, 0]
                if samp is not None:
                    # all k draws live inside the block — no host sync;
                    # greedy rows take the argmax above verbatim
                    nxt = sample_tokens(logits[:, -1], nxt, samp, st.n_out)
                # the step consuming the LAST prompt token produces the
                # first generated token; pure-prefill steps emit nothing
                emit = live & (st.lengths >= prompt_len - 1)
                n_out = st.n_out + emit.to(torch.int32)
                # length causes (max_new, cache-full) take precedence over
                # a coincident EOS: finish_reason is derived from eos_hit
                len_done = (emit & (n_out >= max_new)) \
                    | (live & (st.lengths >= max_len - 1))
                done = done0 | len_done
                eos_hit = st.eos_hit
                if eos_id is not None:
                    eos_now = emit & (nxt == eos_id)
                    done = done | eos_now
                    eos_hit = eos_hit | (eos_now & ~len_done & ~done0)
                st = DecodeState(
                    cache=cache,
                    lengths=st.lengths + live.to(torch.int32),
                    last_tok=torch.where(live, nxt, st.last_tok),
                    n_out=n_out, done=done, eos_hit=eos_hit)
                toks.append(torch.where(emit, nxt, torch.full_like(nxt, -1)))
                emitted.append(emit)
            toks, emitted = torch.stack(toks), torch.stack(emitted)
        return st, toks, emitted

    return block
