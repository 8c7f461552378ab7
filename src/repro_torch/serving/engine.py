"""Batched serving engine — slot-based continuous batching: the port of
``repro.serving.engine``.

* a fixed pool of ``max_batch`` slots shares one KV cache;
* prefill inserts a request's prompt into a free slot: the model writes
  the prompt's k/v straight into the slot's rows of the shared cache
  (batch row ``i`` of every leaf, ``CACHE_BATCH_AXIS``), zeroed first, as
  the JAX engine's fresh one-request cache is;
* one ``decode_step`` advances *all* active slots by one token per call —
  requests join and leave the batch independently (continuous batching);
* finished slots (EOS / max_new_tokens) are freed and immediately reusable.

The cache may also be recurrent: an RWKV6 model keeps, per layer and
slot, fp32 token-shift rows and a WKV state instead of k/v rows.  The same
slot view serves it (its leaves have the batch on ``CACHE_BATCH_AXIS``
too), and zeroing the slot's leaves before a prefill gives the zero state
that the JAX engine's fresh one-request cache starts from; the prefill
then leaves the prompt's final state there, and each decode step advances
it by one token.  ``max_len`` bounds the prompt and the generated tokens
as it does for a KV cache, though the state does not grow with them.

A hybrid model (zamba2) keeps both kinds in one tree: per Mamba2 block
and slot, fp32 conv rows and an SSD state, and per shared-block
invocation a bf16 KV cache.  Every leaf has its batch on
``CACHE_BATCH_AXIS``, so the same slot view serves the whole tree, and
zeroing it before a prefill gives the JAX engine's fresh one-request
cache for both kinds.  A decode step advances every slot, idle ones on
filler tokens too; an idle slot's state is never read before its next
prefill zeroes it.

An MoE model (``nn/moe.py``) routes a prefill's tokens at the
``prefill`` capacity: one request a prefill, so the capacity bound couples
only a prompt's own tokens, as in the JAX engine.  A decode step runs all
``max_batch`` slots, active or not, at the worst-case capacity, where no
pair drops and the slots' rows do not interact.

On the card every prefill's attention runs K10 (a transformer, zamba2's
shared block) or its WKV runs K11 (RWKV6), and every projection K3 (a
dense block's feed-forward too; an MoE block's experts are batched
``torch.matmul``); a decode step runs K3 and the plain decode attention,
the plain per-step WKV or the plain one-step SSD.  Sampling draws
from one ``torch.Generator`` on the CPU, seeded with ``seed``, in slot
order: repeatable for a seed, but not the JAX engine's tokens at a
temperature above 0 (its PRNG differs).  Greedy requests never draw.
"""
from __future__ import annotations

import dataclasses
import queue
from typing import Dict, List, Optional

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.common import cache_slot
from repro_torch.nn.param import tree_leaves
from repro_torch.nn.sampling import sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int = -1  # -1: never stop early


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0
    generated: Optional[List[int]] = None


class ServingEngine:
    """``model`` is a port model (``repro_torch.models``); ``params``, when
    given, a parameter tree it loads (``init_tree``, ``params_from_jax``).
    The engine moves the model to ``device``: ``cuda`` unless the caller
    asks for another."""

    def __init__(self, model, params=None, *, max_batch: int = 8,
                 max_len: int = 512, window: int = 0, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if params is not None:
            model.load_tree(params)
        self.model = model.to(self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.window = window
        self.cache = model.init_cache(max_batch, max_len, window)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.pending: "queue.SimpleQueue[Request]" = queue.SimpleQueue()
        self.done: Dict[int, List[int]] = {}
        self.generator = torch.Generator().manual_seed(seed)

    # -- client API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._check_prompt(req)
        self.pending.put(req)

    def _check_prompt(self, req: Request) -> None:
        """A slot's KV cache holds ``max_len`` rows and decoding needs at
        least one free row past the prompt — an oversized prompt would
        overflow the slot's cache rows at prefill (and ``_decode_step``
        would then write past ``max_len``)."""
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of request {req.rid} has {len(req.prompt)} tokens; "
                f"the engine's slots hold max_len={self.max_len} KV rows "
                f"and decoding needs at least one free row — prompts must "
                f"be shorter than max_len")

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        steps = 0
        while (not self.pending.empty() or self._any_active()) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.done

    # -- engine loop ------------------------------------------------------------
    def _any_active(self) -> bool:
        return any(s.request is not None for s in self.slots)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.request is None:
                return i
        return None

    def step(self) -> None:
        # 1) admit pending requests into free slots (prefill)
        while not self.pending.empty():
            i = self._free_slot()
            if i is None:
                break
            self._prefill_into_slot(i, self.pending.get())
        # 2) advance all active slots one token
        if self._any_active():
            self._decode_step()

    # -- internals -----------------------------------------------------------------
    def _sample(self, logits, temperature: float) -> int:
        return int(sample(logits.float().cpu(), self.generator,
                          temperature=temperature)[0])

    @torch.no_grad()
    def _prefill_into_slot(self, i: int, req: Request) -> None:
        self._check_prompt(req)  # guard direct callers too
        prompt = torch.tensor([req.prompt], dtype=torch.long,
                              device=self.device)
        slot_cache = cache_slot(self.cache, i)
        for leaf in tree_leaves(slot_cache):
            leaf.zero_()
        logits, _, _ = self.model(
            {"tokens": prompt}, mode="prefill", cache=slot_cache,
            window_override=self.window)
        if req.temperature > 0:
            first = self._sample(logits[:, -1], req.temperature)
        else:
            first = int(torch.argmax(logits[0, -1]))
        slot = self.slots[i]
        slot.request = req
        slot.pos = prompt.shape[1]  # position of the next (generated) token
        slot.generated = [first]

    @torch.no_grad()
    def _decode_step(self) -> None:
        tokens = torch.zeros((self.max_batch, 1), dtype=torch.long)
        positions = torch.zeros((self.max_batch,), dtype=torch.long)
        active = []
        for i, s in enumerate(self.slots):
            if s.request is not None:
                tokens[i, 0] = s.generated[-1]
                positions[i] = s.pos
                active.append(i)
        logits, self.cache = self.model.decode_step(
            tokens.to(self.device), positions.to(self.device), self.cache,
            window=self.window)
        greedy = torch.argmax(logits[:, 0], dim=-1).cpu()  # one transfer
        for i in active:
            s = self.slots[i]
            temp = s.request.temperature
            if temp > 0:
                tok = self._sample(logits[i:i + 1, 0], temp)
            else:
                tok = int(greedy[i])
            s.generated.append(tok)
            s.pos += 1
            req = s.request
            n_new = len(s.generated)
            if (tok == req.eos_id or n_new >= req.max_new_tokens
                    or s.pos >= self.max_len - 1):
                self.done[req.rid] = s.generated
                self.slots[i] = _Slot()
