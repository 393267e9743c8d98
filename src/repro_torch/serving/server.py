"""Batched serving loop: fixed-slot continuous batching.

Port of ``repro/serving/server.py``.  Requests enter a queue; the engine
keeps B decode slots.  Arriving prompts are prefilled (left-padded to the
slot prompt length) and inserted into free slots; every engine step
decodes one token for all occupied slots, greedily (argmax, first index
on ties).  Slots free when a request hits EOS or max_new_tokens — the
decode-side analogue of the paper's self-scheduling (work claims a slot
as soon as one is idle, rather than batch-synchronous generation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (P,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    tokens_out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _splice(big: dict, one: dict, slot: int) -> None:
    """Write a one-request cache into ``slot`` of the batch cache, over
    the nested dict at any depth.  Leaves are (n_superblocks, B, ...):
    the batch is axis 1.  Each leaf is cast to the batch cache's dtype,
    as the reference's ``one.astype(big.dtype)``."""
    for key, leaf in one.items():
        if isinstance(leaf, dict):
            _splice(big[key], leaf, slot)
        else:
            big[key][:, slot:slot + 1] = leaf.to(big[key].dtype)


class BatchedServer:
    """Serves on ``device`` (``None`` means the card; pass ``"cpu"`` for
    the CPU).  ``params`` are moved there if they live elsewhere.

    ``greedy`` and ``seed`` are the reference's keywords, stored as it
    stores them and never read: decoding is greedy whatever ``greedy``
    says, as the reference's is.  Token-input configs only: a stubbed
    frontend (``cfg.frontend``) is refused, as there."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 prompt_len: int = 64, cache_len: int = 256,
                 greedy: bool = True, seed: int = 0, device=None):
        if cfg.frontend is not None:
            raise ValueError("stub-frontend archs serve via embeds path")
        self.cfg = cfg
        self.device = ops.resolve_device(device)
        self.params = M.tree_map(lambda x: x.to(self.device), params)
        self.slots = slots
        self.prompt_len = prompt_len
        self.cache_len = cache_len
        self.greedy = greedy
        self.seed = seed
        self.cache = M.init_cache(cfg, slots, cache_len, device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self._last_token = np.zeros((slots, 1), np.int32)
        self.steps = 0

    # -- slot management ---------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot (single-request prefill,
        then splice its cache into the batch cache)."""
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        P = min(len(req.prompt), self.prompt_len)
        prompt = np.zeros((1, self.prompt_len), np.int32)
        prompt[0, self.prompt_len - P:] = req.prompt[-P:]   # left-pad
        logits, cache1 = M.prefill(
            self.cfg, self.params,
            {"tokens": torch.from_numpy(prompt).to(self.device)},
            cache_len=self.cache_len)
        _splice(self.cache, cache1, slot)
        nxt = int(torch.argmax(logits[0, -1]))
        req.tokens_out.append(nxt)
        self._last_token[slot, 0] = nxt
        self.slot_req[slot] = req
        return True

    # -- engine step ---------------------------------------------------------

    def step(self) -> None:
        logits, self.cache = M.decode_step(
            self.cfg, self.params, self.cache,
            {"tokens": torch.from_numpy(self._last_token).to(self.device)})
        self.steps += 1
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[i])
            req.tokens_out.append(tok)
            self._last_token[i, 0] = tok
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.tokens_out) >= req.max_new_tokens:
                req.done = True
                self.slot_req[i] = None

    def serve(self, requests: list[Request]) -> list[Request]:
        """Run until every request completes (continuous batching)."""
        pending = list(requests)
        while pending or any(r is not None for r in self.slot_req):
            while pending and self._free_slots():
                self.admit(pending.pop(0))
            if any(r is not None for r in self.slot_req):
                self.step()
        return requests
