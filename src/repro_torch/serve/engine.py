"""Batched LM serving: decode with a slot-based continuous-batching
scheduler.

Mirrors the ``Request`` / ``ServeEngine`` part of
``repro/serve/engine.py`` over the port's ``lm``: requests join a fixed
pool of batch slots, prompts are fed one token per decode step, and
finished slots are refilled between steps.  Slots advance in lockstep on
one shared cache position; each carries a ``kv_start`` window, so a
refilled dense or MoE slot never attends the previous occupant's cache
prefix.  As in the JAX package, an RWKV6, Mamba2-hybrid or
cross-attention slot is not reset when it is refilled: the new request
inherits the previous one's recurrent state and cache prefix.  The
engine feeds tokens, so a model with ``embed_inputs=False`` is refused.

``PreparedStatement`` is that module's parameterized SQL query over the
compiled-plan cache (``repro_torch.sql.compile``): one captured CUDA
graph serves every literal value.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``Request``s with ``params`` on the device they live on."""

    def __init__(self, cfg: ModelConfig, params: lm.Params, batch_slots: int = 4,
                 max_len: int = 128):
        if not cfg.embed_inputs:
            raise ValueError(f"{cfg.name} takes embeddings, not tokens: the engine feeds tokens; "
                             "drive it through lm.prefill and lm.decode_step")
        self.cfg = cfg
        self.params = params
        self.device = params["lm_head"].device
        self.slots = batch_slots
        self.max_len = max_len
        self.state = lm.init_decode_state(cfg, batch_slots, max_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, dtype=np.int64)
        self.slot_start = np.zeros(batch_slots, dtype=np.int32)  # cache window start
        self.steps = 0

    def add_request(self, req: Request) -> bool:
        for i, r in enumerate(self.slot_req):
            if r is None:
                self.slot_req[i] = req
                self.slot_pos[i] = 0
                self.slot_start[i] = self.state["pos"]
                return True
        return False

    def _next_tokens(self) -> np.ndarray:
        toks = np.zeros((self.slots, 1), dtype=np.int64)
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            p = self.slot_pos[i]
            if p < len(r.prompt):
                toks[i, 0] = r.prompt[p]
            elif r.out:
                toks[i, 0] = r.out[-1]
        return toks

    def step(self) -> None:
        """One greedy decode step over every slot."""
        batch = {
            "tokens": torch.as_tensor(self._next_tokens(), device=self.device),
            "kv_start": torch.as_tensor(self.slot_start, device=self.device),
        }
        logits, self.state = lm.decode_step(self.cfg, self.params, self.state, batch)
        self.steps += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(r.prompt):
                r.out.append(int(nxt[i]))
                if len(r.out) >= r.max_new or self.slot_pos[i] >= self.max_len - 1:
                    r.done = True
                    self.slot_req[i] = None  # free the slot (continuous batching)

    def run(self, requests: List[Request], max_steps: int = 1000) -> List[Request]:
        pending = list(requests)
        done: List[Request] = []
        while (pending or any(self.slot_req)) and self.steps < max_steps:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            self.step()
            done += [r for r in requests if r.done and r not in done]
        return requests


class PreparedStatement:
    """A parameterized SQL query served off the whole-plan compile cache.

    ``template`` is SQL text with ``{name}`` placeholders for *numeric
    or date literals* (the parameters a serving tier varies per
    request).  Each ``execute(**params)`` formats and re-plans the text
    -- cheap host work -- and dispatches through ``sql.execute``; because
    the compiled-plan cache keys on the plan's *structure* with
    literals abstracted into parameter slots, every execution after the
    first replays one captured graph (on the card) whatever the literal
    values.  Under ``CONFIG.compiled = 'off'`` (or for untraceable
    plans) this degrades transparently to op-by-op dispatch.

        ps = PreparedStatement(
            "SELECT ... WHERE l_quantity < {qty}", frames)
        out = ps.execute(qty=24)   # traces + captures once
        out = ps.execute(qty=25)   # cache hit, zero new captures

    Raw dict-of-numpy and store entries of ``scope`` go to ``device``
    (default ``CONFIG.device``); frames stay where they are.
    """

    def __init__(self, template: str, scope: Dict, device=None):
        from ..sql.lower import scope_frames

        self.template = template
        self.frames = scope_frames(scope, device)
        self.device = device
        self.calls = 0

    def execute(self, **params):
        from .. import sql

        self.calls += 1
        return sql.execute(self.template.format(**params), self.frames, device=self.device)
