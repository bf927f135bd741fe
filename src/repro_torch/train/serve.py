"""Batched serving engine: prefill + continuous-batching decode.

The port of ``repro.train.serve``. A fixed pool of batch slots; requests
join free slots (their prompt is fed token by token into that slot's cache
lane through ``decode_step``), every engine step decodes one token for all
active slots, finished slots are freed immediately. The engine runs on the
device its parameters live on. It serves language models, and a vision
model (internvl2) on text prompts as the reference's engine does; it
refuses an encoder-decoder (whisper), as the reference's does.

Recurrent state (rwkv6's ``wkv``/``tm_prev``/``cm_prev``, hymba's
``ssm``) stays each request's own, unlike in the reference: ``decode_step``
runs every lane, and a lane that is not being fed would otherwise advance
its state on a dummy token. The engine restores those lanes after each
``decode_step`` and zeros a slot's state when it admits a request. A K/V
cache needs neither: a dummy write lands where the lane's next real token
writes.

MoE models route every lane's token through one dispatch, idle lanes'
dummy tokens included, as the reference does. A token picks distinct
experts, so a lane puts at most one row into an expert's buffer: while the
slots are no more than the decode step's capacity (4 at the default 4 slots
for mixtral-8x22b and kimi-k2-1t-a32b), nothing drops and a request's
tokens are its own. With more slots than that, whether a token drops
depends on its batch-mates' routes, in the port as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0) -> None:
        if cfg.enc_dec:
            raise ValueError("LM serving only")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.cache = transformer.init_cache(cfg, slots, max_len, device=self.device)
        self.recurrent = [n for n in transformer.RECURRENT if n in self.cache]
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, dtype=np.int64)  # next position per slot
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.steps = 0

    def _decode(self, toks: np.ndarray, pos: np.ndarray, fed: list) -> torch.Tensor:
        """One decode_step for all lanes; the recurrent state of the lanes
        not in ``fed`` is left as it was."""
        idle = [s for s in range(self.slots) if s not in fed]
        kept = {n: self.cache[n][:, idle] for n in self.recurrent} if idle else {}
        logits, self.cache = transformer.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos.astype(np.int32)).to(self.device),
        )
        for n, saved in kept.items():
            self.cache[n][:, idle] = saved
        return logits

    # --------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[s] = req
                for n in self.recurrent:  # a new request starts from zero state
                    self.cache[n][:, s] = 0
                self._prefill_slot(s, req)

    def _prefill_slot(self, s: int, req: Request) -> None:
        """Feed the prompt token by token into this slot's cache lane.

        Positions are per lane: inactive lanes keep their position frozen,
        so their dummy K/V writes land on the slot their next real token
        overwrites, and ``_decode`` restores their recurrent state."""
        for i, tok in enumerate(req.prompt):
            toks = np.zeros((self.slots, 1), np.int32)
            toks[s, 0] = tok
            pos = self.slot_pos.copy()
            pos[s] = i
            logits = self._decode(toks, pos, [s])
        self.slot_pos[s] = len(req.prompt)
        req._last_logits = logits[s, 0]

    # ---------------------------------------------------------------- decode
    def _sample(self, logits: torch.Tensor) -> int:
        if self.temperature <= 0:
            return int(torch.argmax(logits))  # the first maximum, as np.argmax
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    def step(self) -> None:
        """One engine tick: admit, decode one token for every active slot."""
        self._admit()
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return
        toks = np.zeros((self.slots, 1), np.int32)
        for s in active:
            req = self.slot_req[s]
            nxt = self._sample(req._last_logits)
            req.out.append(nxt)
            toks[s, 0] = nxt
        logits = self._decode(toks, self.slot_pos.copy(), active)  # each lane at its own depth
        self.steps += 1
        for s in active:
            req = self.slot_req[s]
            req._last_logits = logits[s, 0]
            self.slot_pos[s] += 1
            if len(req.out) >= req.max_new or self.slot_pos[s] >= self.max_len - 1:
                req.done = True
                self.completed.append(req)
                self.slot_req[s] = None

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or any(self.slot_req)) and self.steps < max_steps:
            self.step()
        return self.completed
