"""Batched serving engine: decode with slot-based continuous batching.

Counterpart of `repro.runtime.serving`.  The decode step is
position-vectorised ([B] positions), so slots can hold sequences of
different lengths; a finished slot is refilled from the queue with the
batch shape unchanged.  Prompts are fed token by token through the decode
path (teacher-forced), as in the reference.  A slot admitted to a new
request starts from a zero state: `add_request` zeroes the slot's row of
every cache leaf.  The reference resets only the slot's position, so a
recurrent family (RWKV6's S, x_tm, x_cm) carries the last request's state
into the next one (ROADMAP Queue 3, fault 6); a decoder's stale KV entries
are masked by the positions either way.

Sampling stays on the device: only the [B] sampled token ids cross to the
host each step, never the [B, V] logits.  With temperature > 0 the gumbel
noise comes from a torch.Generator seeded from `ServeConfig.seed`; it
cannot equal `jax.random`'s draws, so the two packages agree on greedy
decoding only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models.module import materialize
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 4
    max_seq: int = 128
    temperature: float = 0.0       # 0 = greedy
    eos_token: int = -1            # -1: never stops early
    seed: int = 0
    # per-request engine-step budget; 0 = auto (prompt length + max_new,
    # exactly what a healthy request needs).  A request that exceeds its
    # budget is failed ALONE — its partial output is returned and its slot
    # freed; other in-flight requests are unaffected.
    max_request_steps: int = 0


class Engine:
    """`params=None` draws the model from torch.Generator(seed 0) on the
    device.  The device is CUDA unless `device="cpu"` is asked for."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params=None,
                 device=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.api = get_model(self.cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = materialize(self.api.specs(self.cfg), gen)
        self.params = params
        B, S = scfg.batch_slots, scfg.max_seq
        self.cache = self.api.init_cache(self.cfg, B, S, self.device)
        self.pos = np.zeros((B,), np.int32)
        self.live = np.zeros((B,), bool)
        self.tokens: list[list[int]] = [[] for _ in range(B)]
        self.slot_steps = np.zeros((B,), np.int64)   # engine steps while live
        self.failed_requests: set[int] = set()

    @torch.no_grad()
    def _decode(self, token, pos, gen):
        logits, self.cache = self.api.decode_step(self.cfg, self.params, token,
                                                  self.cache, pos)
        if self.scfg.temperature > 0.0:
            gumbel = -torch.empty_like(logits).exponential_(generator=gen).log()
            logits = logits / self.scfg.temperature + gumbel
        return logits.argmax(dim=-1).reshape(-1)              # [B]

    # -- slot management ------------------------------------------------------

    def add_request(self, prompt_tokens: list[int]) -> int | None:
        """Claim a free slot, zero its state; the prompt is consumed token
        by token."""
        free = np.where(~self.live)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        # the cache layout's batch axis: 1 under a stacked [L or U, B, ...]
        # cache, 0 in a per-layer list
        axis = 1 if self.cfg.scan_layers else 0
        for leaf in tree_leaves(self.cache):
            leaf.select(axis, slot).zero_()
        self.live[slot] = True
        self.pos[slot] = 0
        self.slot_steps[slot] = 0
        self.tokens[slot] = list(prompt_tokens)
        return slot

    def step(self, gen: torch.Generator) -> dict[int, int]:
        """One engine step: feeds each live slot its next token (prompt token
        if still prefilling, else the model's own last sample).  Only the
        [B] sampled ids come back to the host."""
        B = self.scfg.batch_slots
        feed = np.zeros((B, 1), np.int64)
        for b in range(B):
            if not self.live[b]:
                continue
            hist = self.tokens[b]
            feed[b, 0] = hist[min(self.pos[b], len(hist) - 1)]
        nxt = self._decode(torch.from_numpy(feed).to(self.device),
                           torch.from_numpy(self.pos).to(self.device),
                           gen).cpu().numpy()
        emitted = {}
        for b in range(B):
            if not self.live[b]:
                continue
            self.pos[b] += 1
            self.slot_steps[b] += 1
            if self.pos[b] >= len(self.tokens[b]):       # past the prompt
                tok = int(nxt[b])
                self.tokens[b].append(tok)
                emitted[b] = tok
                if tok == self.scfg.eos_token or \
                        self.pos[b] >= self.scfg.max_seq - 1:
                    self.live[b] = False
        return emitted

    def generate(self, prompts: list[list[int]], max_new: int = 16):
        """Serve a list of prompts to completion; returns generated suffixes.

        Each request carries its own step budget (scfg.max_request_steps, or
        prompt + max_new steps by default).  A request that exceeds it is
        failed ALONE: its rid lands in `self.failed_requests`, its partial
        output is returned, its slot is freed for pending work."""
        outputs = {i: [] for i in range(len(prompts))}
        slot_of = {}
        pending = list(enumerate(prompts))
        gen = torch.Generator(device=self.device).manual_seed(self.scfg.seed)
        budget = {i: max_new for i in range(len(prompts))}
        step_budget = {i: (self.scfg.max_request_steps or len(p) + max_new)
                       for i, p in enumerate(prompts)}
        self.failed_requests = set()
        while pending or self.live.any():
            while pending:
                rid, pr = pending[0]
                slot = self.add_request(pr)
                if slot is None:
                    break
                slot_of[slot] = rid
                pending.pop(0)
            emitted = self.step(gen)
            for slot, tok in emitted.items():
                rid = slot_of[slot]
                outputs[rid].append(tok)
                budget[rid] -= 1
                if budget[rid] <= 0:
                    self.live[slot] = False
            # every live slot consumed one engine step above, so each request
            # fails (alone) after at most its budget: the loop terminates
            for slot in np.where(self.live)[0]:
                rid = slot_of[int(slot)]
                if self.slot_steps[slot] >= step_budget[rid]:
                    self.live[slot] = False
                    self.failed_requests.add(rid)
        return [outputs[i] for i in range(len(prompts))]
