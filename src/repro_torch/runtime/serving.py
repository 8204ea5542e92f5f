"""Batched serving engine: decode with slot-based continuous batching.

Counterpart of `repro.runtime.serving`.  The decode step is
position-vectorised ([B] positions), so slots can hold sequences of
different lengths; a finished slot is refilled from the queue with the
batch shape unchanged.  Prompts are fed token by token through the decode
path (teacher-forced), as in the reference.  A slot admitted to a new
request starts from a zero state: `add_request` zeroes the slot's row of
every cache leaf, along that leaf's own batch axis: 1 in the stacked
``[U, B, ...]`` units, 0 in a per-layer list and in the rglru model's
``rem`` layers (`_batch_axes`).  The reference resets only the slot's
position, so a recurrent family (RWKV6's S, x_tm, x_cm; the RG-LRU's h
and conv) carries the last request's state into the next one (ROADMAP
Queue 3, fault 6); a decoder's stale KV entries are masked by the
positions either way.

Sampling stays on the device: only the [B] sampled token ids cross to the
host each step, never the [B, V] logits.  With temperature > 0 the gumbel
noise comes from a torch.Generator seeded from `ServeConfig.seed`; it
cannot equal `jax.random`'s draws, so the two packages agree on greedy
decoding only.

`Engine(..., mesh=)` serves over a mesh (every family the Engine serves:
RWKV6, the dense and MoE decoders, the RG-LRU LM): each rank holds its
shards of the parameters (placed by the rules) and its split of the cache
(`sharding.cache_shardings`), and runs the decode step on them
(`models.module.ShardCtx`).  The greedy token is
the argmax over the vocab shards (each rank's max and index, gathered
over 'model'; a tie goes to the lowest index, as `torch.argmax` breaks
it); with a temperature every rank draws the whole [B, V] noise from the
same generator and adds its own slice, so the tokens are the one-rank
Engine's.  The sampled ids are gathered over the batch's split dims, so
every rank keeps the whole host bookkeeping.  A slot is zeroed on the
ranks that hold its rows, each in its own split of the leaf (the RG-LRU's
h and conv channels, a decoder's cache slots).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models.module import materialize
from repro_torch.tree import tree_flatten_with_path, tree_map


def _batch_axes(api, cfg: ModelConfig, seq: int) -> dict[tuple, int]:
    """Each cache leaf's batch axis, by the leaf's path: the one axis where
    a batch-2 and a batch-1 cache of the model's own `init_cache` differ
    (shapes only, on the meta device)."""
    one, two = (dict(tree_flatten_with_path(api.init_cache(cfg, b, seq, "meta")))
                for b in (1, 2))
    axes = {}
    for path, leaf in two.items():
        diff = [i for i, (m, n) in enumerate(zip(one[path].shape, leaf.shape))
                if m != n]
        if len(diff) != 1:
            raise ValueError(f"cache leaf {path}: no single batch axis")
        axes[path] = diff[0]
    return axes


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
    device.  The device is CUDA unless `device="cpu"` is asked for; with a
    `mesh`, the mesh's.  Over a mesh `params` are whole (placed here) or
    placed already."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params=None,
                 device=None, mesh=None):
        self.cfg = cfg
        self.scfg = scfg
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
        self.api = get_model(self.cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = materialize(self.api.specs(self.cfg), gen)
        B, S = scfg.batch_slots, scfg.max_seq
        self.batch_axes = _batch_axes(self.api, self.cfg, S)
        if mesh is None:
            self.params = params
            self.cache = self.api.init_cache(self.cfg, B, S, self.device)
        else:
            self._place(params)
        self.pos = np.zeros((B,), np.int32)
        self.live = np.zeros((B,), bool)
        self.tokens: list[list[int]] = [[] for _ in range(B)]
        self.slot_steps = np.zeros((B,), np.int64)   # engine steps while live
        self.failed_requests: set[int] = set()

    def _place(self, params) -> None:
        """The rank's shards of `params` and a zero split of the cache (its
        rows, on the rows' mesh dims: `self.rows`)."""
        B, S = self.scfg.batch_slots, self.scfg.max_seq
        sh, self.ctx, self.rows = SH.serve_layout(self.cfg, self.api, B, S,
                                                  self.mesh)
        self.params = SH.local_tree(tree_map(
            lambda x, s: x if SH.is_dtensor(x) else SH.place(x, s),
            params, sh["params"]))

        def zeros(x, s):
            idx = SH.local_index(x.shape, s.placements,
                                 self.mesh.get_coordinate(), self.mesh.shape)
            return torch.zeros([i.stop - i.start for i in idx], dtype=x.dtype,
                               device=self.device)
        self.cache = tree_map(zeros, self.api.init_cache(self.cfg, B, S, "meta"),
                              sh["cache"])
        self.row_lo = 0
        if self.rows:
            self.row_lo = SH.group_index(self.mesh, self.rows) * (
                B // SH.group_size(self.mesh, self.rows))

    @torch.no_grad()
    def _decode(self, token, pos, gen):
        if self.mesh is not None:
            return self._decode_split(token, pos, gen)
        logits, self.cache = self.api.decode_step(self.cfg, self.params, token,
                                                  self.cache, pos)
        if self.scfg.temperature > 0.0:
            gumbel = -torch.empty_like(logits).exponential_(generator=gen).log()
            logits = logits / self.scfg.temperature + gumbel
        return logits.argmax(dim=-1).reshape(-1)              # [B]

    def _decode_split(self, token, pos, gen):
        """`_decode` over the mesh: the rank's rows and vocab slice, the
        argmax over the vocab shards, the ids of every row."""
        B, V = self.scfg.batch_slots, self.cfg.vocab_size
        nb = B // SH.group_size(self.mesh, self.rows) if self.rows else B
        rows = slice(self.row_lo, self.row_lo + nb)
        logits, self.cache = self.api.decode_step(
            self.cfg, self.params, token[rows], self.cache, pos[rows],
            ctx=self.ctx)
        nv = logits.shape[-1]
        v_lo = self.ctx.model_lo(nv) if nv < V else 0
        if self.scfg.temperature > 0.0:
            noise = torch.empty((B, V), dtype=logits.dtype,
                                device=logits.device).exponential_(generator=gen)
            gumbel = -noise[rows, v_lo:v_lo + nv].log()
            logits = logits / self.scfg.temperature + gumbel
        val, idx = logits.max(dim=-1)
        if nv < V:      # the first of the largest over the vocab shards
            both = SH.all_gather(torch.stack([val.double(),
                                              (idx + v_lo).double()]),
                                 self.mesh, "model", axis=1)      # [2, M*nb]
            both = both.view(2, -1, nb)
            best = both[0].argmax(dim=0)
            idx = both[1].gather(0, best[None])[0].long()
        if self.rows:
            idx = SH.all_gather(idx, self.mesh, self.rows)
        return idx.reshape(-1)

    # -- slot management ------------------------------------------------------

    def add_request(self, prompt_tokens: list[int]) -> int | None:
        """Claim a free slot, zero its state; the prompt is consumed token
        by token."""
        free = np.where(~self.live)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        for path, leaf in tree_flatten_with_path(self.cache):
            ax = self.batch_axes[path]
            row = slot - (self.row_lo if self.mesh is not None else 0)
            if 0 <= row < leaf.shape[ax]:       # the rows this rank holds
                leaf.select(ax, row).zero_()
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
