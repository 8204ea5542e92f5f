"""Top-k Mixture-of-Experts with sort-based capacity dispatch, in PyTorch.

Counterpart of `repro.models.moe`:

  router -> top-k -> renormalised gates -> the (token, slot) pairs
  stable-sorted by expert -> position in the expert -> capacity drop ->
  [E, C, d] buffer -> per-expert FFN (batched products) -> gather and
  weighted combine.

The capacity rounds up to a multiple of 8 and pairs are dropped in
stable-sort order (by expert id, then token), as in the reference, so the
same pairs are dropped: the capacity is a semantic, not a tuning knob.
No [T, E, C] one-hot dispatch tensor is built.

The scatter into the buffer and the combine are gathers by the routing
permutation in both directions (`_PermGather`): the backward of each
gather is the gather the other way, with the k slots of a token summed in
a fixed order.  No float atomics (`index_add_`, accumulating `index_put_`, the
backward of advanced indexing) run, so a forward and backward is bitwise
the same run to run on the card.

``cfg.moe_impl``: 'dispatch'; 'blockwise' (the reference's dispatch within
each data block of the mesh: one card has one block, which is 'dispatch');
'dense' (the oracle: every expert on every token; one device only);
'shardmap', the reference's explicit expert parallelism over a mesh, which
without a mesh is 'dispatch', exactly as the reference does.  The expert
products are batched matmuls: the reference computes them outside any
Pallas kernel.

Under a mesh (`moe_block_sharded`, given a `ShardCtx`) the block runs on
the rank's own tokens and, where the rules put the experts on 'model'
(every layout but pure data parallelism), on the rank's own experts:

  * the shardmap form ('shardmap' with at least one token an expert in
    the rank's block, and 'blockwise'): the reference's per-block
    semantics, each data block dispatched alone at capacity C(T / D), the
    aux loss the mean of the blocks' (`moe_block_shardmap`);
  * otherwise ('dispatch', the shardmap config's decode fallback, and
    pure data parallelism) the global dispatch's semantics: a pair's
    place in its expert's queue is its place among all the batch's pairs
    in token order (the lower batch ranks' counts, one all_gather of [E]
    integers, are its offset) against C(T), and the aux loss is the whole
    batch's.

With the experts split over 'model', x enters the experts through
`copy_to` and the gates through `copy_to` (each rank's gradient of them
is its own experts' share, summed over 'model' in the backward), and the
combined output leaves through `reduce_from` (the reference's psum over
'model').  The router's probabilities reach the aux loss without a
collective: every 'model' rank computes the same aux from the same
tokens, so its gradient is whole on each rank and counted once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import collectives as CL
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act
from repro_torch.models.module import (NULL_CTX, ParamSpec, ShardCtx,
                                       fan_in_normal, mesh_shape)

MOE_IMPLS = ("dispatch", "blockwise", "dense", "shardmap")


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, E, pd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.param_dtype
    gated = cfg.mlp_act in ("swiglu", "geglu")
    specs = {
        "router": ParamSpec((d, E), torch.float32, fan_in_normal(), ("embed", "experts_r")),
        "wi": ParamSpec((E, d, f), pd, fan_in_normal(), ("experts", "embed_tp", "mlp_e")),
        "wo": ParamSpec((E, f, d), pd, fan_in_normal(), ("experts", "mlp_e", "embed_tp")),
    }
    if gated:
        specs["wg"] = ParamSpec((E, d, f), pd, fan_in_normal(),
                                ("experts", "embed_tp", "mlp_e"))
    return specs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


def router_probs(cfg: ModelConfig, p: dict, xt: torch.Tensor) -> torch.Tensor:
    return torch.softmax(xt.float() @ p["router"], dim=-1)      # [T, E] f32


def expert_counts(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The pairs routed to each expert [E] (int64).  An integer
    `scatter_add_`, exact in any order; `bincount` has no meta kernel, and
    the dry-run runs this on the meta device."""
    idx = expert_idx.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int64))


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    T = probs.shape[0]
    counts = expert_counts(expert_idx, n_experts)
    f = counts.float() / (T * expert_idx.shape[-1])
    return n_experts * (f * probs.mean(dim=0)).sum()


def _expert_ffn(cfg: ModelConfig, p: dict, ebuf: torch.Tensor) -> torch.Tensor:
    """ebuf: [E, C, d] -> [E, C, d]"""
    dt = cfg.compute_dtype
    h = torch.bmm(ebuf, p["wi"].to(dt))
    g = torch.bmm(ebuf, p["wg"].to(dt)) if "wg" in p else None
    return torch.bmm(_act(cfg, h, g), p["wo"].to(dt))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx of x [n, d]; index n (the sentinel) reads a zero row."""
    n = x.shape[0]
    rows = x.index_select(0, idx.clamp(max=n - 1))
    return torch.where((idx < n)[:, None], rows, 0)


class _PermGather(torch.autograd.Function):
    """out[i] = src[idx[i]] (zero where idx[i] is the sentinel len(src)).
    `back` [len(src), r] lists the output rows that read each source row
    (the sentinel len(out) where fewer than r do), so the adjoint is the
    gather the other way: grad_src[j] = sum over r of grad_out[back[j, r]],
    summed in the order of r."""

    @staticmethod
    def forward(ctx, src, idx, back):
        ctx.save_for_backward(back)
        return _take(src, idx)

    @staticmethod
    def backward(ctx, grad):
        back, = ctx.saved_tensors
        g = _take(grad, back.reshape(-1))
        return g.reshape(*back.shape, grad.shape[-1]).sum(dim=1), None, None


def _dispatch(cfg: ModelConfig, p: dict, xt: torch.Tensor, gate: torch.Tensor,
              expert_idx: torch.Tensor, C: int, e0: int = 0,
              E_loc: int | None = None,
              offset: torch.Tensor | None = None) -> torch.Tensor:
    """The capacity-bounded dispatch of T tokens [T, d] with their top-k
    gates and experts [T, k] -> [T, d].  With `e0`/`E_loc` (expert
    parallelism) `p` holds experts [e0, e0 + E_loc) only: the pairs routed
    elsewhere are dropped here (their rank serves them).  `offset` [E]
    (a batch split over ranks): the pairs of the lower ranks' tokens ahead
    of these in each expert's queue, so a pair is kept where its place in
    the whole batch's queue is below C; an expert's buffer then holds at
    most min(C, T) rows of this rank's."""
    T, d = xt.shape
    k, E = cfg.top_k, cfg.n_experts
    E_loc = E if E_loc is None else E_loc
    dev = xt.device
    e_flat = expert_idx.reshape(T * k)
    order = torch.sort(e_flat, stable=True).indices
    es = e_flat[order]                                       # sorted expert ids
    starts = torch.searchsorted(es, torch.arange(E, device=dev), side="left")
    rank = torch.arange(T * k, device=dev)
    pos_in_e = rank - starts[es]
    el = es - e0
    kept = pos_in_e < C if offset is None else pos_in_e + offset[es] < C
    mine = kept & (el >= 0) & (el < E_loc)
    if offset is not None:
        C = min(C, T)                # a token takes an expert at most once
    slot_sorted = torch.where(mine, el * C + pos_in_e, E_loc * C)
    # each pair's buffer row in (token, slot) order (E_loc*C: dropped), and
    # each buffer row's pair (T*k: empty); row E_loc*C collects the dropped
    # pairs and is cut off
    R = E_loc * C
    slot_of_pair = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    pair_of_row = torch.full((R + 1,), T * k, dtype=rank.dtype,
                             device=dev).scatter_(0, slot_of_pair, rank)[:R]
    tok_of_row = torch.where(pair_of_row < T * k, pair_of_row // k, T)
    ebuf = _PermGather.apply(xt, tok_of_row, slot_of_pair.reshape(T, k))
    eout = _expert_ffn(cfg, p, ebuf.reshape(E_loc, C, d)).reshape(R, d)
    y_pairs = _PermGather.apply(eout, slot_of_pair, pair_of_row[:, None])
    return (y_pairs.reshape(T, k, d) * gate[..., None]).sum(dim=1)


def _top_k(cfg: ModelConfig, probs: torch.Tensor):
    """Router probabilities -> (renormalised gates [T, k] in the compute
    dtype, experts [T, k])."""
    gate, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = (gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)).to(
        cfg.compute_dtype)
    return gate, expert_idx


def _route(cfg: ModelConfig, p: dict, xt: torch.Tensor):
    """Router -> (renormalised gates [T, k] in the compute dtype, experts
    [T, k], the aux loss)."""
    probs = router_probs(cfg, p, xt)
    gate, expert_idx = _top_k(cfg, probs)
    return gate, expert_idx, load_balance_loss(probs, expert_idx, cfg.n_experts)


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
              ctx: ShardCtx = NULL_CTX):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32).  Under a mesh,
    `moe_block_sharded`."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {cfg.moe_impl!r}")
    if ctx.on:
        return moe_block_sharded(cfg, p, x, ctx)
    if cfg.moe_impl == "blockwise":
        return moe_block_blockwise(cfg, p, x)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gate, expert_idx, aux = _route(cfg, p, xt)
    if cfg.moe_impl == "dense":
        return _moe_dense_combine(cfg, p, x, gate, expert_idx), aux
    # 'dispatch', or 'shardmap' without a mesh
    yt = _dispatch(cfg, p, xt, gate, expert_idx, capacity(cfg, B * S))
    return yt.reshape(B, S, d), aux


def moe_block_blockwise(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The reference's data-block-local dispatch: the T tokens split into D
    blocks (D = the mesh's data degree), each dispatched alone at capacity
    C(T / D).  One card has no mesh, so D = 1: one block of all T tokens,
    which is 'dispatch'; under a mesh it is the shardmap form."""
    return moe_block(cfg.replace(moe_impl="dispatch"), p, x)


def moe_block_sharded(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      ctx: ShardCtx):
    """The block under a mesh on this rank's local tensors: x its rows
    [B_loc, S, d] (the same rows on every 'model' rank but under pure data
    parallelism), `p` the layer's weights for use (`ShardCtx.use`: the
    router whole, the experts the rank's E/M, or all E where the rules
    replicate them).  The shardmap form where the reference takes it, else
    the global dispatch's semantics (module docstring).  A placed x (a
    DTensor) goes to `moe_block_shardmap`."""
    from repro_torch.sharding import is_dtensor
    if cfg.moe_impl == "dense":
        raise NotImplementedError(
            "moe_impl 'dense' is the one-device oracle: under a mesh the "
            "MoE block runs 'dispatch', 'blockwise' or 'shardmap'")
    if is_dtensor(x):
        return moe_block_shardmap(cfg, p, x, ctx)
    ep = ctx.rules.mesh_axes("experts") is not None
    per_block = ep and (cfg.moe_impl == "blockwise" or (
        cfg.moe_impl == "shardmap" and x.shape[0] * x.shape[1]
        >= cfg.n_experts))
    return _ep_block(cfg, p, x, ctx, per_block)


def _ep_block(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx: ShardCtx,
              per_block: bool):
    """The dispatch of this rank's tokens to its experts under a mesh:
    per block (C(T_loc), the aux loss the mean of the batch blocks') or
    with the global dispatch's queue and capacity (C(T), the aux loss of
    the whole batch).  Collectives: the experts split over 'model', the
    output's all_reduce over it (and its two `copy_to`s' in the backward);
    the batch split over more than one rank, the aux loss's all_reduce over
    the batch dims, and in the global form the counts' all_gather."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    E_loc = p["wi"].shape[0]
    split = E_loc < E
    e0 = ctx.model_lo(E_loc) if split else 0
    D = CL.group_size(ctx.mesh, ctx.batch) if ctx.batch else 1
    xt = x.reshape(T, d)
    probs = router_probs(cfg, p, xt)
    gate, expert_idx = _top_k(cfg, probs)
    if per_block:
        C, offset = capacity(cfg, T), None
        aux = load_balance_loss(probs, expert_idx, E)
        if D > 1:
            aux = ctx.reduce_batch(aux) / D
    else:
        counts = expert_counts(expert_idx, E)
        offset = None
        if D > 1:
            every = CL.all_gather(counts[None], ctx.mesh, ctx.batch)  # [D, E]
            offset = every[:CL.group_index(ctx.mesh, ctx.batch)].sum(dim=0)
            counts = every.sum(dim=0)
        C = capacity(cfg, T * D)
        f = counts.float() / (T * D * k)
        aux = E * (f * ctx.reduce_batch(probs.sum(dim=0)) / (T * D)).sum()
    if split:       # each rank's gradients of x and the gates: its experts'
        xt, gate = ctx.copy(xt), ctx.copy(gate)
    yt = _dispatch(cfg, p, xt, gate, expert_idx, C, e0, E_loc, offset)
    if split:
        yt = ctx.reduce(yt)
    return yt.reshape(B, S, d), aux


def _gathered(w, mesh, dims: tuple):
    """A weight's local value, gathered over the mesh dims of `dims` that
    shard it (one all_gather each): a plain tensor is whole already."""
    from torch.distributed.tensor import Shard
    from repro_torch import sharding as SH
    if not SH.is_dtensor(w):
        return w
    local = w.to_local()
    for a, pl in reversed(list(zip(mesh.mesh_dim_names, w.placements))):
        if a in dims and isinstance(pl, Shard):
            local = SH.all_gather(local, mesh, a, axis=pl.dim)
    return local


def moe_block_shardmap(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       ctx: ShardCtx):
    """Explicit expert parallelism over the mesh's 'model' dim on placed
    tensors: each rank serves E/M experts to the tokens of its batch
    shard, the per-block form of `_ep_block` (the reference's
    `moe_block_shardmap`).

    Activations are batch-sharded and model-replicated, so every rank
    already holds the tokens of its data row: dispatch to its own experts
    needs no communication.  `x` is a DTensor placed over the batch axes
    (the result is placed alike) or this rank's plain local block; the
    expert weights are DTensors placed by the rules (`tree_shardings`:
    experts over 'model', with `cfg.fsdp` their d_model dim over the fsdp
    axes) or whole plain tensors, of which the rank takes its experts.
    Collectives a call (`sharding`):
      * with `cfg.fsdp`, one all_gather over 'data' of each expert weight
        (and of the router, whose d_model dim the rules shard too);
      * one all_reduce over 'model' of the combined token outputs;
      * one all_reduce over the batch axes of the aux loss (its mean).
    The weights' gathers here are not differentiated: the train step's
    gathers are `ShardCtx.use`'s, and it calls `moe_block_sharded` on the
    rank's local tensors."""
    import dataclasses
    from repro_torch import sharding as SH
    mesh = ctx.mesh
    sizes = mesh_shape(mesh)
    E = cfg.n_experts
    n_model = sizes["model"]
    if E % n_model:
        raise ValueError(f"{E} experts do not split over {n_model} 'model' "
                         "ranks")
    E_loc = E // n_model
    e0 = mesh.get_coordinate()[mesh.mesh_dim_names.index("model")] * E_loc
    batch_ax = tuple(a for a in ("pod", "data") if a in sizes)
    fsdp_ax = tuple(a for a in cfg.fsdp_axes if a in sizes) \
        if cfg.fsdp else ()
    x_dt = SH.is_dtensor(x)
    x_blk = x.to_local() if x_dt else x

    def local_experts(w):
        if SH.is_dtensor(w):
            return _gathered(w, mesh, fsdp_ax)
        return w[e0:e0 + E_loc]
    lp = {name: local_experts(p[name]) for name in ("wi", "wg", "wo")
          if name in p}
    lp["router"] = _gathered(p["router"], mesh, tuple(sizes))
    y, aux = _ep_block(cfg, lp, x_blk,
                       dataclasses.replace(ctx, batch=batch_ax), True)
    if x_dt:
        from torch.distributed.tensor import DTensor
        y = DTensor.from_local(y, mesh, x.placements, run_check=False)
    return y, aux


def _moe_dense_combine(cfg: ModelConfig, p: dict, x: torch.Tensor, gate,
                       expert_idx) -> torch.Tensor:
    """Oracle path: run every expert on every token (tiny configs, tests)."""
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    xt = x.reshape(T, d)
    all_out = _expert_ffn(cfg, p, xt.expand(E, T, d))              # [E, T, d]
    onehot = F.one_hot(expert_idx, E).to(cfg.compute_dtype)        # [T, k, E]
    w = torch.einsum("tk,tke->te", gate, onehot)                   # [T, E]
    return torch.einsum("te,etd->td", w, all_out).reshape(B, S, d)
