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
'dense' (the oracle: every expert on every token); 'shardmap' (the
reference's explicit expert-parallel form over a mesh) falls through to
'dispatch' without a mesh, exactly as the reference does.  The mesh form
waits for the sharded carry, ROADMAP Queue 1 item 13.  The expert products
are batched matmuls: the reference computes them outside any Pallas
kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act
from repro_torch.models.module import ParamSpec, fan_in_normal

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


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e.  The counts are integers
    (an integer `scatter_add_`, exact in any order; `bincount` has no meta
    kernel, and the dry-run runs this on the meta device)."""
    T = probs.shape[0]
    idx = expert_idx.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64,
                         device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int64))
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
              expert_idx: torch.Tensor, C: int) -> torch.Tensor:
    """The capacity-bounded dispatch of T tokens [T, d] with their top-k
    gates and experts [T, k] -> [T, d]."""
    T, d = xt.shape
    k, E = cfg.top_k, cfg.n_experts
    dev = xt.device
    e_flat = expert_idx.reshape(T * k)
    order = torch.sort(e_flat, stable=True).indices
    es = e_flat[order]                                       # sorted expert ids
    starts = torch.searchsorted(es, torch.arange(E, device=dev), side="left")
    rank = torch.arange(T * k, device=dev)
    pos_in_e = rank - starts[es]
    slot_sorted = torch.where(pos_in_e < C, es * C + pos_in_e, E * C)
    # each pair's buffer row in (token, slot) order (E*C: dropped), and
    # each buffer row's pair (T*k: empty); row E*C collects the dropped
    # pairs and is cut off
    slot_of_pair = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    pair_of_row = torch.full((E * C + 1,), T * k, dtype=rank.dtype,
                             device=dev).scatter_(0, slot_of_pair, rank)[:E * C]
    tok_of_row = torch.where(pair_of_row < T * k, pair_of_row // k, T)
    ebuf = _PermGather.apply(xt, tok_of_row, slot_of_pair.reshape(T, k))
    eout = _expert_ffn(cfg, p, ebuf.reshape(E, C, d)).reshape(E * C, d)
    y_pairs = _PermGather.apply(eout, slot_of_pair, pair_of_row[:, None])
    return (y_pairs.reshape(T, k, d) * gate[..., None]).sum(dim=1)


def _route(cfg: ModelConfig, p: dict, xt: torch.Tensor):
    """Router -> (renormalised gates [T, k] in the compute dtype, experts
    [T, k], the aux loss)."""
    probs = router_probs(cfg, p, xt)
    gate, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = (gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)).to(
        cfg.compute_dtype)
    return gate, expert_idx, load_balance_loss(probs, expert_idx, cfg.n_experts)


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32)."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {cfg.moe_impl!r}")
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
    which is 'dispatch'."""
    return moe_block(cfg.replace(moe_impl="dispatch"), p, x)


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
