"""GQA attention: chunked flash attention (training and prefill) and
cached decode, in PyTorch.

Counterpart of `repro.models.attention`: self-attention and the whisper
decoder's cross-attention (no rope, every key valid).  The chunked path is the reference's algorithm in torch ops: an
online softmax over KV blocks with the logit softcap, for one query chunk
at a time.  Whether a (query chunk, KV block) pair is skipped (wholly
above the diagonal or left of the window) or needs no mask (every pair
valid) depends on Python ints only, so here those decisions are plain
`if`s: a skipped block issues no op.  No TPU kernel lies on this path (the
reference's is the chunked XLA path too), and `scaled_dot_product_attention`
is not a substitute: it has no logit softcap.

Scores, P.V and the decode products take compute-dtype operands widened
to f32, as the reference's `preferred_element_type=jnp.float32` products
do (a bf16 x bf16 product is exact in f32); P is rounded to V's dtype
before P.V, as there.  TF32 is off in this package.

Under a mesh (`ShardCtx`), wq/wk/wv are column-parallel and wo
row-parallel over 'model'.  Where the projections' channel slices are
whole heads, and each rank's query heads find their kv heads on the same
rank, a rank attends over its own heads.  Otherwise (a slice that is not
whole heads, or GQA groups that straddle ranks) the projected heads are
gathered over 'model', every rank attends over all heads, and keeps its
channels for wo.  The decode cache is split as `sharding.cache_shardings`
splits it: along the sequence over 'model' where it divides (each rank
attends over its slots and the partial softmaxes merge: the max, then
the weighted sums), else by kv heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import collectives as C
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rmsnorm, softcap
from repro_torch.models.module import (NULL_CTX, ParamSpec, ShardCtx,
                                       fan_in_normal, ones_init)

NEG_INF = -1e30


def attn_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """wq/wk/wv/wo, plus the qk-norm scales unless `cross` (the
    cross-attention drops qk-norm, as in the reference)."""
    d, dh, pd = cfg.d_model, cfg.head_dim, cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, cfg.n_heads * dh), pd, fan_in_normal(), ("embed_tp", "q_out")),
        "wk": ParamSpec((d, cfg.n_kv_heads * dh), pd, fan_in_normal(), ("embed_tp", "kv_out")),
        "wv": ParamSpec((d, cfg.n_kv_heads * dh), pd, fan_in_normal(), ("embed_tp", "kv_out")),
        "wo": ParamSpec((cfg.n_heads * dh, d), pd, fan_in_normal(), ("q_out", "embed_tp")),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = ParamSpec((dh,), pd, ones_init(), ("head_dim",))
        specs["k_norm"] = ParamSpec((dh,), pd, ones_init(), ("head_dim",))
    return specs


def _scale(cfg: ModelConfig) -> float:
    return cfg.attn_logits_scale or cfg.head_dim ** -0.5


def _q_heads(cfg, p, q, positions, rope=True):
    """Projected queries [..., n * Dh] -> heads [..., n, Dh], normed and
    rotated."""
    q = q.reshape(*q.shape[:-1], -1, cfg.head_dim)
    if cfg.qk_norm and "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def project_kv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
               rope: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """-> k, v: [B, Skv, KV, Dh]"""
    dt = cfg.compute_dtype
    return _kv_heads(cfg, p, x @ p["wk"].to(dt), x @ p["wv"].to(dt),
                     positions, rope)


def _kv_heads(cfg, p, k, v, positions, rope=True):
    k = k.reshape(*k.shape[:-1], -1, cfg.head_dim)
    v = v.reshape(*v.shape[:-1], -1, cfg.head_dim)
    if cfg.qk_norm and "k_norm" in p:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope and cfg.pos_emb == "rope":
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# Chunked flash attention
# ---------------------------------------------------------------------------

def _fit_chunk(seq: int, target: int) -> int:
    """Largest divisor of `seq` that is <= target."""
    c = min(target, seq)
    while seq % c:
        c -= 1
    return c


class _Acc(NamedTuple):
    m: torch.Tensor     # [B, KV, G, Cq]      running max (f32)
    l: torch.Tensor     # [B, KV, G, Cq]      running denom (f32)
    o: torch.Tensor     # [B, KV, G, Cq, Dh]  running numerator (f32)


def _block_scores(q, k, scale, cap):
    # q: [B, Cq, KV, G, Dh]  k: [B, Ck, KV, Dh] -> [B, KV, G, Cq, Ck] f32
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    return softcap(s * scale, cap)


def flash_kv_block(q, k_blk, v_blk, acc: _Acc, *, q_pos, kv_pos, causal,
                   window, scale, cap, masked: bool = True) -> _Acc:
    """One (q-chunk, kv-chunk) flash step, all in f32.  masked=False is the
    interior path: the caller proved every (q, kv) pair of the block valid.
    A row masked whole in a block gets p = exp(0) there while its running
    max is still NEG_INF; its first valid block rescales that by exp(NEG_INF
    - max) = 0, as in the reference, so no NaN arises."""
    s = _block_scores(q, k_blk, scale, cap)                       # [B,KV,G,Cq,Ck]
    if masked:
        mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                          device=s.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(acc.m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(acc.m - m_new)
    l_new = acc.l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_blk.dtype).float(),
                      v_blk.float())
    return _Acc(m_new, l_new, acc.o * corr[..., None] + pv)


def flash_q_chunk(cfg: ModelConfig, q, k, v, q_start: int, *, causal, window):
    """Flash for one query chunk [B,Cq,H,Dh] starting at position q_start
    against the full [B,Skv,KV,Dh] k/v, KV block by KV block."""
    B, Cq, H, Dh = q.shape
    KV = cfg.n_kv_heads
    G = H // KV
    Ck = _fit_chunk(k.shape[1], cfg.attn_kv_chunk)
    qg = q.reshape(B, Cq, KV, G, Dh)
    q_pos = q_start + torch.arange(Cq, device=q.device)
    scale, cap = _scale(cfg), cfg.attn_softcap
    acc = _Acc(
        m=torch.full((B, KV, G, Cq), NEG_INF, dtype=torch.float32, device=q.device),
        l=torch.zeros((B, KV, G, Cq), dtype=torch.float32, device=q.device),
        o=torch.zeros((B, KV, G, Cq, Dh), dtype=torch.float32, device=q.device),
    )
    for j in range(k.shape[1] // Ck):
        lo, hi = j * Ck, (j + 1) * Ck - 1          # the block's first, last kv
        needed = interior = True
        if causal:   # block wholly above the diagonal: skip
            needed &= lo <= q_start + Cq - 1
            interior &= hi <= q_start
        if window > 0:   # block wholly left of the window: skip
            needed &= hi >= q_start - window + 1
            interior &= (q_start + Cq - 1) - lo < window
        if not needed:
            continue
        acc = flash_kv_block(qg, k[:, lo:hi + 1], v[:, lo:hi + 1], acc,
                             q_pos=q_pos,
                             kv_pos=torch.arange(lo, hi + 1, device=q.device),
                             causal=causal, window=window, scale=scale,
                             cap=cap, masked=not interior)
    out = acc.o / acc.l.clamp(min=1e-30)[..., None]
    return out.reshape(B, KV * G, Cq, Dh).transpose(1, 2).to(cfg.compute_dtype)


def flash_attention(cfg: ModelConfig, q, k, v, *, causal=True, window=0):
    """q: [B,S,H,Dh], k/v: [B,Skv,KV,Dh] -> [B,S,H,Dh], query chunk by
    query chunk (the largest divisor of S up to cfg.attn_q_chunk).  The
    reference also checkpoints each query chunk under remat; here the
    unit's checkpoint (`transformer._maybe_remat`) covers it."""
    S = q.shape[1]
    Cq = _fit_chunk(S, cfg.attn_q_chunk)
    outs = [flash_q_chunk(cfg, q[:, i:i + Cq], k, v, i, causal=causal,
                          window=window) for i in range(0, S, Cq)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Cached decode attention (one new token)
# ---------------------------------------------------------------------------

def decode_attention(cfg: ModelConfig, q, k_cache, v_cache, cur_pos, *,
                     window=0, slot_pos=None):
    """q: [B,1,H,Dh]; caches: [B,Smax,KV,Dh]; cur_pos: [B] absolute positions.

    `slot_pos` [B,Smax] gives the absolute position stored in each cache slot
    (ring buffers for local layers); defaults to arange (linear cache).
    """
    B, _, H, Dh = q.shape
    KV, G = cfg.n_kv_heads, H // cfg.n_kv_heads
    Smax = k_cache.shape[1]
    if slot_pos is None:
        slot_pos = torch.arange(Smax, device=q.device).expand(B, Smax)
    qg = q.reshape(B, 1, KV, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * _scale(cfg)
    s = softcap(s, cfg.attn_softcap)
    # slot_pos < 0 marks ring-buffer slots not yet written
    valid = (slot_pos <= cur_pos[:, None]) & (slot_pos >= 0)   # [B, Smax]
    if window > 0:
        valid &= (cur_pos[:, None] - slot_pos) < window
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, KV * G, 1, Dh).transpose(1, 2).to(cfg.compute_dtype)


def out_proj(cfg: ModelConfig, p: dict, attn_out: torch.Tensor,
             ctx: ShardCtx = NULL_CTX, local: bool = False) -> torch.Tensor:
    """attn_out [B, S, n, Dh] @ wo.  `local`: the rank's own heads against
    its rows of wo, summed over 'model'; all heads against rows of wo
    split over 'model': the rank's channels, summed likewise."""
    B, S = attn_out.shape[:2]
    flat = attn_out.reshape(B, S, -1)
    wo = p["wo"].to(cfg.compute_dtype)
    if wo.shape[0] == flat.shape[-1]:
        out = flat @ wo
        return ctx.reduce(out) if local else out
    return ctx.reduce(ctx.split(flat, -1) @ wo)


def project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
                ctx: ShardCtx = NULL_CTX, kv_x: torch.Tensor | None = None):
    """(q [B,S,n,Dh], k, v [B,Skv,nkv,Dh], the cfg of their heads, local):
    the rank's own heads (local=True) where its column slices of wq and
    wk/wv are whole heads of aligned GQA groups, else every head (the
    split projections gathered over 'model').  `kv_x` is the keys' and
    values' input where it is not x (a cross-attention's encoder output)."""
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wq, wk, wv = (p[k].to(cfg.compute_dtype) for k in ("wq", "wk", "wv"))
    kx = x if kv_x is None else kv_x
    if wq.shape[-1] == H * Dh and wk.shape[-1] == KV * Dh:
        q = _q_heads(cfg, p, x @ wq, positions)
        return (q, *_kv_heads(cfg, p, kx @ wk, kx @ wv, positions), cfg, False)
    xin = ctx.copy(x)
    kin = xin if kv_x is None else ctx.copy(kv_x)
    m = H * Dh // wq.shape[-1]
    if (wq.shape[-1] * m == H * Dh and wk.shape[-1] * m == KV * Dh
            and H % m == 0 and KV % m == 0):
        # the qk-norm scales act on the rank's heads only: their gradient
        # sums over 'model'
        p = {k: ctx.copy(v) if k in ("q_norm", "k_norm") else v
             for k, v in p.items()}
        q = _q_heads(cfg, p, xin @ wq, positions)
        k, v = _kv_heads(cfg, p, kin @ wk, kin @ wv, positions)
        return q, k, v, cfg.replace(n_heads=H // m, n_kv_heads=KV // m), True

    def proj(w, full, src, src_in):
        return src @ w if w.shape[-1] == full else ctx.gather(src_in @ w, -1)
    q = _q_heads(cfg, p, proj(wq, H * Dh, x, xin), positions)
    k, v = _kv_heads(cfg, p, proj(wk, KV * Dh, kx, kin),
                     proj(wv, KV * Dh, kx, kin), positions)
    return q, k, v, cfg, False


def cache_split(cfg: ModelConfig, smax: int, ctx: ShardCtx):
    """How a [B, smax, KV, Dh] cache splits over 'model' (the rules' own
    order: kv_seq claims 'model' first): (slot lo, slots, head lo,
    heads) of this rank."""
    KV = cfg.n_kv_heads
    if ctx.model_split("kv_seq", smax):
        n = smax // ctx.mesh["model"].size()
        return ctx.model_lo(n), n, 0, KV
    if ctx.model_split("kv_heads", KV):
        n = KV // ctx.mesh["model"].size()
        return 0, smax, ctx.model_lo(n), n
    return 0, smax, 0, KV


# ---------------------------------------------------------------------------
# Full blocks
# ---------------------------------------------------------------------------

def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
                   causal=True, window=0, ctx: ShardCtx = NULL_CTX):
    q, k, v, hcfg, local = project_qkv(cfg, p, x, positions, ctx)
    o = flash_attention(hcfg, q, k, v, causal=causal, window=window)
    return out_proj(cfg, p, o, ctx, local)


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    enc: torch.Tensor, ctx: ShardCtx = NULL_CTX):
    """The decoder's cross-attention (whisper): queries from x [B,S,d],
    keys and values from the encoder output enc [B,Se,d]; no rope (the
    cross specs have no qk-norm), no mask.  Under a mesh tensor parallel
    as `self_attention` is."""
    q, k, v, hcfg, local = project_qkv(cfg, p, x, None, ctx, kv_x=enc)
    o = flash_attention(hcfg, q, k, v, causal=False, window=0)
    return out_proj(cfg, p, o, ctx, local)


def cross_attention_decode(cfg: ModelConfig, p: dict, x, enc_kv: dict,
                           ctx: ShardCtx = NULL_CTX):
    """Cross-attention of one decode token x [B,1,d] over the encoder K/V
    projected once at prefill ({'k','v': [B,Se,KV,Dh]}).  Under a mesh
    the K/V are this rank's split of them (`cache_split` of Se =
    cfg.enc_seq): along the encoder positions, each rank attends over its
    own and the partial softmaxes merge (`_merged_decode`, every slot
    valid), else by kv heads."""
    B, H, KV, Dh = x.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # a split's length does not tell whether the positions were split:
    # under a mesh the whole length is the config's
    Se = cfg.enc_seq if ctx.on else enc_kv["k"].shape[1]
    s_lo, n_s, h_lo, n_h = cache_split(cfg, Se, ctx)
    wq = p["wq"].to(cfg.compute_dtype)
    qf = x @ wq if wq.shape[-1] == H * Dh else ctx.gather(x @ wq, -1)
    q = _q_heads(cfg, p, qf, None, rope=False)           # every head
    G = H // KV
    qh = q[:, :, h_lo * G:(h_lo + n_h) * G]
    hcfg = cfg if n_h == KV else cfg.replace(n_heads=n_h * G, n_kv_heads=n_h)
    cur = torch.full((B,), Se - 1, device=x.device)
    slot_pos = torch.arange(s_lo, s_lo + n_s, device=x.device).expand(B, n_s)
    if n_s < Se:
        o = _merged_decode(hcfg, qh, enc_kv["k"], enc_kv["v"], cur, 0,
                           slot_pos, ctx)
    else:
        o = decode_attention(hcfg, qh, enc_kv["k"], enc_kv["v"], cur)
    if n_h < KV:
        o = ctx.gather(o, 2)
    return out_proj(cfg, p, o, ctx)


def ring_slot_pos(pos: torch.Tensor, smax: int) -> torch.Tensor:
    """[B] current positions -> [B, smax] the absolute position held in each
    slot of a ring buffer where position p lives at slot p % smax: the
    largest p' <= pos with p' % smax == i (negative: never written)."""
    idx = torch.arange(smax, device=pos.device)
    return pos[:, None] - ((pos[:, None] - idx[None, :]) % smax)


def self_attention_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos, *,
                          window=0, ctx: ShardCtx = NULL_CTX):
    """x: [B,1,d]; cache: {'k','v': [B,Smax,KV,Dh]}  pos: [B] int.

    Returns (out [B,1,d], new_cache); the cache passed in is not modified.
    Local layers use a ring buffer (slot = pos % Smax), global layers a
    linear cache (slot = min(pos, Smax - 1), the reference's clamp).
    Under a mesh the cache is this rank's split of it (`cache_split`):
    every head's new K/V is written by the rank that holds its slot, and a
    rank attends over its slots (merging the partial softmaxes over
    'model') or its kv heads (gathering the heads' outputs)."""
    B, dt = x.shape[0], cache["k"].dtype
    # a split's length does not tell whether the sequence was split (6
    # slots split 2 ways and 3 slots whole both leave 3): under a mesh the
    # whole length is the ctx's
    if not ctx.on:
        smax = cache["k"].shape[1]
    else:
        smax = min(ctx.seq, window) if window > 0 else ctx.seq
    s_lo, n_s, h_lo, n_h = cache_split(cfg, smax, ctx)
    pos = pos.long()
    q, k_new, v_new, _, local = project_qkv(cfg, p, x, pos[:, None], ctx)
    if local:
        q, k_new, v_new = (ctx.gather(t, 2) for t in (q, k_new, v_new))
    G = cfg.n_heads // cfg.n_kv_heads
    slot = (pos % smax if window > 0 else pos.clamp(max=smax - 1)) - s_lo
    own = ((slot >= 0) & (slot < n_s))[:, None, None]
    slot = slot.clamp(0, n_s - 1)
    rows = torch.arange(B, device=x.device)

    def write(c, new):
        new = new[:, 0, h_lo:h_lo + n_h].to(dt)
        if n_s < smax:      # only the slot's rank writes it
            new = torch.where(own, new, c[rows, slot])
        return c.index_put((rows, slot), new)
    k_cache, v_cache = write(cache["k"], k_new), write(cache["v"], v_new)
    slot_pos = (ring_slot_pos(pos, smax) if window > 0 else
                torch.arange(smax, device=x.device).expand(B, smax))
    slot_pos = slot_pos[:, s_lo:s_lo + n_s]
    hcfg = cfg if n_h == cfg.n_kv_heads else \
        cfg.replace(n_heads=n_h * G, n_kv_heads=n_h)
    qh = q[:, :, h_lo * G:(h_lo + n_h) * G]
    if n_s < smax:
        o = _merged_decode(hcfg, qh, k_cache, v_cache, pos, window, slot_pos,
                           ctx)
    else:
        o = decode_attention(hcfg, qh, k_cache, v_cache, pos, window=window,
                             slot_pos=slot_pos)
    if n_h < cfg.n_kv_heads:
        o = ctx.gather(o, 2)
    return out_proj(cfg, p, o, ctx), {"k": k_cache, "v": v_cache}


def _merged_decode(cfg, q, k_cache, v_cache, cur_pos, window, slot_pos, ctx):
    """`decode_attention` over this rank's slots of a cache split along
    the sequence: the max over 'model', then this rank's exp-sums and
    P.V, summed over 'model' in one all_reduce."""
    B, _, H, Dh = q.shape
    KV, G = cfg.n_kv_heads, H // cfg.n_kv_heads
    qg = q.reshape(B, 1, KV, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * _scale(cfg)
    s = softcap(s, cfg.attn_softcap)
    valid = (slot_pos <= cur_pos[:, None]) & (slot_pos >= 0)
    if window > 0:
        valid &= (cur_pos[:, None] - slot_pos) < window
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = ctx.model_max(s.amax(dim=-1, keepdim=True))
    e = torch.exp(s - m)
    o = torch.einsum("bkgqs,bskd->bkgqd", e.to(v_cache.dtype).float(),
                     v_cache.float())
    lo = C.all_reduce(torch.cat([e.sum(dim=-1)[..., None], o], dim=-1),
                       ctx.mesh, "model")
    o = lo[..., 1:] / lo[..., :1]
    return o.reshape(B, KV * G, 1, Dh).transpose(1, 2).to(cfg.compute_dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0,
                  device=None) -> dict:
    smax = min(seq, window) if window > 0 else seq
    shape = (batch, smax, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
