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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rmsnorm, softcap
from repro_torch.models.module import ParamSpec, fan_in_normal, ones_init

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


def project_q(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
              rope: bool = True) -> torch.Tensor:
    """-> [B, S, H, Dh]"""
    q = x @ p["wq"].to(cfg.compute_dtype)
    q = q.reshape(*q.shape[:-1], cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm and "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def project_kv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
               rope: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """-> k, v: [B, Skv, KV, Dh]"""
    dt = cfg.compute_dtype
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    k = k.reshape(*k.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(*v.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
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


def out_proj(cfg: ModelConfig, p: dict, attn_out: torch.Tensor) -> torch.Tensor:
    B, S = attn_out.shape[:2]
    flat = attn_out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return flat @ p["wo"].to(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Full blocks
# ---------------------------------------------------------------------------

def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
                   causal=True, window=0):
    q = project_q(cfg, p, x, positions)
    k, v = project_kv(cfg, p, x, positions)
    return out_proj(cfg, p, flash_attention(cfg, q, k, v, causal=causal,
                                            window=window))


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    enc: torch.Tensor):
    """The decoder's cross-attention (whisper): queries from x [B,S,d],
    keys and values from the encoder output enc [B,Se,d]; no rope, no
    mask."""
    q = project_q(cfg, p, x, None, rope=False)
    k, v = project_kv(cfg, p, enc, None, rope=False)
    return out_proj(cfg, p, flash_attention(cfg, q, k, v, causal=False,
                                            window=0))


def cross_attention_decode(cfg: ModelConfig, p: dict, x, enc_kv: dict):
    """Cross-attention of one decode token x [B,1,d] over the encoder K/V
    projected once at prefill ({'k','v': [B,Se,KV,Dh]})."""
    B, Se = x.shape[0], enc_kv["k"].shape[1]
    q = project_q(cfg, p, x, None, rope=False)
    o = decode_attention(cfg, q, enc_kv["k"], enc_kv["v"],
                         torch.full((B,), Se - 1, device=x.device))
    return out_proj(cfg, p, o)


def ring_slot_pos(pos: torch.Tensor, smax: int) -> torch.Tensor:
    """[B] current positions -> [B, smax] the absolute position held in each
    slot of a ring buffer where position p lives at slot p % smax: the
    largest p' <= pos with p' % smax == i (negative: never written)."""
    idx = torch.arange(smax, device=pos.device)
    return pos[:, None] - ((pos[:, None] - idx[None, :]) % smax)


def self_attention_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos, *,
                          window=0):
    """x: [B,1,d]; cache: {'k','v': [B,Smax,KV,Dh]}  pos: [B] int.

    Returns (out [B,1,d], new_cache); the cache passed in is not modified.
    Local layers use a ring buffer (slot = pos % Smax), global layers a
    linear cache (slot = min(pos, Smax - 1), the reference's clamp)."""
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    pos = pos.long()
    slot = pos % Smax if window > 0 else pos.clamp(max=Smax - 1)
    k_new, v_new = project_kv(cfg, p, x, pos[:, None])
    rows = torch.arange(B, device=x.device)
    k_cache = cache["k"].index_put((rows, slot), k_new[:, 0].to(cache["k"].dtype))
    v_cache = cache["v"].index_put((rows, slot), v_new[:, 0].to(cache["v"].dtype))
    slot_pos = ring_slot_pos(pos, Smax) if window > 0 else None
    q = project_q(cfg, p, x, pos[:, None])
    o = decode_attention(cfg, q, k_cache, v_cache, pos, window=window,
                         slot_pos=slot_pos)
    return out_proj(cfg, p, o), {"k": k_cache, "v": v_cache}


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, window: int = 0,
                  device=None) -> dict:
    smax = min(seq, window) if window > 0 else seq
    shape = (batch, smax, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
