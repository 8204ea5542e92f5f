"""Encoder-decoder transformer (the whisper-large-v3 backbone), in PyTorch.

Counterpart of `repro.models.encdec`.  The conv/mel audio frontend is a
stub: the model takes precomputed frame embeddings [B, enc_seq, d_model]
(what whisper's two conv layers would emit).  Positions are sinusoidal.
With ``cfg.scan_layers`` the encoder's and the decoder's layers are
stacked ``[L, ...]`` tensors (the reference's tree) and the decode cache
too; otherwise lists.

Serving: `prefill(cfg, params, tokens, frames, max_seq=N)` encodes the
frames, projects every decoder layer's cross K/V from them once (the cache
`decode_step` reads), and fills the self-attention caches at slots 0..S-1
of N (default S).  `decode_step` adds the sinusoid of each example's own
position.  So a prefill of S tokens with max_seq S + n followed by n
decode steps equals the full forward over S + n.  The reference adds the
position-0 sinusoid to every decode token (ROADMAP Queue 3, fault 10) and
sizes the self cache to exactly S, so its first decode overwrites the last
prompt token's slot (fault 11).

`loss_fn`, `prefill` and `decode_step` take a `ShardCtx`: under a mesh
they run on this rank's rows of the tokens and frames (explicit SPMD, as
`models.transformer` does).  Each layer's weights are gathered for use
over their storage-only dims as it runs (inside its remat); the encoder's
and the decoder's attention (self and cross) and MLPs are tensor-parallel
over 'model'; the embedding, the logits and the cross entropy are
vocab-parallel.  The decode caches split as `sharding.cache_shardings`
splits them: the self cache and the cross K/V (both rank-4 `k`/`v`
leaves) along the sequence over 'model' where it divides, so the cross
K/V of the 1,500 encoder positions are 750 a rank at 'model' 2, and a
decode merges the ranks' partial softmaxes.
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_tokens, embedding_specs,
                                       lm_logits, mlp, mlp_specs,
                                       rmsnorm_spec, sinusoid_at,
                                       sinusoidal_pos_emb)
from repro_torch.models.module import NULL_CTX, ShardCtx, stack_specs
from repro_torch.models.transformer import (_fill, _maybe_remat, _norm,
                                            chunked_ce_loss)
from repro_torch.tree import stack, unstack


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln_attn": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": attn.attn_specs(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln_self": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "self_attn": attn.attn_specs(cfg),
        "ln_cross": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "cross_attn": attn.attn_specs(cfg, cross=True),
        "ln_mlp": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": mlp_specs(cfg),
    }


def encdec_specs(cfg: ModelConfig) -> dict:
    specs: dict[str, Any] = {"emb": embedding_specs(cfg)}
    if cfg.scan_layers:
        specs["enc"] = stack_specs(enc_layer_specs(cfg), cfg.enc_layers,
                                   "layers")
        specs["dec"] = stack_specs(dec_layer_specs(cfg), cfg.n_layers,
                                   "layers")
    else:
        specs["enc"] = [enc_layer_specs(cfg) for _ in range(cfg.enc_layers)]
        specs["dec"] = [dec_layer_specs(cfg) for _ in range(cfg.n_layers)]
    specs["ln_enc_f"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    specs["ln_f"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    return specs


def _layers(cfg: ModelConfig, tree, n: int) -> list:
    """Per-layer views of stacked [n, ...] layers (or a stacked cache)."""
    return unstack(tree, n) if cfg.scan_layers else list(tree)


def _restack(cfg: ModelConfig, per_layer: list):
    return stack(per_layer) if cfg.scan_layers else per_layer


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def enc_layer(cfg: ModelConfig, p: dict, x: torch.Tensor,
              ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    if ctx.on:
        p = ctx.use(p, enc_layer_specs(cfg))
    h = attn.self_attention(cfg, p["attn"], _norm(cfg, p["ln_attn"], x),
                            None, causal=False, window=0, ctx=ctx)
    x = x + h
    return x + mlp(cfg, p["mlp"], _norm(cfg, p["ln_mlp"], x), ctx)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           ctx: ShardCtx = NULL_CTX):
    """frames: [B, enc_seq, d_model] (the stub frontend's output) ->
    the encoder's final-norm output.  `params`' top-level leaves are for
    use already under a mesh (`_top`)."""
    x = frames.to(cfg.compute_dtype)
    x = x + sinusoidal_pos_emb(x.shape[1], cfg.d_model, cfg.compute_dtype,
                               x.device)[None]
    layer_fn = _maybe_remat(cfg, functools.partial(enc_layer, cfg, ctx=ctx))
    for lp in _layers(cfg, params["enc"], cfg.enc_layers):
        x = layer_fn(lp, x)
    return _norm(cfg, params["ln_enc_f"], x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def dec_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, enc: torch.Tensor,
              positions, ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    if ctx.on:
        p = ctx.use(p, dec_layer_specs(cfg))
    h = attn.self_attention(cfg, p["self_attn"], _norm(cfg, p["ln_self"], x),
                            positions, causal=True, window=0, ctx=ctx)
    x = x + h
    x = x + attn.cross_attention(cfg, p["cross_attn"],
                                 _norm(cfg, p["ln_cross"], x), enc, ctx)
    return x + mlp(cfg, p["mlp"], _norm(cfg, p["ln_mlp"], x), ctx)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           ctx: ShardCtx = NULL_CTX):
    x = embed_tokens(cfg, params["emb"], tokens, ctx)
    return x + sinusoidal_pos_emb(tokens.shape[1], cfg.d_model,
                                  cfg.compute_dtype, x.device)[None]


def _top(cfg: ModelConfig, params: dict, ctx: ShardCtx) -> dict:
    """The top-level leaves for use; the layers are gathered one at a time
    as they run."""
    return ctx.use_top(params, lambda: encdec_specs(cfg), ("enc", "dec"))


def decode_train(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 enc: torch.Tensor, ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """Teacher-forced decoder over tokens [B,S] -> final-norm hidden states."""
    x = _embed(cfg, params, tokens, ctx)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    layer_fn = _maybe_remat(cfg, functools.partial(dec_layer, cfg, ctx=ctx))
    for lp in _layers(cfg, params["dec"], cfg.n_layers):
        x = layer_fn(lp, x, enc, positions)
    return _norm(cfg, params["ln_f"], x)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            ctx: ShardCtx = NULL_CTX):
    """batch: frames [B,enc_seq,d], tokens [B,S], labels [B,S] (-1 masked)."""
    params = _top(cfg, params, ctx)
    enc = encode(cfg, params, batch["frames"], ctx)
    h = decode_train(cfg, params, batch["tokens"], enc, ctx)
    return chunked_ce_loss(cfg, params, h, batch["labels"], ctx=ctx)


def forward_logits(cfg: ModelConfig, params: dict, tokens, frames,
                   start: int = 0) -> torch.Tensor:
    """The full forward's f32 logits at positions start..S-1 [B, S-start, V]
    (the yardstick of prefill and decode)."""
    h = decode_train(cfg, params, tokens, encode(cfg, params, frames))
    return lm_logits(cfg, params["emb"], h[:, start:])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Any:
    """Zero caches: per decoder layer {'self': seq slots, 'cross': enc_seq
    slots}, each {'k', 'v': [B, slots, KV, Dh]}; stacked [L, ...] with
    cfg.scan_layers, else a list."""
    return _restack(cfg, [
        {"self": attn.init_kv_cache(cfg, batch, seq, device=device),
         "cross": attn.init_kv_cache(cfg, batch, cfg.enc_seq, device=device)}
        for _ in range(cfg.n_layers)])


def dec_layer_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos,
                     ctx: ShardCtx = NULL_CTX):
    if ctx.on:
        p = ctx.use(p, dec_layer_specs(cfg))
    h, self_c = attn.self_attention_decode(
        cfg, p["self_attn"], _norm(cfg, p["ln_self"], x), cache["self"], pos,
        ctx=ctx)
    x = x + h
    x = x + attn.cross_attention_decode(
        cfg, p["cross_attn"], _norm(cfg, p["ln_cross"], x), cache["cross"],
        ctx)
    x = x + mlp(cfg, p["mlp"], _norm(cfg, p["ln_mlp"], x), ctx)
    return x, {"self": self_c, "cross": cache["cross"]}


def decode_step(cfg: ModelConfig, params: dict, token, cache, pos,
                ctx: ShardCtx = NULL_CTX):
    """token: [B,1] int; pos: [B] int -> (logits [B,V] f32, new_cache).
    The token's sinusoid is taken at its own position pos[b].  Under a
    mesh: this rank's rows, its vocab slice of the logits, and its split of
    the caches (`ctx.seq` the self cache's whole length)."""
    params = _top(cfg, params, ctx)
    x = embed_tokens(cfg, params["emb"], token, ctx)
    x = x + sinusoid_at(pos, cfg.d_model, cfg.compute_dtype)[:, None]
    new_cache = []
    for lp, lc in zip(_layers(cfg, params["dec"], cfg.n_layers),
                      _layers(cfg, cache, cfg.n_layers)):
        x, nc = dec_layer_decode(cfg, lp, x, lc, pos, ctx)
        new_cache.append(nc)
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h, ctx)[:, 0], \
        _restack(cfg, new_cache)


def _prefill_layer(cfg: ModelConfig, lp: dict, x, enc, positions, max_seq,
                   ctx: ShardCtx):
    """One decoder layer over the prompt: (x, its cache: the self K/V in
    max_seq slots and the cross K/V, projected here once for this prompt
    and every decode step after it; under a mesh the rank's split of
    them)."""
    if ctx.on:
        lp = ctx.use(lp, dec_layer_specs(cfg))
    h = _norm(cfg, lp["ln_self"], x)
    q, k, v, hcfg, local = attn.project_qkv(cfg, lp["self_attn"], h,
                                            positions, ctx)
    self_c = {n: _fill(cfg, ctx.gather(t, 2) if local else t, max_seq, ctx)
              for n, t in (("k", k), ("v", v))}
    o = attn.flash_attention(hcfg, q, k, v, causal=True)
    x = x + attn.out_proj(cfg, lp["self_attn"], o, ctx, local)
    cq, ck, cv, hcfg, local = attn.project_qkv(
        cfg, lp["cross_attn"], _norm(cfg, lp["ln_cross"], x), None, ctx,
        kv_x=enc)
    cross = {n: _fill(cfg, ctx.gather(t, 2) if local else t, cfg.enc_seq,
                      ctx) for n, t in (("k", ck), ("v", cv))}
    o = attn.flash_attention(hcfg, cq, ck, cv, causal=False)
    x = x + attn.out_proj(cfg, lp["cross_attn"], o, ctx, local)
    x = x + mlp(cfg, lp["mlp"], _norm(cfg, lp["ln_mlp"], x), ctx)
    return x, {"self": self_c, "cross": cross}


def prefill(cfg: ModelConfig, params: dict, tokens, frames, *,
            max_seq: int | None = None, ctx: ShardCtx = NULL_CTX):
    """Encode the frames and run the decoder over the prompt tokens [B,S].
    Returns (next-token logits [B,V] f32, the cache: the self K/V at slots
    0..S-1 of max_seq (default S), the cross K/V projected once).  Under a
    mesh: this rank's rows, its vocab slice of the logits and its split of
    the caches."""
    S = tokens.shape[1]
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"prefill: max_seq {max_seq} < the prompt's {S}")
    params = _top(cfg, params, ctx)
    enc = encode(cfg, params, frames, ctx)
    x = _embed(cfg, params, tokens, ctx)
    positions = torch.arange(S, device=tokens.device)
    cache = []
    for lp in _layers(cfg, params["dec"], cfg.n_layers):
        x, c = _prefill_layer(cfg, lp, x, enc, positions, max_seq, ctx)
        cache.append(c)
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h[:, -1:], ctx)[:, 0], \
        _restack(cfg, cache)
