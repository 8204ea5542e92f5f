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
from repro_torch.models.module import stack_specs
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

def enc_layer(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = attn.self_attention(cfg, p["attn"], _norm(cfg, p["ln_attn"], x),
                            None, causal=False, window=0)
    x = x + h
    return x + mlp(cfg, p["mlp"], _norm(cfg, p["ln_mlp"], x))


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor):
    """frames: [B, enc_seq, d_model] (the stub frontend's output) ->
    the encoder's final-norm output."""
    x = frames.to(cfg.compute_dtype)
    x = x + sinusoidal_pos_emb(x.shape[1], cfg.d_model, cfg.compute_dtype,
                               x.device)[None]
    layer_fn = _maybe_remat(cfg, functools.partial(enc_layer, cfg))
    for lp in _layers(cfg, params["enc"], cfg.enc_layers):
        x = layer_fn(lp, x)
    return _norm(cfg, params["ln_enc_f"], x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def dec_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, enc: torch.Tensor,
              positions) -> torch.Tensor:
    h = attn.self_attention(cfg, p["self_attn"], _norm(cfg, p["ln_self"], x),
                            positions, causal=True, window=0)
    x = x + h
    x = x + attn.cross_attention(cfg, p["cross_attn"],
                                 _norm(cfg, p["ln_cross"], x), enc)
    return x + mlp(cfg, p["mlp"], _norm(cfg, p["ln_mlp"], x))


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    x = embed_tokens(cfg, params["emb"], tokens)
    return x + sinusoidal_pos_emb(tokens.shape[1], cfg.d_model,
                                  cfg.compute_dtype, x.device)[None]


def decode_train(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 enc: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder over tokens [B,S] -> final-norm hidden states."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    layer_fn = _maybe_remat(cfg, functools.partial(dec_layer, cfg))
    for lp in _layers(cfg, params["dec"], cfg.n_layers):
        x = layer_fn(lp, x, enc, positions)
    return _norm(cfg, params["ln_f"], x)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: frames [B,enc_seq,d], tokens [B,S], labels [B,S] (-1 masked)."""
    enc = encode(cfg, params, batch["frames"])
    h = decode_train(cfg, params, batch["tokens"], enc)
    return chunked_ce_loss(cfg, params, h, batch["labels"])


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


def dec_layer_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos):
    h, self_c = attn.self_attention_decode(
        cfg, p["self_attn"], _norm(cfg, p["ln_self"], x), cache["self"], pos)
    x = x + h
    x = x + attn.cross_attention_decode(
        cfg, p["cross_attn"], _norm(cfg, p["ln_cross"], x), cache["cross"])
    x = x + mlp(cfg, p["mlp"], _norm(cfg, p["ln_mlp"], x))
    return x, {"self": self_c, "cross": cache["cross"]}


def decode_step(cfg: ModelConfig, params: dict, token, cache, pos):
    """token: [B,1] int; pos: [B] int -> (logits [B,V] f32, new_cache).
    The token's sinusoid is taken at its own position pos[b]."""
    x = embed_tokens(cfg, params["emb"], token)
    x = x + sinusoid_at(pos, cfg.d_model, cfg.compute_dtype)[:, None]
    new_cache = []
    for lp, lc in zip(_layers(cfg, params["dec"], cfg.n_layers),
                      _layers(cfg, cache, cfg.n_layers)):
        x, nc = dec_layer_decode(cfg, lp, x, lc, pos)
        new_cache.append(nc)
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h)[:, 0], _restack(cfg, new_cache)


def prefill(cfg: ModelConfig, params: dict, tokens, frames, *,
            max_seq: int | None = None):
    """Encode the frames and run the decoder over the prompt tokens [B,S].
    Returns (next-token logits [B,V] f32, the cache: the self K/V at slots
    0..S-1 of max_seq (default S), the cross K/V projected once)."""
    S = tokens.shape[1]
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"prefill: max_seq {max_seq} < the prompt's {S}")
    enc = encode(cfg, params, frames)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)
    cache = []
    for lp in _layers(cfg, params["dec"], cfg.n_layers):
        h = _norm(cfg, lp["ln_self"], x)
        q = attn.project_q(cfg, lp["self_attn"], h, positions)
        k, v = attn.project_kv(cfg, lp["self_attn"], h, positions)
        self_c = {"k": _fill(cfg, k, max_seq), "v": _fill(cfg, v, max_seq)}
        o = attn.flash_attention(cfg, q, k, v, causal=True)
        x = x + attn.out_proj(cfg, lp["self_attn"], o)
        # the cross K/V depend on the encoder output only: projected here
        # once, for this prompt and every decode step after it
        ck, cv = attn.project_kv(cfg, lp["cross_attn"], enc, None, rope=False)
        cq = attn.project_q(cfg, lp["cross_attn"],
                            _norm(cfg, lp["ln_cross"], x), None, rope=False)
        o = attn.flash_attention(cfg, cq, ck, cv, causal=False)
        x = x + attn.out_proj(cfg, lp["cross_attn"], o)
        x = x + mlp(cfg, lp["mlp"], _norm(cfg, lp["ln_mlp"], x))
        cache.append({"self": self_c, "cross": {"k": ck, "v": cv}})
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h[:, -1:])[:, 0], _restack(cfg, cache)
