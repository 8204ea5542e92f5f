"""Decoder-only transformer LM family, in PyTorch.

Counterpart of `repro.models.transformer`: olmoe-1b-7b and kimi-k2
(MoE, `models/moe.py`), qwen3-8b, gemma2-2b (local/global alternating,
softcaps), minitron-8b, yi-6b (dense) and internvl2-2b (the VLM backbone
with stubbed patch embeddings prepended).  A MoE layer adds its
load-balance loss, summed over the layers, to the training loss (CE +
0.01 * aux); serving drops it.

Layers are grouped into a repeating *unit* (1 layer, or a (local, global)
pair for gemma2).  With ``cfg.scan_layers`` the units' parameters (and the
decode cache) are stacked ``[U, ...]`` tensors, the reference's tree, and
the loop over units is a Python loop; otherwise ``units`` is a list.  The
remat policy wraps the unit.

`prefill(..., max_seq=N)` leaves room to decode: global layers get a cache
of N slots with positions 0..S-1 filled, local layers a ring of
min(N, window) slots holding position p at slot p % smax, the slot that
`decode_step` reads it from.  So a prefill of S tokens with max_seq S + n
followed by n decode steps equals the full forward over S + n.  The
reference sizes the cache to exactly S and stores a local layer's last
smax keys at slots 0..smax-1 (ROADMAP Queue 3, fault 7); with max_seq = S
the global caches are the reference's.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (embed_tokens, embedding_specs, lm_logits,
                                       mlp, mlp_specs, rmsnorm, rmsnorm_spec)
from repro_torch.models.module import ParamSpec, fan_in_normal, stack_specs
from repro_torch.tree import stack, unstack

# the "dots" remat policy saves the outputs of the unbatched matmuls (the
# projections and the MLP: jax's dots_with_no_batch_dims_saveable) and
# recomputes everything else
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def layer_specs(cfg: ModelConfig) -> dict:
    specs = {
        "ln_attn": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": attn.attn_specs(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": moe_lib.moe_specs(cfg) if cfg.moe else mlp_specs(cfg),
    }
    if cfg.sandwich_norm:
        specs["ln_attn_post"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
        specs["ln_mlp_post"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    return specs


def unit_layout(cfg: ModelConfig) -> list[str]:
    """Layer kinds inside one repeating unit."""
    if cfg.layer_pattern == "local_global":
        return ["local", "global"]
    return ["global"]


def n_units(cfg: ModelConfig) -> int:
    u = len(unit_layout(cfg))
    if cfg.n_layers % u:
        raise ValueError(f"{cfg.n_layers} layers do not form units of {u}")
    return cfg.n_layers // u


def unit_specs(cfg: ModelConfig) -> dict:
    return {kind: layer_specs(cfg) for kind in unit_layout(cfg)}


def decoder_specs(cfg: ModelConfig) -> dict:
    specs: dict[str, Any] = {"emb": embedding_specs(cfg)}
    u = unit_specs(cfg)
    if cfg.scan_layers:
        specs["units"] = stack_specs(u, n_units(cfg), "layers")
    else:
        specs["units"] = [u for _ in range(n_units(cfg))]
    specs["ln_f"] = rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    if cfg.n_patches > 0:   # VLM projector (internvl2 mlp1: vit 4096 -> d)
        specs["vproj"] = {
            "w1": ParamSpec((4096, cfg.d_model), cfg.param_dtype, fan_in_normal(),
                            ("vit", "embed")),
            "w2": ParamSpec((cfg.d_model, cfg.d_model), cfg.param_dtype,
                            fan_in_normal(), ("embed", "embed")),
        }
    return specs


def _units(cfg: ModelConfig, tree) -> list:
    """Per-unit views of `units` (or of a unit-stacked cache)."""
    return unstack(tree, n_units(cfg)) if cfg.scan_layers else list(tree)


def _restack(cfg: ModelConfig, per_unit: list):
    """Per-unit caches in the cache layout: stacked [U, ...] or a list."""
    return stack(per_unit) if cfg.scan_layers else per_unit


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _norm(cfg, scale, x):
    return rmsnorm(x, scale, cfg.norm_eps, cfg.zero_centered_norm)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """The block's second half: (x + [post-norm] mlp(norm(x)), the MoE aux
    loss, 0 for a dense MLP)."""
    hin = _norm(cfg, lp["ln_mlp"], x)
    if cfg.moe:
        h, aux = moe_lib.moe_block(cfg, lp["mlp"], hin)
    else:
        h, aux = mlp(cfg, lp["mlp"], hin), _zero_aux(x)
    if cfg.sandwich_norm:
        h = _norm(cfg, lp["ln_mlp_post"], h)
    return x + h, aux


def _attn_residual(cfg: ModelConfig, lp: dict, x, h):
    if cfg.sandwich_norm:
        h = _norm(cfg, lp["ln_attn_post"], h)
    return x + h


def run_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, kind: str):
    """Pre-norm block; returns (x, aux_loss)."""
    window = cfg.local_window if kind == "local" else 0
    h = attn.self_attention(cfg, p["attn"], _norm(cfg, p["ln_attn"], x),
                            positions, causal=True, window=window)
    return _ffn(cfg, p, _attn_residual(cfg, p, x, h))


def run_unit(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    aux = _zero_aux(x)
    for kind in unit_layout(cfg):
        x, a = run_layer(cfg, p[kind], x, positions, kind)
        aux = aux + a
    return x, aux


def _maybe_remat(cfg: ModelConfig, fn, policy: str | None = None):
    """fn under the remat policy ('none' | 'full' | 'dots'; default
    cfg.remat), by `torch.utils.checkpoint` (non-reentrant).  A memory
    policy only: the recomputed forward is the same ops, so loss and
    gradients are bitwise the same under every policy.  Without grad mode
    nothing is saved anyway, and fn runs as it is."""
    policy = cfg.remat if policy is None else policy
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"remat {policy!r}")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _DOTS)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor, positions):
    """Embedded input -> (final-norm hidden states, aux_loss)."""
    unit_fn = _maybe_remat(cfg, functools.partial(run_unit, cfg))
    aux = _zero_aux(x)
    for up in _units(cfg, params["units"]):
        x, a = unit_fn(up, x, positions)
        aux = aux + a
    return _norm(cfg, params["ln_f"], x), aux


def embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 patch_embeds=None):
    """Token embedding; for the VLM, the first n_patches positions come from
    the (stubbed) vision frontend through the projector."""
    x = embed_tokens(cfg, params["emb"], tokens)
    if cfg.n_patches > 0 and patch_embeds is not None:
        dt = cfg.compute_dtype
        v = patch_embeds.to(dt) @ params["vproj"]["w1"].to(dt)
        v = F.gelu(v, approximate="tanh")
        v = v @ params["vproj"]["w2"].to(dt)
        x = torch.cat([v, x[:, cfg.n_patches:]], dim=1)
    return x


def forward_logits(cfg: ModelConfig, params: dict, tokens, patch_embeds=None,
                   start: int = 0) -> torch.Tensor:
    """The full forward's f32 logits at positions start..S-1 [B, S-start, V]
    (the yardstick of prefill and decode)."""
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _ = backbone(cfg, params, x, positions)
    return lm_logits(cfg, params["emb"], h[:, start:])


# ---------------------------------------------------------------------------
# Loss (sequence-chunked cross entropy)
# ---------------------------------------------------------------------------

def ce_chunk(cfg: ModelConfig, emb: dict, h_chunk: torch.Tensor, labels_chunk):
    """h: [B,C,d], labels: [B,C] (-1 = masked) -> (sum_nll, sum_z2, n_valid)."""
    logits = lm_logits(cfg, emb, h_chunk)                      # f32 [B,C,V]
    lse = torch.logsumexp(logits, dim=-1)
    lbl = labels_chunk.clamp(min=0).long()
    gold = logits.gather(-1, lbl[..., None])[..., 0]
    valid = (labels_chunk >= 0).float()
    nll = (lse - gold) * valid
    return nll.sum(), (lse.square() * valid).sum(), valid.sum()


def chunked_ce_loss(cfg: ModelConfig, params: dict, h: torch.Tensor, labels,
                    chunk: int = 512, z_loss: float = 1e-4):
    """Mean next-token CE plus z_loss * mean(lse^2), `chunk` positions at a
    time, each chunk checkpointed whole under either remat policy.  As in the
    reference, with S > chunk only the first (S // chunk) * chunk
    positions count."""
    S = h.shape[1]
    chunk = min(chunk, S)
    n = S // chunk
    fn = _maybe_remat(cfg, functools.partial(ce_chunk, cfg, params["emb"]),
                      "none" if cfg.remat == "none" else "full")
    if n == 1:
        nll, z2, cnt = fn(h, labels)
    else:
        nll = z2 = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, n * chunk, chunk):
            a, b, c = fn(h[:, i:i + chunk], labels[:, i:i + chunk])
            nll, z2, cnt = nll + a, z2 + b, cnt + c
    denom = cnt.clamp(min=1.0)
    return nll / denom + z_loss * z2 / denom


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: tokens [B,S] int, labels [B,S] int (-1 masked), optional
    patch_embeds [B,P,4096].  Returns the scalar loss (CE + z + 0.01 * the
    MoE aux loss, which is 0 for a dense model)."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_inputs(cfg, params, tokens, batch.get("patch_embeds"))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, aux = backbone(cfg, params, x, positions)
    return chunked_ce_loss(cfg, params, h, labels) + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> Any:
    """Zero KV caches: per unit {kind: {'k', 'v': [B, smax, KV, Dh]}} with
    smax = seq (global) or min(seq, window) (local), stacked [U, ...] with
    cfg.scan_layers, else a list."""
    def unit():
        return {kind: attn.init_kv_cache(
            cfg, batch, seq, cfg.local_window if kind == "local" else 0, device)
            for kind in unit_layout(cfg)}
    return _restack(cfg, [unit() for _ in range(n_units(cfg))])


def unit_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos):
    new_cache = {}
    for kind in unit_layout(cfg):
        lp = p[kind]
        window = cfg.local_window if kind == "local" else 0
        h, new_cache[kind] = attn.self_attention_decode(
            cfg, lp["attn"], _norm(cfg, lp["ln_attn"], x), cache[kind], pos,
            window=window)
        x, _ = _ffn(cfg, lp, _attn_residual(cfg, lp, x, h))
    return x, new_cache


def decode_step(cfg: ModelConfig, params: dict, token, cache, pos):
    """token: [B,1] int; pos: [B] int -> (logits [B,V] f32, new_cache)."""
    x = embed_tokens(cfg, params["emb"], token)
    new_cache = []
    for up, uc in zip(_units(cfg, params["units"]), _units(cfg, cache)):
        x, nc = unit_decode(cfg, up, x, uc, pos)
        new_cache.append(nc)
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h)[:, 0], _restack(cfg, new_cache)


def _fill(c: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """A copy of cache c [B, smax, ...] holding the S new entries' last
    min(S, smax) positions p at slots p % smax."""
    S, smax = new.shape[1], c.shape[1]
    first = max(0, S - smax)
    slots = torch.arange(first, S, device=c.device) % smax
    out = c.clone()
    out[:, slots] = new[:, first:].to(c.dtype)
    return out


def unit_prefill(cfg: ModelConfig, p: dict, x, positions, cache):
    """Like run_unit, but also fills the KV cache (see the module
    docstring for the slots)."""
    new_cache = {}
    for kind in unit_layout(cfg):
        lp = p[kind]
        window = cfg.local_window if kind == "local" else 0
        h = _norm(cfg, lp["ln_attn"], x)
        q = attn.project_q(cfg, lp["attn"], h, positions)
        k, v = attn.project_kv(cfg, lp["attn"], h, positions)
        new_cache[kind] = {"k": _fill(cache[kind]["k"], k),
                           "v": _fill(cache[kind]["v"], v)}
        o = attn.flash_attention(cfg, q, k, v, causal=True, window=window)
        x, _ = _ffn(cfg, lp, _attn_residual(cfg, lp, x,
                                            attn.out_proj(cfg, lp["attn"], o)))
    return x, new_cache


def prefill(cfg: ModelConfig, params: dict, tokens, patch_embeds=None, *,
            max_seq: int | None = None):
    """tokens: [B,S] -> (next-token logits [B,V] f32, cache with room for
    max_seq positions (default S))."""
    B, S = tokens.shape
    max_seq = S if max_seq is None else max_seq
    if max_seq < S:
        raise ValueError(f"prefill: max_seq {max_seq} < the prompt's {S}")
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    positions = torch.arange(S, device=tokens.device)
    cache = []
    for up, uc in zip(_units(cfg, params["units"]),
                      _units(cfg, init_cache(cfg, B, max_seq, tokens.device))):
        x, nc = unit_prefill(cfg, up, x, positions, uc)
        cache.append(nc)
    h = _norm(cfg, params["ln_f"], x)
    return lm_logits(cfg, params["emb"], h[:, -1:])[:, 0], _restack(cfg, cache)
