"""Shared layers: norms, token embedding and unembedding.

Counterpart of `repro.models.layers` (the slice's part: rotary embeddings
and the MLPs come with the decoder family, ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec, fan_in_normal, normal, ones_init


def rmsnorm_spec(dim: int, dtype) -> ParamSpec:
    return ParamSpec((dim,), dtype, ones_init(), ("embed",))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if zero_centered else scale.float()
    return (y * s).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def embedding_specs(cfg: ModelConfig) -> dict:
    specs = {
        "tok": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                         normal(1.0 / math.sqrt(cfg.d_model)), ("vocab", "embed")),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), cfg.param_dtype,
                                  fan_in_normal(), ("embed_tp", "vocab"))
    return specs


def embed_tokens(cfg: ModelConfig, emb: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = emb["tok"][tokens].to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype)
    return x


def lm_logits(cfg: ModelConfig, emb: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits.  The reference multiplies compute-dtype operands with f32
    accumulation; here both operands are widened to f32 (TF32 is off in this
    package), which is the same products, exact in f32, summed in another
    order."""
    table = emb["tok"].T if cfg.tie_embeddings else emb["head"]
    logits = x.float() @ table.to(cfg.compute_dtype).float()
    return softcap(logits, cfg.logit_softcap)
