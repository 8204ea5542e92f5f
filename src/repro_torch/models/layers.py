"""Shared layers: norms, rotary embeddings, token embedding, MLPs.

Counterpart of `repro.models.layers`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Rotary / sinusoidal position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [D/2]
    ang = positions[..., None].float() * freqs                # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                        # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(seq: int, dim: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """[seq, dim]: the sinusoid of positions 0..seq-1."""
    return sinusoid_at(torch.arange(seq, device=device), dim, dtype)


def sinusoid_at(positions: torch.Tensor, dim: int,
                dtype=torch.float32) -> torch.Tensor:
    """[..., dim]: the sinusoid of each (integer) position, the same values
    as the rows of `sinusoidal_pos_emb` at those positions."""
    device = positions.device
    inv = torch.exp(-math.log(10_000.0)
                    * torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device) / dim)
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU / GELU / ReLU^2)
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> dict:
    gated = cfg.mlp_act in ("swiglu", "geglu")
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    specs = {
        "wi": ParamSpec((d, f), pd, fan_in_normal(), ("embed_tp", "mlp")),
        "wo": ParamSpec((f, d), pd, fan_in_normal(), ("mlp", "embed_tp")),
    }
    if gated:
        specs["wg"] = ParamSpec((d, f), pd, fan_in_normal(), ("embed_tp", "mlp"))
    return specs


def _act(cfg: ModelConfig, h: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        return F.silu(g) * h
    if cfg.mlp_act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    if cfg.mlp_act == "gelu":
        return F.gelu(h, approximate="tanh")
    if cfg.mlp_act == "relu2":
        return F.relu(h).square()
    raise ValueError(cfg.mlp_act)


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    h = x @ p["wi"].to(dt)
    g = x @ p["wg"].to(dt) if "wg" in p else None
    return _act(cfg, h, g) @ p["wo"].to(dt)
