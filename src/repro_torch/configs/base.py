"""Config dataclasses: model architecture + input-shape suites.

Counterpart of `repro.configs.base`: the same fields, names and defaults,
with torch dtypes in place of jnp ones.  Each ported architecture is a
``ModelConfig`` instance in its own module (``configs/<id>.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # 'decoder' | 'encdec' | 'rglru' | 'rwkv6'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- MoE -------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- attention flavour -------------------------------------------------
    qk_norm: bool = False
    attn_softcap: float = 0.0      # gemma2: 50.0 on attention logits
    logit_softcap: float = 0.0     # gemma2: 30.0 on final logits
    local_window: int = 0          # sliding-window size for local layers
    layer_pattern: str = "global"  # 'global' | 'local_global' | 'rglru'
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"          # 'rope' | 'sinusoidal' | 'none'
    mlp_act: str = "swiglu"        # 'swiglu' | 'geglu' | 'gelu' | 'relu2'
    attn_logits_scale: float = 0.0 # 0 -> 1/sqrt(head_dim)
    sandwich_norm: bool = False    # gemma2: post-attn / post-ffw norms too
    zero_centered_norm: bool = False  # gemma-style (scale + 1) RMSNorm
    scale_embed: bool = False      # gemma-style sqrt(d_model) embedding scale

    # --- encoder-decoder (whisper) ----------------------------------------
    enc_layers: int = 0
    enc_seq: int = 1500            # post-conv audio frames (frontend stubbed)

    # --- VLM (internvl) ----------------------------------------------------
    n_patches: int = 0             # prepended patch embeddings (frontend stubbed)

    # --- recurrent (rglru / rwkv) ------------------------------------------
    lru_width: int = 0             # 0 -> d_model
    conv_width: int = 4

    # --- dtypes / numerics ---------------------------------------------------
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- training-time knobs -------------------------------------------------
    remat: str = "full"            # 'none' | 'full' | 'dots'
    scan_layers: bool = True       # units stacked [L, ...] (a Python loop here)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    rwkv_chunk: int = 32   # WKV chunk length (joint-exponent [L,L,D] stays small)
    fsdp: bool = True
    fsdp_axes: Tuple[str, ...] = ("data",)
    n_microbatches: int = 1
    optimizer: str = "adamw"       # 'adamw' | 'adafactor' | 'lion'
    moe_impl: str = "dispatch"     # 'dispatch' (sort/capacity) | 'dense'
    moe_dshard: bool = False
    train_pure_dp: bool = False
    train_mode: str = "bptt"       # 'bptt' | 'rtrl'

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeSuite("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSuite("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSuite("long_500k",   524_288, 1,   "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    n_layers = {"global": 2, "local_global": 4, "rglru": 4}[cfg.layer_pattern]
    return cfg.replace(
        n_layers=min(cfg.n_layers, n_layers),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=32,
        n_patches=min(cfg.n_patches, 8),
        lru_width=64,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        rwkv_chunk=8,
        scan_layers=False,
        remat="none",
        fsdp=False,
    )
