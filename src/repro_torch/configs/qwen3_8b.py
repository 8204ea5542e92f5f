"""Qwen3-8B: dense GQA with qk-norm. [hf:Qwen/Qwen3-8B]

Counterpart of `repro.configs.qwen3_8b`, the same configuration.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="decoder",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12_288, vocab_size=151_936,
    qk_norm=True, mlp_act="swiglu", rope_theta=1_000_000.0,
)
