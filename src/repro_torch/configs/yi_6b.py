"""Yi-6B: llama-arch GQA. [arXiv:2403.04652]

Counterpart of `repro.configs.yi_6b`, the same configuration.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="decoder",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11_008, vocab_size=64_000,
    mlp_act="swiglu", rope_theta=5_000_000.0,
)
