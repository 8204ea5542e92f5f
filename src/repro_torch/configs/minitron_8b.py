"""Minitron-8B: width-pruned Nemotron-4 (squared-ReLU FFN). [arXiv:2407.14679]

Counterpart of `repro.configs.minitron_8b`, the same configuration.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="decoder",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16_384, vocab_size=256_000,
    mlp_act="relu2",
)
