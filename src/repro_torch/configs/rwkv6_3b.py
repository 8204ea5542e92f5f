"""RWKV6-3B "Finch": attention-free, data-dependent decay. [arXiv:2404.05892]

Counterpart of `repro.configs.rwkv6_3b`, the same configuration.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv6",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65_536,
    pos_emb="none",
    train_pure_dp=True,
    rwkv_chunk=16,
)
