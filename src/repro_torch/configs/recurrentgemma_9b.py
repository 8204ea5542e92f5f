"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427]

Counterpart of `repro.configs.recurrentgemma_9b`, the same configuration.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="rglru",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12_288, vocab_size=256_000,
    layer_pattern="rglru", local_window=2048, lru_width=4096,
    zero_centered_norm=True, scale_embed=True, tie_embeddings=True,
    mlp_act="geglu",
)
