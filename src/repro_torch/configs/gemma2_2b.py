"""Gemma2-2B: alternating local/global attention, softcaps. [arXiv:2408.00118]

Counterpart of `repro.configs.gemma2_2b`, the same configuration.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="decoder",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256_000,
    layer_pattern="local_global", local_window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    attn_logits_scale=0.0625,            # 1/sqrt(query_pre_attn_scalar=256)
    sandwich_norm=True, zero_centered_norm=True, scale_embed=True,
    tie_embeddings=True, mlp_act="geglu",
    train_pure_dp=True,
)
