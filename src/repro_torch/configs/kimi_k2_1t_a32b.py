"""Kimi K2: trillion-parameter MoE (paper-table config). [arXiv:2501.kimi2]

Counterpart of `repro.configs.kimi_k2_1t_a32b`, the same configuration:
384 experts, top-8, the momentum-only optimizer (lion).  Its 1.03 T
parameters do not fit one card; on one H100 it runs at full width and
reduced depth.  ``moe_impl="shardmap"`` runs the sort-based ``dispatch``
without a mesh (`models/moe.py`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="decoder",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163_840,
    moe=True, n_experts=384, top_k=8,
    mlp_act="swiglu", rope_theta=50_000.0,
    fsdp_axes=("pod", "data"), optimizer="lion",
    moe_impl="shardmap",
)
