"""OLMoE-1B-7B: 64-expert top-8 MoE. [arXiv:2409.02060; hf]

Counterpart of `repro.configs.olmoe_1b_7b`, the same configuration.  Its
``moe_impl="shardmap"`` (the reference's explicit expert-parallel dispatch
over a mesh) runs the sort-based ``dispatch`` on one device, as the
reference does without a mesh (`models/moe.py`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="decoder",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    moe=True, n_experts=64, top_k=8,
    qk_norm=True, mlp_act="swiglu", rope_theta=10_000.0,
    moe_impl="shardmap",
)
