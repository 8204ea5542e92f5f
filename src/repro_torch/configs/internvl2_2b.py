"""InternVL2-2B: InternLM2 backbone + InternViT (stub frontend). [arXiv:2404.16821; hf]

Counterpart of `repro.configs.internvl2_2b`, the same configuration.  The
vision tower is stubbed: the inputs carry pixel-shuffled patch embeddings
[B, 256, 4096], fed through the mlp1 projector (`vproj`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="decoder",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92_553,
    mlp_act="swiglu", rope_theta=1_000_000.0,
    n_patches=256,
)
