"""Whisper large-v3 backbone: 32-layer encoder + 32-layer decoder.
[arXiv:2212.04356]

Counterpart of `repro.configs.whisper_large_v3`, the same configuration.
The conv/mel frontend is a stub: the model takes post-conv frame
embeddings [B, 1500, d_model].  Sinusoidal positions, MHA, plain GELU FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    head_dim=64, d_ff=5120, vocab_size=51_866,
    mlp_act="gelu", pos_emb="sinusoidal", enc_seq=1500,
    train_pure_dp=True,
)
