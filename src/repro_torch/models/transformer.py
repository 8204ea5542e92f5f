"""Decoder-family helpers shared with the other families.

Counterpart of `repro.models.transformer` (the slice's part: `_norm`, which
RWKV6 uses; the decoder family itself is ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

from repro_torch.models.layers import rmsnorm


def _norm(cfg, scale, x):
    return rmsnorm(x, scale, cfg.norm_eps, cfg.zero_centered_norm)
