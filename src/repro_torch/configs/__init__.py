"""Model configurations of the port (counterpart of `repro.configs`):
``get_config(<id>)`` resolves ``--arch <id>``.

Ported: every architecture of the JAX package: the paper's own
``egru-spiral``, ``rwkv6-3b``, the dense decoders (gemma2-2b, qwen3-8b,
yi-6b, minitron-8b, internvl2-2b), the MoE decoders (olmoe-1b-7b,
kimi-k2-1t-a32b), the Griffin RG-LRU LM (recurrentgemma-9b) and the
encoder-decoder (whisper-large-v3).  ``NOT_PORTED`` is empty; an id put
there raises naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSuite, smoke_config

ARCHS = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "internvl2-2b": "internvl2_2b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen3-8b": "qwen3_8b",
    "gemma2-2b": "gemma2_2b",
    "minitron-8b": "minitron_8b",
    "yi-6b": "yi_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-3b": "rwkv6_3b",
}

NOT_PORTED: frozenset = frozenset()


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue 1 item 14 (the LM "
        "substrate)")


def get_config(name: str) -> ModelConfig:
    if name in ("egru_spiral", "egru-spiral"):
        from repro_torch.configs.egru_spiral import CONFIG
        return CONFIG
    if name in NOT_PORTED:
        raise not_ported(f"--arch {name}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}").CONFIG


__all__ = ["ARCHS", "NOT_PORTED", "SHAPES", "ModelConfig", "ShapeSuite",
           "get_config", "not_ported", "smoke_config"]
