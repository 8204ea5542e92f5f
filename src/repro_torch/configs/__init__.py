"""Model configurations of the port (counterpart of `repro.configs`):
``get_config(<id>)`` resolves ``--arch <id>``.

Ported: the paper's own ``egru-spiral`` and ``rwkv6-3b``.  Every other
architecture of the reference is in ``NOT_PORTED`` and raises: its model
family is ROADMAP Queue 1 item 14's remaining work.
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSuite, smoke_config

NOT_PORTED = frozenset({
    "olmoe-1b-7b", "kimi-k2-1t-a32b", "internvl2-2b", "whisper-large-v3",
    "qwen3-8b", "gemma2-2b", "minitron-8b", "yi-6b", "recurrentgemma-9b"})


def get_config(name: str):
    if name in ("egru_spiral", "egru-spiral"):
        from repro_torch.configs.egru_spiral import CONFIG
        return CONFIG
    if name == "rwkv6-3b":
        from repro_torch.configs.rwkv6_3b import CONFIG
        return CONFIG
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"--arch {name} is not ported yet: its model family is ROADMAP "
            "Queue 1 item 14 (LM substrate, other families); the port has "
            "rwkv6-3b and egru-spiral")
    raise KeyError(name)


__all__ = ["NOT_PORTED", "SHAPES", "ModelConfig", "ShapeSuite", "get_config",
           "smoke_config"]
