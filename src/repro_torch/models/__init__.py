"""Model zoo: unified API over the families (counterpart of `repro.models`).

``get_model(cfg)`` returns a :class:`ModelAPI` with:
  specs(cfg)                      -> ParamSpec tree
  loss_fn(cfg, params, batch)    -> scalar training loss
  prefill(cfg, params, tokens)   -> (logits, cache)
  decode_step(cfg, params, token, cache, pos) -> (logits, cache)
  init_cache(cfg, B, S, device)  -> cache tree

Ported: the RWKV6 family's serving path.  Its `loss_fn` and the other
families (decoder, encdec, rglru) are ROADMAP Queue 1 item 14's remaining
work and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    specs: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _rwkv_loss_fn(*args, **kwargs):
    raise NotImplementedError(
        "RWKV6 training (loss_fn, the chunked CE loss and a backward through "
        "WKV) is not ported yet: ROADMAP Queue 1 item 14")


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "rwkv6":
        from repro_torch.models import rwkv as m
        return ModelAPI("rwkv6", m.rwkv_model_specs, _rwkv_loss_fn, m.prefill,
                        m.decode_step, m.init_cache)
    if cfg.family in ("decoder", "encdec", "rglru"):
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet: ROADMAP Queue 1 "
            "item 14 (LM substrate, other families)")
    raise ValueError(f"unknown family {cfg.family!r}")
