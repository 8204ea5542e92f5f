"""Model zoo: unified API over the families (counterpart of `repro.models`).

``get_model(cfg)`` returns a :class:`ModelAPI` with:
  specs(cfg)                      -> ParamSpec tree
  loss_fn(cfg, params, batch)    -> scalar training loss
  prefill(cfg, params, tokens)   -> (logits, cache)
  decode_step(cfg, params, token, cache, pos) -> (logits, cache)
  init_cache(cfg, B, S, device)  -> cache tree

Ported: the dense decoder family (`transformer`) and RWKV6 (`rwkv`), for
training and serving.  A config with ``moe=True`` and the other families
(encdec, rglru) are ROADMAP Queue 1 item 14's remaining work and raise.
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


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "decoder":
        from repro_torch.models import transformer as m
        m.check_dense(cfg)
        return ModelAPI("decoder", m.decoder_specs, m.loss_fn, m.prefill,
                        m.decode_step, m.init_cache)
    if cfg.family == "rwkv6":
        from repro_torch.models import rwkv as m
        return ModelAPI("rwkv6", m.rwkv_model_specs, m.loss_fn, m.prefill,
                        m.decode_step, m.init_cache)
    if cfg.family in ("encdec", "rglru"):
        from repro_torch.configs import not_ported
        raise not_ported(f"model family {cfg.family!r}")
    raise ValueError(f"unknown family {cfg.family!r}")
