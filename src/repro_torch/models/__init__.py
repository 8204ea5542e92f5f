"""Model zoo: unified API over the families (counterpart of `repro.models`).

``get_model(cfg)`` returns a :class:`ModelAPI` with:
  specs(cfg)                      -> ParamSpec tree
  loss_fn(cfg, params, batch)    -> scalar training loss
  prefill(cfg, params, tokens)   -> (logits, cache)
                                    (encdec: prefill(cfg, params, tokens,
                                    frames))
  decode_step(cfg, params, token, cache, pos) -> (logits, cache)
  init_cache(cfg, B, S, device)  -> cache tree

Ported, for training and serving: every family of the JAX package: the
decoder family (`transformer`, dense and MoE), the Griffin RG-LRU LM
(`rglru`), RWKV6 (`rwkv`) and the encoder-decoder (`encdec`, whisper).
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
        return ModelAPI("decoder", m.decoder_specs, m.loss_fn, m.prefill,
                        m.decode_step, m.init_cache)
    if cfg.family == "rwkv6":
        from repro_torch.models import rwkv as m
        return ModelAPI("rwkv6", m.rwkv_model_specs, m.loss_fn, m.prefill,
                        m.decode_step, m.init_cache)
    if cfg.family == "rglru":
        from repro_torch.models import rglru as m
        return ModelAPI("rglru", m.rglru_model_specs, m.loss_fn, m.prefill,
                        m.decode_step, m.init_cache)
    if cfg.family == "encdec":
        from repro_torch.models import encdec as m
        return ModelAPI("encdec", m.encdec_specs, m.loss_fn, m.prefill,
                        m.decode_step, m.init_cache)
    raise ValueError(f"unknown family {cfg.family!r}")
