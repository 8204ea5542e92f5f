"""Stacked-network RTRL, in PyTorch: the part the launcher calls at L=1.

Counterpart of `repro.core.stacked_rtrl`.  The launcher builds the stacked
engine even for one layer; at L=1 it delegates to the single-layer engine
(`core.learner._SingleLayerStackedLearner`).  What is here are the stacked
mask and layout helpers that path uses, and the whole-sequence
`stacked_rtrl_loss_and_grads` of the offline trainer.  The block
lower-triangular engine for L >= 2 (`stacked_compact_step`, the
cross-layer term) is ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import sparse_rtrl as SP
from repro_torch.core.cells import StackedEGRUConfig

Tree = Any


@dataclasses.dataclass(frozen=True)
class StackedFlatLayout:
    """Column layout of the stacked flat influence buffers: layer j's
    parameter columns live at [offsets[j], offsets[j] + layers[j].P);
    P_pad rounds the concatenated P_total up to a LANE multiple."""
    layers: tuple            # per-layer FlatLayout
    offsets: tuple           # start column of each layer's parameter block
    P_total: int
    P_pad: int


def stacked_layout(cfg: StackedEGRUConfig) -> StackedFlatLayout:
    lays, offs, off = [], [], 0
    for l in range(cfg.n_layers):
        lay = SP.flat_layout(cfg.layer_cfg(l))
        lays.append(lay)
        offs.append(off)
        off += lay.P
    P_pad = -(-off // SP.LANE) * SP.LANE
    return StackedFlatLayout(tuple(lays), tuple(offs), off, P_pad)


def make_stacked_masks(cfg: StackedEGRUConfig, gen: torch.Generator,
                       sparsity: float, *, device: torch.device | str,
                       block: int = 1, mask_input: bool = True) -> list:
    """One fixed mask tree per layer, drawn bottom-up from `gen`; a list,
    mirroring the params' "layers" container."""
    masks = []
    for l in range(cfg.n_layers):
        mk = SP.make_masks(cfg.layer_cfg(l), gen, sparsity, device=device,
                           block=block, mask_input=mask_input)
        mk.pop("out")
        masks.append(mk)
    return masks


def apply_stacked_masks(params: Tree, masks: list) -> Tree:
    out = dict(params)
    out["layers"] = [SP.apply_masks(p, m)
                     for p, m in zip(params["layers"], masks)]
    return out


def stacked_omega_tilde(masks: list) -> float:
    """Aggregate parameter density over all layers' maskable params."""
    counts = [SP.mask_counts(mk) for mk in masks]
    return sum(c[0] for c in counts) / sum(c[1] for c in counts)


def stacked_col_mask(slayout: StackedFlatLayout, masks: list | None, *,
                     device: torch.device | str) -> torch.Tensor:
    """[P_pad] column liveness over the concatenated parameter axis."""
    parts = [SP._flat_col_mask_np(lay, None if masks is None else masks[l])
             for l, lay in enumerate(slayout.layers)]
    live = np.pad(np.concatenate(parts), (0, slayout.P_pad - slayout.P_total))
    return torch.from_numpy(live).to(device)


def stacked_rtrl_loss_and_grads(cfg: StackedEGRUConfig, params: Tree,
                                xs: torch.Tensor, labels: torch.Tensor,
                                masks: list | None = None, *,
                                backend: str = "dense",
                                capacity: float = 1.0,
                                col_compact: bool | None = None,
                                influence_dtype: str = "float32"):
    """Exact stacked RTRL over a whole sequence xs [T, B, n_in] with labels
    [B].  Returns (loss, grads, stats), grads as {"layers": [...], "out"},
    every stat stacked over T.

    A whole-sequence `scan_learner` over the stacked learner, as in the
    JAX package, at L = 1 (the single-layer engine).  L >= 2 is ROADMAP
    Queue 1 item 7."""
    from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
    if cfg.n_layers != 1:
        raise NotImplementedError(
            "stacked_rtrl_loss_and_grads for L >= 2 is not ported yet: "
            "ROADMAP Queue 1 item 7")
    learner = make_learner(LearnerSpec(
        engine="stacked", cfg=cfg, backend=backend, capacity=capacity,
        col_compact=col_compact, influence_dtype=influence_dtype))
    return scan_learner(learner, params, masks, xs, labels)
