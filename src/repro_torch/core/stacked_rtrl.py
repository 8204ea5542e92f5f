"""EXACT multi-layer RTRL on the flat engines, in PyTorch.

Counterpart of `repro.core.stacked_rtrl`.  A stacked network's state
Jacobian is block lower-triangular: layer l depends on its own previous
state (J^(l) = D(hp^l) J-hat^(l)) and on the CURRENT activity of the layer
below (B^(l) = D(hp^l) B-hat^(l), B-hat = dv^l/dx at x = a^{l-1}_t).  The
influence factors into blocks M^(l,j) = d a^l / d w^j (j <= l), updated
bottom-up each step as

    M^(l,j)_t = J^(l)_t M^(l,j)_{t-1} + B^(l)_t M^(l-1,j)_t
                [+ M-bar^(l)_t  if j = l]

The j <= l blocks of layer l are carried concatenated along one parameter
axis of width P_total (`StackedFlatLayout`); the columns of layers j > l
are structurally zero and stay zero.  Each layer's update is then the
single-layer form D(hp)(J-hat M + M-bar') with the cross term folded into
M-bar', so it runs through the single-layer engine: per-layer flat
products (backend "dense"), one K2 launch a layer with a column mask that
kills the j > l blocks ("pallas"), `sparse_rtrl.flat_compact_step(below=)`
("compact") or one K1 launch a layer ("compact_fused").  With L = 1 the
learner delegates to the single-layer engine unless told not to
(`delegate_single_layer=False`).
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

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def layer_slice(self, l: int) -> slice:
        return slice(self.offsets[l], self.offsets[l] + self.layers[l].P)


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


def layer_col_masks(slayout: StackedFlatLayout,
                    colm: torch.Tensor) -> tuple:
    """Per-layer column masks: layer l's buffer also kills the structurally
    dead columns of layers j > l (block lower-triangularity), so the
    block-granular kernel skips those whole column blocks."""
    cols = torch.arange(slayout.P_pad, device=colm.device)
    return tuple(colm * (cols < slayout.offsets[l] + lay.P)
                 for l, lay in enumerate(slayout.layers))


def stacked_col_layout(slayout: StackedFlatLayout, masks: list | None,
                       influence_dtype: str = "float32", *,
                       device: torch.device | str) -> "SP.ColLayout":
    """Live-column map over the CONCATENATED stacked parameter axis: one
    compact axis shared by every layer's buffer, each column tagged with
    its owning layer so `flat_mbar_rows_cols(layer=l)` hits only layer l's
    columns.  Width Pc ~= w~ P_total."""
    parts = [(lay, None if masks is None else masks[l], slayout.offsets[l], l)
             for l, lay in enumerate(slayout.layers)]
    return SP.build_col_layout(parts, slayout.P_pad, influence_dtype,
                               device=device)


def layer_col_lives(slayout: StackedFlatLayout, cl: "SP.ColLayout") -> tuple:
    """Per-layer COMPACT-axis liveness: layer l's buffer kills the columns
    of layers j > l on the compact axis (the dual of `layer_col_masks`)."""
    return tuple(cl.live * (cl.layer <= l)
                 for l in range(len(slayout.layers)))


def unflatten_stacked_grads(cfg: StackedEGRUConfig,
                            slayout: StackedFlatLayout,
                            gw: torch.Tensor) -> Tree:
    """Concatenated flat gradient [P_pad] -> {"layers": [per-layer trees]}."""
    return {"layers": [
        SP.unflatten_flat_grads(cfg.layer_cfg(l), lay,
                                gw[slayout.layer_slice(l)])
        for l, lay in enumerate(slayout.layers)]}


def stacked_compact_step(cfg: StackedEGRUConfig, ws, slayout:
                         StackedFlatLayout, a_prevs: tuple, vals: tuple,
                         idx: tuple, x_t: torch.Tensor,
                         colms: tuple | None = None,
                         cl: "SP.ColLayout | None" = None, *,
                         backend: str = "compact"):
    """One bottom-up stacked RTRL step, every layer row-compact.

    Layer l runs `sparse_rtrl.flat_compact_step` with its column offset and
    (for l > 0) the freshly updated compact influence of the layer below as
    the cross-layer `below` term.  Returns (a_news, hps, vals', idx',
    overflow [L]).  With `cl` (`stacked_col_layout`) every layer's buffer is
    column-compact on the shared stacked axis ([B, K_l, Pc_pad]).

    backend="compact_fused" runs every layer's update as one K1 launch
    (`sparse_rtrl.flat_compact_fused_step`; requires `cl`), the cross term
    folded into its M-bar rows before the launch."""
    inp = x_t
    a_news, hps, vals_new, idx_new, ovs = [], [], [], [], []
    for l in range(cfg.n_layers):
        below = None if l == 0 else (vals_new[l - 1], idx_new[l - 1])
        if backend == "compact_fused":
            a_new, hp, v_new, i_new, _, ov = SP.flat_compact_fused_step(
                cfg.layer_cfg(l), ws[l], slayout.layers[l], a_prevs[l],
                vals[l], idx[l], inp, cl=cl, layer=l, below=below)
        else:
            a_new, hp, v_new, i_new, _, ov = SP.flat_compact_step(
                cfg.layer_cfg(l), ws[l], slayout.layers[l], a_prevs[l],
                vals[l], idx[l], inp, None if colms is None else colms[l],
                offset=slayout.offsets[l], total_pad=slayout.P_pad,
                below=below, cl=cl, layer=l)
        a_news.append(a_new)
        hps.append(hp)
        vals_new.append(v_new)
        idx_new.append(i_new)
        ovs.append(ov.max())
        inp = a_new
    return (tuple(a_news), tuple(hps), tuple(vals_new), tuple(idx_new),
            torch.stack(ovs))


def stacked_rtrl_loss_and_grads(cfg: StackedEGRUConfig, params: Tree,
                                xs: torch.Tensor, labels: torch.Tensor,
                                masks: list | None = None, *,
                                backend: str = "dense",
                                capacity: float = 1.0,
                                delegate_single_layer: bool = True,
                                col_compact: bool | None = None,
                                influence_dtype: str = "float32"):
    """Exact stacked RTRL over a whole sequence xs [T, B, n_in] with labels
    [B].  Returns (loss, grads, stats), grads as {"layers": [...], "out"},
    every stat stacked over T (per-layer "alpha_layers"/"beta_layers" [T,
    L] beside the scalar means).

    col_compact (None = auto: masks given, backend not "dense") carries
    every layer's buffer column-compact on the shared stacked axis.  With
    one layer the call delegates to the single-layer engine unless
    delegate_single_layer=False.  A whole-sequence scan over the streaming
    learner (`core.learner.StackedLearner`), whose step is the one online
    training runs."""
    from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
    learner = make_learner(LearnerSpec(
        engine="stacked", cfg=cfg, backend=backend, capacity=capacity,
        col_compact=col_compact, delegate_single_layer=delegate_single_layer,
        influence_dtype=influence_dtype))
    return scan_learner(learner, params, masks, xs, labels)
