"""The cell zoo: every recurrent architecture behind one protocol.

Counterpart of `repro.cells`.  A cell packages what a gradient engine needs
to know about an architecture, so the engines of `core.learner` are
cell-agnostic:

    cell.name            "egru" | "rglru" | "snn" | "diag"
    cell.jac_kind        "dense"    -> partials yields J-hat [B, n, n]
                         "diagonal" -> partials yields the diagonal [B, n]
    cell.cfg             the config dataclass the cell was built from
    cell.init_params(gen, device=)   full parameter tree (readout included)
    cell.rec_params(params)          the recurrent subset w
    cell.init_state(batch, device=)  recurrent state (tensor or dict)
    cell.partials(w, state, x_t)  -> (state', hp, Jhat_or_diag, mbar)
    cell.step_st(w, state, x_t)      autograd-able forward (the shared
                                     surrogate gradient): the BPTT oracles
    cell.readout(params, state)   -> logits [B, n_out]
    cell.activity_mask(state)     -> bool [B, n] active units

For dense cells mbar is the EGRU per-gate M-bar dict of the flat
influence layout; for diagonal cells a tree of per-parameter trace
increments (state axis n trailing), and they expose
`init_traces(batch, device=)` for `engine="diag_exact"`.  The SNN exposes
`eprop_step` for `engine="eprop"` instead.  The port draws parameters
from a `torch.Generator`, so `init_params` takes one and a device where
the reference takes a `jax.random` key.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.cells.egru import EGRUCell
from repro_torch.cells.rglru import DiagCell, RGLRUCell, RGLRUCellConfig
from repro_torch.cells.snn import SNNCell, SNNConfig

Tree = Any


@runtime_checkable
class Cell(Protocol):
    """The structural protocol every zoo cell satisfies (see the module
    docstring for the contract)."""
    name: str
    jac_kind: str
    cfg: Any

    def init_params(self, gen: torch.Generator, *, device) -> Tree: ...

    def rec_params(self, params: Tree) -> Tree: ...

    def init_state(self, batch: int, *, device) -> Any: ...

    def partials(self, w: Tree, state: Any, x_t: torch.Tensor) -> tuple: ...

    def step_st(self, w: Tree, state: Any, x_t: torch.Tensor) -> Any: ...

    def readout(self, params: Tree, state: Any) -> torch.Tensor: ...

    def activity_mask(self, state: Any) -> torch.Tensor: ...


CELLS = {
    "egru": EGRUCell,
    "rglru": RGLRUCell,
    "snn": SNNCell,
    "diag": DiagCell,
}


def make_cell(name: str, cfg: Any) -> Cell:
    """Construct the cell named `name` around `cfg`."""
    if name not in CELLS:
        raise ValueError(f"cell must be one of {tuple(CELLS)}, got {name!r}")
    return CELLS[name](cfg)


def resolve_cell(cfg: Any) -> Cell:
    """Map a LearnerSpec.cfg object to its zoo cell by config type."""
    from repro_torch.core.cells import EGRUConfig
    from repro_torch.core.diag_rtrl import DiagCellConfig
    if isinstance(cfg, EGRUConfig):
        return EGRUCell(cfg)
    if isinstance(cfg, RGLRUCellConfig):
        return RGLRUCell(cfg)
    if isinstance(cfg, SNNConfig):
        return SNNCell(cfg)
    if isinstance(cfg, DiagCellConfig):
        return DiagCell(cfg)
    raise ValueError(
        f"no cell registered for config type {type(cfg).__name__!r}; "
        f"known cells: {tuple(CELLS)}")
