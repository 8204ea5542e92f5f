"""The cell zoo's dispatch rule, for the cells the port has so far.

Counterpart of `repro.cells`: `resolve_cell` maps a config object to its
cell.  Only the EGRU/ERNN cell is ported (the rgLRU, SNN and diagonal cells
are ROADMAP Queue 1 item 12)."""
from __future__ import annotations

from typing import Any

from repro_torch.cells.egru import EGRUCell


def resolve_cell(cfg: Any) -> EGRUCell:
    from repro_torch.core.cells import EGRUConfig
    if isinstance(cfg, EGRUConfig):
        return EGRUCell(cfg)
    raise NotImplementedError(
        f"no cell ported for config type {type(cfg).__name__!r}: the port "
        "has the EGRU cell only (ROADMAP Queue 1 item 12 brings the rest)")
