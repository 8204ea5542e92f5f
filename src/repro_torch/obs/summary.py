"""One run-summary formatter for every launcher.

Counterpart of `repro.obs.summary`, with the same text.  `train.py` and
`serve.py` feed a result dict (registry-sourced) through
`format_summary`, so every entry point prints the same shape.

Output is one aligned `key = value` block under a title rule; nested
dicts (guard report, per-arch results) indent one level.  Floats print
with %.6g, NaN/None print as `-` (absent metric, not zero).
"""
from __future__ import annotations

import math

_PRIORITY = ("final_step", "updates", "final_loss", "loss", "acc",
             "act_sparsity", "bwd_sparsity", "grad_norm", "wall_s")


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, float):
        if math.isnan(v):
            return "-"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return f"{v:.6g}"
    if isinstance(v, (list, tuple)):
        if len(v) > 6:
            return f"[{len(v)} items]"
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    return str(v)


def _order(keys):
    pri = {k: i for i, k in enumerate(_PRIORITY)}
    return sorted(keys, key=lambda k: (pri.get(k, len(_PRIORITY)), k))


def format_summary(title: str, result: dict, skip: tuple = ()) -> str:
    """Render the run summary block.  `skip` hides bulky internal keys
    (e.g. raw event lists already exported to JSONL)."""
    flat, nested = {}, {}
    for k, v in result.items():
        if k in skip:
            continue
        (nested if isinstance(v, dict) else flat)[k] = v
    width = max((len(k) for k in list(flat) +
                 [k2 for d in nested.values() for k2 in d]), default=1)
    lines = [f"== {title} =="]
    for k in _order(flat):
        lines.append(f"  {k:<{width}} = {_fmt(flat[k])}")
    for k in _order(nested):
        lines.append(f"  {k}:")
        for k2 in _order(nested[k]):
            lines.append(f"    {k2:<{width}} = {_fmt(nested[k][k2])}")
    return "\n".join(lines)


def print_summary(title: str, result: dict, skip: tuple = ()):
    print(format_summary(title, result, skip=skip))
