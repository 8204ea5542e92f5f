"""SnAp-1 / SnAp-2 (Menick et al., 2020), in PyTorch: the approximate-RTRL
baselines of the paper's Table 1.

Counterpart of `repro.core.snap`.  SnAp-n keeps only the influence entries
M[k, j] whose parameter j can reach unit k within n steps; entries outside
the pattern are dropped every update (an approximation, unlike exact
sparse RTRL):

  SnAp-1: parameter group q reaches unit q only -> J enters through its
          diagonal.
  SnAp-2: one more hop through the (masked) recurrent matrix -> M[k, q]
          kept iff k == q or R_mask[q, k] != 0.

Both run on the dense per-gate influence backend (`sparse_rtrl`'s
`init_influence`, `influence_update`, `influence_grads`), pruned to the
pattern by `core.learner.SnapLearner`.
"""
from __future__ import annotations

import torch

from repro_torch.core.cells import EGRUConfig
from repro_torch.core.sparse_rtrl import mask_gates


def snap2_pattern(cfg: EGRUConfig, masks, *, device=None) -> torch.Tensor:
    """[n(k), n(q)] keep pattern: q's parameters reach k within 2 steps
    (all ones without masks)."""
    n = cfg.n_hidden
    if masks is None:
        return torch.ones((n, n), device=device)
    reach = torch.eye(n, device=masks[mask_gates(cfg.kind)[0]]["R"].device)
    for g in mask_gates(cfg.kind):
        reach = torch.maximum(reach, (masks[g]["R"] != 0).float().T)
    return reach


def snap_loss_and_grads(cfg: EGRUConfig, params, xs, labels, order: int = 1,
                        masks=None):
    """SnAp-{1,2} over a whole sequence: the streaming `SnapLearner`
    stepped over xs.  Returns (loss, grads, stats)."""
    from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
    learner = make_learner(LearnerSpec(engine="snap", cfg=cfg, order=order))
    loss, grads, stats = scan_learner(learner, params, masks, xs, labels)
    return loss, grads, {"beta": stats["beta"].mean(),
                         "keep_density": learner.keep.mean()}
