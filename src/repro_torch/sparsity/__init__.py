"""Dynamic sparsity of the port (counterpart of `repro.sparsity`):
prune-and-regrow mask evolution with exact influence-carry migration.

  schedule  RewireSchedule (cadence, cosine-decayed fraction, per-event
            keys) and the SET/RigL criteria, fine- or block-granular,
            count-preserving per tensor
  migrate   exact column remapping between two ColLayouts (surviving
            columns bit for bit, grown columns zero, pruned flushed)

Integration: `rewire(carry, event_key)` of the rewirable learners
(`repro_torch.core.learner`), `OnlineTrainer(rewire_schedule=)`
(`repro_torch.runtime.online`) and `launch/train.py --online --rewire`.
"""
from repro_torch.sparsity.migrate import (gate_col_mask, migrate_dense,
                                          migrate_flat, migrate_influence,
                                          migrate_sharded, migrate_via_flat,
                                          migration_plan)
from repro_torch.sparsity.schedule import (RewireSchedule, rewire_masks,
                                           rewire_stacked_masks,
                                           rewire_tensor)

__all__ = [
    "RewireSchedule", "rewire_masks", "rewire_stacked_masks",
    "rewire_tensor", "migration_plan", "migrate_influence", "migrate_flat",
    "migrate_dense", "migrate_via_flat", "gate_col_mask", "migrate_sharded",
]
