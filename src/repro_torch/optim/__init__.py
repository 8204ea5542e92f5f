"""Optimizers of the port (counterpart of `repro.optim`)."""
from repro_torch.optim.optimizers import (Optimizer, adamw, make_optimizer,
                                          masked, masked_dynamic,
                                          set_opt_mask)

__all__ = ["Optimizer", "adamw", "make_optimizer", "masked",
           "masked_dynamic", "set_opt_mask"]
