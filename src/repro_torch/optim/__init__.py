"""Optimizers of the port (counterpart of `repro.optim`)."""
from repro_torch.optim.grad import (clip_by_global_norm, global_norm,
                                    microbatch_grads)
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw, lion,
                                          make_optimizer, masked,
                                          masked_dynamic, set_opt_mask, sgdm)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup

__all__ = ["Optimizer", "adamw", "adafactor", "lion", "sgdm", "masked",
           "masked_dynamic", "set_opt_mask", "make_optimizer", "constant",
           "cosine_warmup", "linear_warmup", "clip_by_global_norm",
           "global_norm", "microbatch_grads"]
