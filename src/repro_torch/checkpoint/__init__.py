from repro_torch.checkpoint.ckpt import (CheckpointError, CheckpointManager,
                                         load_checkpoint, save_checkpoint,
                                         valid_steps,
                                         validate_checkpoint_dir)

__all__ = ["CheckpointError", "CheckpointManager", "save_checkpoint",
           "load_checkpoint", "valid_steps", "validate_checkpoint_dir"]
