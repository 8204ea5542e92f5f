from repro_torch.checkpoint.ckpt import (CheckpointError, CheckpointManager,
                                         list_sessions, load_checkpoint,
                                         load_session, save_checkpoint,
                                         save_session, valid_steps,
                                         validate_checkpoint_dir)

__all__ = ["CheckpointError", "CheckpointManager", "save_checkpoint",
           "load_checkpoint", "valid_steps", "validate_checkpoint_dir",
           "save_session", "load_session", "list_sessions"]
