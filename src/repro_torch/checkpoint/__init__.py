from repro_torch.checkpoint.checkpoint import (CheckpointError,
                                               load_checkpoint,
                                               save_checkpoint)

__all__ = ["CheckpointError", "load_checkpoint", "save_checkpoint"]
