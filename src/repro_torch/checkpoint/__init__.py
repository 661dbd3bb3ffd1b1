from repro_torch.checkpoint.checkpoint import (CheckpointError,
                                               check_rank_headers,
                                               load_checkpoint,
                                               load_rank_checkpoint,
                                               rank_path,
                                               save_checkpoint,
                                               save_rank_checkpoint)

__all__ = ["CheckpointError", "check_rank_headers", "load_checkpoint",
           "load_rank_checkpoint", "rank_path", "save_checkpoint",
           "save_rank_checkpoint"]
