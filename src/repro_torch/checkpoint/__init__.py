from repro_torch.checkpoint.checkpoint import (CheckpointError,
                                               check_rank_headers,
                                               load_checkpoint,
                                               load_gathered_checkpoint,
                                               load_grid_checkpoint,
                                               load_rank_checkpoint,
                                               rank_path,
                                               save_checkpoint,
                                               save_rank_checkpoint,
                                               stitch_rank_checkpoints)

__all__ = ["CheckpointError", "check_rank_headers", "load_checkpoint",
           "load_gathered_checkpoint", "load_grid_checkpoint",
           "load_rank_checkpoint", "rank_path", "save_checkpoint",
           "save_rank_checkpoint", "stitch_rank_checkpoints"]
