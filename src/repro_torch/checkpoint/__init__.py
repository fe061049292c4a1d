from repro_torch.checkpoint.store import (CheckpointStats, CheckpointStore,
                                          treedef_token)

__all__ = ["CheckpointStats", "CheckpointStore", "treedef_token"]
