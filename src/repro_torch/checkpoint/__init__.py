"""On-disk checkpoint/restart of the port (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (CheckpointManager, restore_state,
                                            save_state)

__all__ = ["CheckpointManager", "restore_state", "save_state"]
