"""AdamW and learning-rate schedules of the port (port of ``repro.optim``;
gradient compression comes with the multi-process slice)."""
from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamW", "OptState", "global_norm", "cosine_schedule",
           "linear_warmup"]
