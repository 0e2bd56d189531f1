"""AdamW, learning-rate schedules and int8 gradient compression of the
port (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.optim.compression import (compress_int8,
                                           compressed_psum_tree,
                                           decompress_int8)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamW", "OptState", "global_norm", "cosine_schedule",
           "linear_warmup", "compress_int8", "decompress_int8",
           "compressed_psum_tree"]
