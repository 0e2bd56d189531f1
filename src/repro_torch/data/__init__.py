"""The port's data pipeline (port of ``repro.data``; ``input_specs`` gives
the dry run's inputs as meta tensors)."""
from repro_torch.data.pipeline import SyntheticDataset, input_specs, make_batch

__all__ = ["SyntheticDataset", "input_specs", "make_batch"]
