"""The port's data pipeline (port of ``repro.data``; ``input_specs``, the
dry-run's abstract inputs, comes with the dry-run tooling)."""
from repro_torch.data.pipeline import SyntheticDataset, make_batch

__all__ = ["SyntheticDataset", "make_batch"]
