"""Data layer: ``fedml_tpu_torch.data.load(args, device=...)``."""

from .loader import FederatedDataset, load  # noqa: F401
