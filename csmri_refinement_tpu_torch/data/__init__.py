"""Host data pipeline: synthetic datasets, batching, output transforms."""

from csmri_refinement_tpu_torch.data.datasets import load_dataset
from csmri_refinement_tpu_torch.data.loader import DataLoader

__all__ = ['DataLoader', 'load_dataset']
