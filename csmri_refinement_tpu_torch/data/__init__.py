"""Host data pipeline: ScarSeg and Synthetic datasets, batching with a
prefetch queue, output transforms, results I/O and statistics."""

from csmri_refinement_tpu_torch.data.datasets import load_dataset
from csmri_refinement_tpu_torch.data.loader import DataLoader

__all__ = ['DataLoader', 'load_dataset']
