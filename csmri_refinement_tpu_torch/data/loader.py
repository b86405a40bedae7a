"""Batched data loading.

Port of ``csmri_refinement_tpu/data/loader.py`` for one process: batches of
dict items stacked into numpy arrays, shuffled per epoch by a
``RandomState(seed)`` (the same index stream as the JAX loader), an
optional subset (``num_samples``), a ragged final batch unless
``drop_last``. Items are prepared by ``num_workers`` threads when that is
above 0. The prefetch queue and the multi-process shard are not ported.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _collate(items):
  return {key: np.stack([item[key] for item in items]) for key in items[0]}


class DataLoader:
  """Iterable over batches of a ``SliceDataset``-like dataset."""

  def __init__(self, dataset, batch_size, shuffle=False, seed=0,
               num_workers=0, drop_last=False, num_samples=None):
    self.dataset = dataset
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.num_workers = num_workers
    self.drop_last = drop_last
    self._rng = np.random.RandomState(seed)
    if num_samples is not None and num_samples > 0:
      if num_samples > len(dataset):
        raise ValueError('Requesting subset of {} samples, but dataset '
                         'has only {}'.format(num_samples, len(dataset)))
      self._indices = np.arange(num_samples)
    else:
      self._indices = np.arange(len(dataset))

  def __len__(self):
    n = len(self._indices)
    if self.drop_last:
      return n // self.batch_size
    return -(-n // self.batch_size)

  def _batch_indices(self):
    indices = self._indices.copy()
    if self.shuffle:
      self._rng.shuffle(indices)
    for start in range(0, len(indices), self.batch_size):
      chunk = indices[start:start + self.batch_size]
      if self.drop_last and len(chunk) < self.batch_size:
        return
      yield chunk

  def __iter__(self):
    if not self.num_workers:
      for chunk in self._batch_indices():
        yield _collate([self.dataset[i] for i in chunk])
      return
    with ThreadPoolExecutor(self.num_workers) as pool:
      for chunk in self._batch_indices():
        yield _collate(list(pool.map(self.dataset.__getitem__, chunk)))
