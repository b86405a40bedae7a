"""Batched data loading with a prefetch queue.

Port of ``csmri_refinement_tpu/data/loader.py`` for one process: batches of
dict items stacked into numpy arrays, shuffled per epoch by a
``RandomState(seed)`` (the same index stream as the JAX loader), an
optional subset (``num_samples``), a ragged final batch unless
``drop_last``. Items are prepared by ``num_workers`` threads when that is
above 0 (numpy's FFTs and reductions release the GIL); a dataset with a
``native_batch`` method (the host library's path) prepares whole batches
there when it returns one. With ``prefetch`` above 1 a producer thread
prepares up to ``prefetch`` batches ahead of the consumer, so the host's
work on the next batch overlaps the card's on this one; an exception
raised while preparing a batch is raised in the consumer at that batch.
``wait_s`` sums the seconds the consumer spent waiting for batches.

``process_shard=(rank, world)`` is the multi-process data path (JAX
``loader.py:31-92``): ``batch_size`` stays the global batch size, the
index stream (shuffle order, epoch boundaries) is the global one on every
process (same ``seed``), and each process makes only its contiguous
1/world slice of every batch, so that the slices in rank order are the
single-process batch. A ragged final batch shrinks to a multiple of world,
or is dropped when smaller than world; ``__len__`` counts so.
"""

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_END = object()


def _collate(items):
  return {key: np.stack([item[key] for item in items]) for key in items[0]}


class DataLoader:
  """Iterable over batches of a ``SliceDataset``-like dataset."""

  def __init__(self, dataset, batch_size, shuffle=False, seed=0,
               num_workers=0, drop_last=False, prefetch=2, num_samples=None,
               process_shard=None):
    self.dataset = dataset
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.num_workers = num_workers
    self.drop_last = drop_last
    self.prefetch = max(prefetch, 1)
    self.wait_s = 0.0
    self.process_shard = process_shard
    if process_shard is not None:
      rank, world = process_shard
      if not 0 <= rank < world:
        raise ValueError('process_shard {} names no rank of its world'
                         .format(process_shard))
      if batch_size % world:
        raise ValueError('Global batch size {} must divide evenly over {} '
                         'processes'.format(batch_size, world))
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
    if self.process_shard is not None:
      full, rem = divmod(n, self.batch_size)
      return full + (1 if rem >= self.process_shard[1] else 0)
    return -(-n // self.batch_size)

  def _batch_indices(self):
    indices = self._indices.copy()
    if self.shuffle:
      self._rng.shuffle(indices)
    for start in range(0, len(indices), self.batch_size):
      chunk = indices[start:start + self.batch_size]
      if self.drop_last and len(chunk) < self.batch_size:
        return
      if self.process_shard is not None:
        rank, world = self.process_shard
        per = len(chunk) // world
        if per == 0:
          return      # a final batch smaller than the process count
        chunk = chunk[rank * per:(rank + 1) * per]
      yield chunk

  def _make_batch(self, chunk, pool):
    # The dataset's native batch path first, where it has one
    native_batch = getattr(self.dataset, 'native_batch', None)
    if native_batch is not None:
      batch = native_batch(chunk)
      if batch is not None:
        return batch
    if pool is None:
      return _collate([self.dataset[i] for i in chunk])
    return _collate(list(pool.map(self.dataset.__getitem__, chunk)))

  def _batches(self, pool):
    for chunk in self._batch_indices():
      yield self._make_batch(chunk, pool)

  def __iter__(self):
    pool = ThreadPoolExecutor(self.num_workers) if self.num_workers else None
    try:
      if self.prefetch <= 1:
        for batch in self._batches(pool):
          yield batch
      else:
        yield from self._prefetched(pool)
    finally:
      if pool is not None:
        pool.shutdown(cancel_futures=True)

  def _prefetched(self, pool):
    q = queue.Queue(maxsize=self.prefetch)
    stop = threading.Event()

    def put(item):
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          pass
      return False

    def producer():
      try:
        for batch in self._batches(pool):
          if not put(batch):
            return
      except Exception as e:  # raised again in the consumer
        put(e)
      put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
      while True:
        t0 = time.perf_counter()
        item = q.get()
        self.wait_s += time.perf_counter() - t0
        if item is _END:
          return
        if isinstance(item, Exception):
          raise item
        yield item
    finally:
      stop.set()
      thread.join()
