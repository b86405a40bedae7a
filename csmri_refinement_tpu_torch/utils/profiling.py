"""Profiling hooks.

Port of ``csmri_refinement_tpu/utils/profiling.py``:

* ``trace(log_dir)`` wraps a scope in a ``torch.profiler`` trace of the
  host and, where there is a card, its kernels, written on exit as a
  Chrome trace (``*.pt.trace.json``, for Perfetto or TensorBoard) into
  ``log_dir``; it does nothing when ``log_dir`` is falsy. The training
  CLI's ``--profile-dir`` wraps ``train_net`` in it.
* ``timed_ms(fn, iters, warmup)``: mean milliseconds per call of ``fn`` on
  the card, from CUDA events around ``iters`` calls after ``warmup``
  calls. It takes the place of the JAX package's ``timed_scan``, the TPU's
  scan-slope idiom: here the events are recorded on the stream the calls
  run on, so the time is the card's, whatever the host returned before.
* ``StepTimer``: host wall times per step with summary statistics (a
  copy).
"""

import contextlib
import logging
import time

import numpy as np
import torch


def timed_ms(fn, iters=20, warmup=3):
  """Mean ms per call of ``fn`` with CUDA events, after warm-up."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


@contextlib.contextmanager
def trace(log_dir):
  """``torch.profiler`` trace scope written to ``log_dir``; no-op if
  ``log_dir`` is falsy."""
  if not log_dir:
    yield
    return
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  logging.info('Writing profiler trace to %s', log_dir)
  with torch.profiler.profile(
      activities=activities,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
    yield


class StepTimer:
  """Accumulates per-step wall times; reports mean/p50/p95."""

  def __init__(self, name='step'):
    self.name = name
    self.times = []
    self._start = None

  def __enter__(self):
    self._start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    self.times.append(time.perf_counter() - self._start)

  def summary(self):
    if not self.times:
      return '{}: no samples'.format(self.name)
    arr = np.asarray(self.times)
    return ('{}: n={} mean={:.4f}s p50={:.4f}s p95={:.4f}s').format(
        self.name, len(arr), arr.mean(), np.percentile(arr, 50),
        np.percentile(arr, 95))
