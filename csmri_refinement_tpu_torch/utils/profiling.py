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
* ``span(name)``: a named range of the port's layers (every name starts
  with ``csmri.``) while a ``torch.profiler`` records, and nothing else
  otherwise (below).

The port's spans, each a ``span`` at a layer boundary (nested on its
thread, so a span's parent is the span around it):

* ``csmri.refinement``: a ``RefinementWrapper`` forward;
* ``csmri.recnet.block``: a RecNet ``ConvBlock`` (its convs, LeakyReLUs,
  permutes and casts; not the DC after it);
* ``csmri.dc.<route of H>.<route of W>``: a DC on the card, with the
  routes of ``ops/dc_kernel.py::dc_route`` (``csmri.dc.fft.fft`` at 512²);
  ``csmri.dc.plain`` on the CPU, ``csmri.dc.noisy`` for the noisy merge.
  Their count by name is the DC route count;
* ``csmri.dc_bwd.<route of H>.<route of W>``: K1-bwd (``_DCFunction``'s
  backward, on the autograd engine's thread for a CUDA tensor);
* ``csmri.unet.upconv``: a subpixel up-conv (``SubpixelNNResizeConv``);
* ``csmri.unet.prepare``: the eval weight preparation run on every
  forward: BN folding (``ConvEncodeUnit.chain_layers``), Cout padding and
  packing (``ops/conv_chain.py``'s float conv wrappers) and the subpixel
  phase weights (``SubpixelNNResizeConv.phase_weight``);
* ``csmri.train.step``, ``csmri.train.backward`` (the main thread's wait
  for the backward) and ``csmri.train.optimizer``: ``Runner``'s update.

A reader of the profiler's trace takes the device operations launched
inside a span, on any thread, as the span's work (the port's benchmark:
``benchmark/spans.py``); a device idle gap that begins while the caller
waits inside a span is the span's.
"""

import contextlib
import logging

import torch

_OFF = contextlib.nullcontext()


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


def span(name, *args):
  """``torch.profiler.record_function(name)`` while a profiler records on
  this thread, else a context that does nothing: the check is the whole
  cost of a span with no profiler on (a profiler being on is the only
  switch). ``name`` is a string, or a function that makes one from
  ``args``, called only while recording."""
  if not torch.autograd._profiler_enabled():
    return _OFF
  return torch.profiler.record_function(name if isinstance(name, str)
                                        else name(*args))
