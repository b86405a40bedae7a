"""The program's own spans in a ``torch.profiler`` trace: the ``csmri.``
ranges the port opens at its layer boundaries while a profiler records
(``csmri_refinement_tpu_torch/utils/profiling.py::span`` lists them).

``reduce_spans`` reads the Chrome trace that ``tracing.profiled`` reads,
by the rule ``tracing.reduce_trace`` applies to the benchmark's own
``bench.`` ranges, but on any thread: a device operation belongs to a
span when its launch (the runtime or driver call with the same
correlation id) lies inside one of the span's intervals, whichever thread
made the launch. ``log_lines`` gives one line a span name for a run's log;
its count by name is the DC's route count (``csmri.dc.<route of H>.<route
of W>``).

``METRICS`` gives the rule of each per-layer metric that reads the spans:
a function of a run (``harness.Run``: its ``conf``, ``traffic``, ``peaks``
and ``least_s``) and the run's ``reduce_spans``, that returns None where
the span it reads is missing or ran nothing on the device. A metric's
reader is ``METRICS[name](run, spans)``.
"""

import bisect

from benchmark import work
from benchmark.reference import recnet as recnet_reference
from benchmark.tracing import (DEVICE_CATS, LAUNCH_CATS, _length,
                               _union)

PREFIX = 'csmri.'


def reduce_spans(events):
  """{name: {'count', 'device_s', 'ops', 'host_s'}} of each ``csmri.``
  span name in the trace's events: how many spans, the union in time of
  the device operations launched inside them (seconds) and how many
  those are, and the spans' summed host durations (seconds; a span
  nested in one of its own name counts twice).

  A launch is looked up on every thread, so that ``csmri.train.backward``
  on the caller's thread takes the kernels the autograd engine's device
  thread launches while the caller waits. That is exact while the program
  runs one call at a time, as the benchmark's server does: launches of
  another call, on another thread, would be counted too."""
  xs = [e for e in events if e.get('ph') == 'X']
  intervals = {}
  for e in xs:
    name = e.get('name', '')
    if e.get('cat') == 'user_annotation' and name.startswith(PREFIX):
      start = float(e['ts'])
      intervals.setdefault(name, []).append((start,
                                             start + float(e['dur'])))
  if not intervals:
    return {}
  launches = {}
  for e in xs:
    if e.get('cat') in LAUNCH_CATS:
      corr = (e.get('args') or {}).get('correlation')
      if corr is not None:
        launches[corr] = float(e['ts'])
  merged = {name: _union(ivs) for name, ivs in intervals.items()}
  starts = {name: [s for s, _ in m] for name, m in merged.items()}
  attributed = {name: [] for name in intervals}
  for e in xs:
    if e.get('cat') not in DEVICE_CATS:
      continue
    ts = launches.get((e.get('args') or {}).get('correlation'))
    if ts is None:
      continue
    for name, m in merged.items():
      i = bisect.bisect_right(starts[name], ts) - 1
      if i >= 0 and m[i][1] >= ts:
        attributed[name].append((float(e['ts']),
                                 float(e['ts']) + float(e['dur'])))
  return {name: {'count': len(ivs),
                 'device_s': _length(_union(attributed[name])) * 1e-6,
                 'ops': len(attributed[name]),
                 'host_s': sum(t - s for s, t in ivs) * 1e-6}
          for name, ivs in intervals.items()}


def total(spans, prefix):
  """The spans of every name that starts with ``prefix`` taken together
  (their counts, device and host seconds and operations summed: spans of
  two names are two calls), or None when the trace has none."""
  found = [v for name, v in spans.items() if name.startswith(prefix)]
  if not found:
    return None
  return {key: sum(v[key] for v in found)
          for key in ('count', 'device_s', 'ops', 'host_s')}


def log_lines(spans):
  """One line a span name: calls, device ms, device operations and host
  ms a call."""
  lines = []
  for name in sorted(spans):
    got = spans[name]
    n = got['count']
    lines.append('span {}: {} calls, {:.4f} ms device, {:.1f} ops, '
                 '{:.4f} ms host a call'.format(
                     name, n, got['device_s'] * 1e3 / n, got['ops'] / n,
                     got['host_s'] * 1e3 / n))
  return lines


# Bytes a pixel of a RecNet block's input or output: two bf16 channels
# read and two written.
RECNET_BLOCK_BYTES_PER_PIXEL = 8
# Bytes a pixel of K1-bwd: the gradient read and the result written as
# complex float32, the mask read as float32.
DC_BWD_BYTES_PER_PIXEL = 20


def _ran(spans, name):
  """The spans of ``name`` if some ran on the device, else None."""
  got = (spans or {}).get(name)
  return got if got and got['count'] and got['device_s'] > 0 else None


def _shape(run):
  return run.traffic['height'], run.traffic['width'], run.traffic['batch']


def recnet_roofline_serve(run, spans):
  """A RecNet block's least time (its convs' operations at the bf16
  peak, or its input and output bytes, the larger) × the blocks, over
  their device time, in %."""
  blocks = _ran(spans, 'csmri.recnet.block')
  if blocks is None:
    return None
  h, w, b = _shape(run)
  conf = recnet_reference.model_conf(
      run.conf['generator_model']['pretrained_model'])
  macs = sum(work.recnet_convs(conf, h, w)) / conf['num_blocks']
  least = run.least_s(2 * b * macs, RECNET_BLOCK_BYTES_PER_PIXEL * b * h * w,
                      'bf16')
  return 100.0 * blocks['count'] * least / blocks['device_s']


def upconv_roofline_serve(run, spans):
  """The least time of both decoders' up-convs a request (their products
  at the bf16 peak) × the requests (two up-convs a request), over the
  up-convs' device time, in %."""
  ups = _ran(spans, 'csmri.unet.upconv')
  if ups is None:
    return None
  h, w, b = _shape(run)
  unet = run.conf['generator_model']['learnable_model']
  enc, k = unet['encode_filters'], unet['kernel_size']
  macs, cin = 0, enc[-1]
  for scale, f in enumerate(unet['decode_filters']):
    shift = len(enc) - 2 - scale
    macs += work.resize_conv_macs(h >> shift, w >> shift, cin, f, k)
    cin = f
  least = 2 * b * macs / run.peaks['flops_per_s']['bf16']
  return 100.0 * least * (ups['count'] / 2) / ups['device_s']


def unet_prep_ms_serve(run, spans):
  """The device time of the U-Net's weight preparation a request, in
  ms."""
  prep, requests = (_ran(spans, 'csmri.unet.prepare'),
                    _ran(spans, 'csmri.refinement'))
  if prep is None or requests is None:
    return None
  return prep['device_s'] * 1e3 / requests['count']


def device_ops_per_request_serve(run, spans):
  """The device operations launched inside a forward."""
  requests = _ran(spans, 'csmri.refinement')
  if requests is None:
    return None
  return requests['ops'] / requests['count']


def backward_ms_train(run, spans):
  """The device time of a train step's backward, in ms."""
  backward = _ran(spans, 'csmri.train.backward')
  if backward is None:
    return None
  return backward['device_s'] * 1e3 / backward['count']


def dc_bwd_roofline_train(run, spans):
  """K1-bwd's least time (its two FFTs at the f32 peak, or 20 bytes a
  pixel, the larger) × its calls on every route, over their device time,
  in %."""
  dc_bwd = total(spans or {}, 'csmri.dc_bwd.')
  if dc_bwd is None or not dc_bwd['count'] or dc_bwd['device_s'] <= 0:
    return None
  h, w, b = _shape(run)
  flops, _ = work.dc(h, w)
  least = run.least_s(b * flops, DC_BWD_BYTES_PER_PIXEL * b * h * w, 'f32')
  return 100.0 * least * dc_bwd['count'] / dc_bwd['device_s']


def optimizer_ms_train(run, spans):
  """The device time of a train step's optimizer step, in ms."""
  step = _ran(spans, 'csmri.train.optimizer')
  if step is None:
    return None
  return step['device_s'] * 1e3 / step['count']


METRICS = {
    'recnet_roofline.serve': recnet_roofline_serve,
    'upconv_roofline.serve': upconv_roofline_serve,
    'unet_prep_ms.serve': unet_prep_ms_serve,
    'device_ops_per_request.serve': device_ops_per_request_serve,
    'backward_ms.train': backward_ms_train,
    'dc_bwd_roofline.train': dc_bwd_roofline_train,
    'optimizer_ms.train': optimizer_ms_train,
}
