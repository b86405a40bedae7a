"""The traced run: ranges around the program's layers and the reduction of
a ``torch.profiler`` trace to device time.

``Ranges`` opens a named host range (``torch.profiler.record_function``,
``bench.<layer>``) around calls into a layer: forward hooks on a module,
or a wrapper put in place of a module attribute for the traced run only.
``reduce_trace`` reads the profiler's Chrome trace:

* the device operations (kernels, copies, sets) and their union in time,
  inside the ``bench.window`` range: ``busy_s`` and the idle share;
* each ``bench.<layer>`` range's device time: the union of the device
  operations whose launch (the runtime or driver call with the same
  correlation id) lies inside one of its ranges. Names of kernels play no
  part, so a kernel renamed, fused or replaced keeps the metric defined;
* the device operations that took most time, and the device's idle gaps
  summed by what the host was doing when each began (the innermost host
  range or operation of the thread that ran the window).
"""

import bisect
import contextlib
import json
import os
import tempfile

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
WINDOW = 'bench.window'
TOP = 10
# gaps shorter than this are summed under one name, not looked up
SHORT_GAP_US = 10.0


def record(name):
  import torch
  return torch.profiler.record_function(name)


class Ranges:
  """Host ranges around layer calls, installed for the traced run only and
  removed on exit."""

  def __init__(self):
    self._undo = []

  def module(self, module, name):
    """``bench.<name>`` around every forward of ``module``."""
    stack = []

    def pre(mod, args):
      rng = record('bench.' + name)
      rng.__enter__()
      stack.append(rng)

    def post(mod, args, out):
      stack.pop().__exit__(None, None, None)

    handles = [module.register_forward_pre_hook(pre),
               module.register_forward_hook(post)]
    self._undo.append(lambda: [h.remove() for h in handles])

  def attribute(self, owner, attr, name):
    """``bench.<name>`` around every call of ``owner.attr``, looked up at
    call time by its callers."""
    original = getattr(owner, attr)

    def wrapped(*args, **kwargs):
      with record('bench.' + name):
        return original(*args, **kwargs)

    setattr(owner, attr, wrapped)
    self._undo.append(lambda: setattr(owner, attr, original))

  def close(self):
    while self._undo:
      self._undo.pop()()


@contextlib.contextmanager
def profiled(out):
  """Profile the block (host and device) and put its reduced trace in
  ``out['trace']``. The Chrome trace goes to a temporary file, removed
  after reading."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with record(WINDOW):
      yield
    torch.cuda.synchronize()
  fd, path = tempfile.mkstemp(suffix='.json')
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)['traceEvents']
  finally:
    os.remove(path)
  out['trace'] = reduce_trace(events)


def _union(intervals):
  """Merged [start, end) intervals, sorted."""
  merged = []
  for start, end in sorted(intervals):
    if merged and start <= merged[-1][1]:
      if end > merged[-1][1]:
        merged[-1][1] = end
    else:
      merged.append([start, end])
  return merged


def _clip(merged, lo, hi):
  return [(max(s, lo), min(e, hi)) for s, e in merged if e > lo and s < hi]


def _length(intervals):
  return sum(e - s for s, e in intervals)


def reduce_trace(events):
  """The trace's summary: window, busy and range times in seconds, the top
  device operations and idle gaps (see the module's docstring). Raises
  when the trace holds no ``bench.window`` range."""
  xs = [e for e in events if e.get('ph') == 'X']
  windows = [e for e in xs if e.get('name') == WINDOW]
  if not windows:
    raise ValueError('the trace holds no {} range'.format(WINDOW))
  win = windows[0]
  lo, hi = float(win['ts']), float(win['ts']) + float(win['dur'])
  main_tid = win.get('tid')

  device = [e for e in xs if e.get('cat') in DEVICE_CATS]
  merged = _clip(_union((float(e['ts']), float(e['ts']) + float(e['dur']))
                        for e in device), lo, hi)

  launches = {}
  for e in xs:
    if e.get('cat') in LAUNCH_CATS:
      corr = (e.get('args') or {}).get('correlation')
      if corr is not None:
        launches[corr] = (e.get('tid'), float(e['ts']))

  # ranges by name, per thread: sorted starts and ends for a bisect
  spans = {}
  for e in xs:
    name = e.get('name', '')
    if e.get('cat') == 'user_annotation' and name.startswith('bench.') \
        and name != WINDOW:
      spans.setdefault(name, {}).setdefault(e.get('tid'), []).append(
          (float(e['ts']), float(e['ts']) + float(e['dur'])))
  counts = {name: sum(len(v) for v in per_tid.values())
            for name, per_tid in spans.items()}
  lookup = {}
  for name, per_tid in spans.items():
    for tid, ivs in per_tid.items():
      ivs.sort()
      lookup.setdefault(name, {})[tid] = ([s for s, _ in ivs],
                                          [e for _, e in ivs])
  attributed = {name: [] for name in spans}
  for e in device:
    launch = launches.get((e.get('args') or {}).get('correlation'))
    if launch is None:
      continue
    tid, ts = launch
    for name, per_tid in lookup.items():
      if tid not in per_tid:
        continue
      starts, ends = per_tid[tid]
      i = bisect.bisect_right(starts, ts) - 1
      if i >= 0 and ends[i] >= ts:
        attributed[name].append((float(e['ts']),
                                 float(e['ts']) + float(e['dur'])))
  ranges = {name: {'count': counts[name],
                   'device_s': _length(_union(ivs)) * 1e-6}
            for name, ivs in attributed.items()}

  by_op = {}
  for e in device:
    s, t = max(float(e['ts']), lo), min(float(e['ts']) + float(e['dur']), hi)
    if t > s:
      key = e.get('name', '?')[:120]
      by_op[key] = by_op.get(key, 0.0) + (t - s) * 1e-6
  device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

  return {'window_s': (hi - lo) * 1e-6, 'busy_s': _length(merged) * 1e-6,
          'ranges': ranges, 'device_ops': [list(kv) for kv in device_ops],
          'idle_gaps': _idle_gaps(xs, merged, lo, hi, main_tid)}


def _idle_gaps(xs, merged, lo, hi, tid):
  """[name, seconds] of the device's idle time inside [lo, hi), summed by
  the innermost host range or operation of thread ``tid`` open when each
  gap began; the largest ``TOP``."""
  gaps, cursor = [], lo
  for s, e in merged:
    if s > cursor:
      gaps.append((cursor, s - cursor))
    cursor = max(cursor, e)
  if hi > cursor:
    gaps.append((cursor, hi - cursor))
  host = sorted(((float(e['ts']), -float(e['dur']), e.get('name', '?'))
                 for e in xs if e.get('cat') in HOST_CATS and
                 e.get('tid') == tid), key=lambda t: (t[0], t[1]))
  totals, stack, i = {}, [], 0
  for start, length in gaps:
    if length < SHORT_GAP_US:
      key = 'gaps under {:g} us'.format(SHORT_GAP_US)
    else:
      while i < len(host) and host[i][0] <= start:
        ts, neg_dur, name = host[i]
        while stack and stack[-1][0] <= ts:
          stack.pop()
        stack.append((ts - neg_dur, name))
        i += 1
      while stack and stack[-1][0] < start:
        stack.pop()
      key = stack[-1][1][:120] if stack else 'outside any host operation'
    totals[key] = totals.get(key, 0.0) + length * 1e-6
  return [list(kv) for kv in
          sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
