"""One run of one cell: set-up, the measured window, the readers of the
metrics, the check of what the window produced, and the result line.

Everything a cell needs is found by name:

* ``BENCHMARK.json`` names the cell's configuration, traffic and chips,
  and which metrics it reports;
* ``configs/<config>.json`` holds the configuration as it is run, and
  ``configs/<config>.py`` builds it (``build``), counts its work
  (``System.work``) and checks its outputs against
  ``reference/<config>.py`` (``System.check``);
* ``traffic/<traffic>.json`` holds the traffic's parameters, which this
  module's window reads: the shapes, the pool of batches, the warm-up and
  the arrival ``rate`` (requests a second; none: back to back);
* ``metrics/<metric>.py`` reads one metric from the run (``read(run)``,
  a number, or None when it finds nothing to read).

The window is one server taking calls in order. With a ``rate`` call n is
due ``n / rate`` seconds after the window opens; the server waits for it
when it is early and takes it at once when it is late, and a request's
latency runs from when it was due to the synchronize that ends it. The
window closes at ``seconds``; calls begun by then are finished, and the
window's length runs to the later of the close and the last finish.

A traced run (``--trace 1``) splits its ``seconds`` in two windows, one
after the other: the first half without the profiler, whose host clock
the metrics of the host read (``Run.record``: rates, waits, host issue
times), then the second half under ``torch.profiler`` with the
benchmark's ranges installed, whose trace the device's metrics read
(``Run.trace``).
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'csmri_refinement_tpu')


def load_json(*parts):
  with open(os.path.join(*parts)) as f:
    return json.load(f)


def load_module(kind, name):
  """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
  path = os.path.join(HERE, kind, name + '.py')
  spec = importlib.util.spec_from_file_location(
      'benchmark_{}_{}'.format(kind, name.replace('.', '_')), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def forbidden_modules(modules=None):
  """Top-level names in ``sys.modules`` that the run may not hold,
  compared whole (``csmri_refinement_tpu_torch`` is not
  ``csmri_refinement_tpu``)."""
  names = {m.split('.')[0] for m in (sys.modules if modules is None
                                     else modules)}
  return sorted(names & set(FORBIDDEN))


class Cell:
  """A cell of ``BENCHMARK.json`` with its configuration and traffic."""

  def __init__(self, spec, workload):
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
      raise KeyError('no workload {!r} in BENCHMARK.json'.format(workload))
    self.spec = spec
    self.cell = cells[workload]
    self.name = workload
    self.chips = self.cell['chips']
    self.conf = load_json(HERE, 'configs', self.cell['config'] + '.json')
    self.traffic = load_json(HERE, 'traffic', self.cell['traffic'] + '.json')

  def metrics(self, traced):
    """The (name, unit) of the metrics this run reports: the end-to-end
    ones, or with ``traced`` the per-layer ones."""
    e2e = [m for m in self.spec['end_to_end']
           if self.name in m.get('workloads', [self.name])]
    if not traced:
      return [(m['name'], m['unit']) for m in e2e]
    reported = {m['name'] for m in e2e}

    def listed(m):
      if 'workloads' in m:
        return self.name in m['workloads']
      return m['moves'] in reported

    return [(m['name'], m['unit']) for m in self.spec['per_layer']
            if listed(m)]


class Record:
  """What the window saw, in seconds."""

  def __init__(self):
    self.calls = 0
    self.failed = 0
    self.latency = []    # due to finish
    self.wait = []       # due to begin
    self.issue = []      # begin to the call's return, before the sync
    self.window_s = 0.0
    self.backlog = 0     # calls due in the window and not begun
    self.units = 0


def window(system, traffic, seconds, first, sync, on_done):
  """Run calls ``first``, ``first + 1``, ... for ``seconds`` (see the
  module's docstring); ``sync()`` ends each, ``on_done(i, out)`` sees each
  output after it."""
  rate = traffic.get('rate')
  rec = Record()
  start = time.perf_counter()
  deadline = start + seconds
  end = start
  n = 0
  while True:
    now = time.perf_counter()
    if rate:
      due = start + n / rate
      if due >= deadline:
        break
      while now < due:  # spun, not slept: a sleeping thread wakes late
        now = time.perf_counter()
    else:
      due = now
    if now >= deadline:
      rec.backlog = max(0, math.ceil((deadline - start) * rate) - n) \
          if rate else 0
      break
    i = first + n
    try:
      out = system.call(i)
      issued = time.perf_counter()
      sync()
    except Exception:  # a failed call is counted and the window goes on
      traceback.print_exc()
      rec.failed += 1
      out, issued = None, time.perf_counter()
    end = time.perf_counter()
    rec.latency.append(end - due)
    rec.wait.append(now - due)
    rec.issue.append(issued - now)
    if out is not None:
      on_done(i, out)
    n += 1
  rec.calls = n
  rec.units = (n - rec.failed) * system.units
  rec.window_s = max(end, deadline) - start
  return rec


class Run:
  """What a metric's reader is given."""

  def __init__(self, cell, record, setup_s, work, trace, peaks):
    """``record``: the window without the profiler (in a traced run its
    first half); ``trace``: the reduced trace of the profiled window."""
    self.cell = cell
    self.conf = cell.conf
    self.traffic = cell.traffic
    self.record = record
    self.setup_s = setup_s
    self.work = work
    self.trace = trace
    self.peaks = peaks

  def range(self, name):
    """(count, device seconds) of the ``bench.<name>`` ranges in the
    trace, or None without a trace or ranges that ran on the device."""
    if self.trace is None:
      return None
    got = self.trace['ranges'].get('bench.' + name)
    if not got or not got['count'] or got['device_s'] <= 0:
      return None
    return got['count'], got['device_s']

  def least_s(self, flops, nbytes, precision):
    """The least time of ``flops`` operations at the ``precision`` peak
    and ``nbytes`` bytes at the memory's peak."""
    return max(flops / self.peaks['flops_per_s'][precision],
               nbytes / self.peaks['bytes_per_s'])

  def roofline(self, name, flops, nbytes, precision):
    """The ``bench.<name>`` ranges' least time (``flops`` and ``nbytes``
    a range) over their device time, in %; None without them."""
    got = self.range(name)
    if got is None:
      return None
    count, device_s = got
    return 100.0 * count * self.least_s(flops, nbytes, precision) / device_s

  def mfu(self):
    """The work of the calls completed in the window without the profiler
    over its length and the configuration's peak, in %; None untraced."""
    if self.trace is None:
      return None
    done = self.record.calls - self.record.failed
    peak = self.peaks['flops_per_s'][self.conf['bench']['peak']]
    return 100.0 * self.work['flops_per_call'] * done / \
        self.record.window_s / peak

  def idle_share(self):
    """The traced window's share with nothing on the device, in %."""
    if self.trace is None or self.trace['window_s'] <= 0:
      return None
    return 100.0 * (1.0 - self.trace['busy_s'] / self.trace['window_s'])


def card_line():
  """The card's name and power limit from ``nvidia-smi``, or why not."""
  try:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
  except (OSError, subprocess.SubprocessError) as e:
    return 'nvidia-smi failed: {}'.format(e)


def execute(cell, seed, seconds, traced, device='cuda', t0=None,
            variant=None, log=sys.stderr, details=None):
  """Run ``cell`` once; returns the result line's dict, or raises. With
  ``device='cpu'`` (tests) the chip is not looked for; ``details``, a
  dict, receives what the check kept beside its numbers (calibration)."""
  import torch
  t0 = time.perf_counter() if t0 is None else t0
  stamps = [('torch', time.perf_counter())]
  cuda = device != 'cpu'
  if cuda:
    torch.cuda.init()
    stamps.append(('cuda', time.perf_counter()))
  config = load_module('configs', cell.cell['config'])
  system = config.build(cell.conf, cell.traffic, seed, device, variant)
  stamps.append(('build', time.perf_counter()))
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  for i in range(cell.traffic['warm_calls']):
    out = system.call(i)
    sync()
    system.done(i, out, warm=True)
    stamps.append(('warm', time.perf_counter()))
  setup_s = time.perf_counter() - t0
  last = t0
  for i, (name, t) in enumerate(stamps):
    stamps[i], last = '{} {:.3f}'.format(name, t - last), t
  print('set-up {:.3f} s: {}'.format(setup_s, ', '.join(stamps)), file=log)
  ready = getattr(system, 'ready', None)
  if ready is not None:
    ready()
    sync()

  on_done = lambda i, out: system.done(i, out, warm=False)
  first = cell.traffic['warm_calls']
  plain = seconds / 2 if traced else seconds
  rec = window(system, cell.traffic, plain, first, sync, on_done)
  windows = [rec]
  trace_out = {}
  if traced:
    from benchmark import tracing
    ranges = tracing.Ranges()
    system.install(ranges)
    with tracing.profiled(trace_out):
      windows.append(window(system, cell.traffic, seconds - plain,
                            first + rec.calls, sync, on_done))
    ranges.close()
  memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
  calls = sum(w.calls for w in windows)
  failed = sum(w.failed for w in windows)

  peaks = load_json(HERE, 'peaks.json')
  run = Run(cell, rec, setup_s, system.work(), trace_out.get('trace'), peaks)
  metrics = {}
  for name, unit in cell.metrics(traced):
    value = load_module('metrics', name).read(run)
    if value is not None:
      metrics[name] = {'value': value, 'unit': unit}

  system.release()
  if cuda:
    torch.cuda.empty_cache()
  checks = system.check()
  if details is not None:
    details.update(getattr(system, 'details', {}))
  # a limit not set yet (null) passes nothing
  correct = failed == 0 and bool(checks) and all(
      limit is not None and math.isfinite(v) and v <= limit
      for _, v, limit in checks)

  card = card_line() if cuda else 'cpu'
  print('card: {}; peaks (NVIDIA data sheet, 700 W): bf16 {:g}, tf32 {:g}, '
        'f32 {:g} FLOP/s, {:g} B/s'.format(
            card, peaks['flops_per_s']['bf16'], peaks['flops_per_s']['tf32'],
            peaks['flops_per_s']['f32'], peaks['bytes_per_s']), file=log)
  for w, what in zip(windows, ('window', 'traced window')):
    print('{}: {} calls, {} failed, {} due and not begun, {:.3f} s'.format(
        what, w.calls, w.failed, w.backlog, w.window_s), file=log)
  print('set-up {:.3f} s'.format(setup_s), file=log)
  dev = {'platform': 'gpu' if cuda else 'cpu',
         'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
         'count': cell.chips, 'memory_peak_bytes': memory_peak}
  line = {'correct': correct, 'attempted': calls, 'failed': failed,
          'metrics': metrics, 'device': dev}
  trace = trace_out.get('trace')
  if trace is not None:
    dev['busy_s'] = trace['busy_s']
    dev['window_s'] = trace['window_s']
    line['breakdown'] = {'device_ops': trace['device_ops'],
                         'idle_gaps': trace['idle_gaps']}
  line['checks'] = {name: {'value': v, 'limit': limit}
                    for name, v, limit in checks}
  for name, v in getattr(system, 'reported', {}).items():
    print('reported, not compared: {} {!r}'.format(name, v), file=log)
  for name, v, limit in checks:
    print('check {} {!r} limit {!r}'.format(name, v, limit), file=log)
  bad = forbidden_modules()
  if bad:
    raise RuntimeError('the run loaded {}'.format(', '.join(bad)))
  return line


def main(args, t0):
  """The command's body; returns its exit code."""
  spec = load_json(ROOT, 'BENCHMARK.json')
  cell = Cell(spec, args.workload)
  import torch
  if not torch.cuda.is_available() or \
      torch.cuda.device_count() < cell.chips:
    print('benchmark: the cell needs {} CUDA device(s); this machine has '
          '{}'.format(cell.chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else 0), file=sys.stderr)
    return 2
  line = execute(cell, args.seed, args.seconds, bool(args.trace), 'cuda', t0)
  sys.stderr.flush()
  print(json.dumps(line))
  return 0
