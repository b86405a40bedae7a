"""Readings that the limits of a cell's check are set from, on the card.

    python3 benchmark/calibrate.py --workload NAME --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--seconds 2] \\
        [--out FILE]

In one process, for each seed: the program as the configuration states
it, a short window at the cell's own load, and its check against the
plain reference (the lower readings); the control (``variant='control'``:
the program's own path one precision below the stated one) on the control
seeds (the upper readings); and on the fault seeds each fault the
configuration plants (its ``FAULTS``), whose readings bound a training
cell's numbers too. Prints one JSON line a run, then the largest sound
reading and the smallest control and fault readings of each number. The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', type=int, nargs='+', required=True)
  parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
  parser.add_argument('--fault-seeds', type=int, nargs='*', default=[])
  parser.add_argument('--seconds', type=float, default=2.0)
  parser.add_argument('--out', default=None)
  args = parser.parse_args(argv)

  from benchmark import harness
  import torch
  if not torch.cuda.is_available():
    print('calibrate: no CUDA device', file=sys.stderr)
    return 2
  cell = harness.Cell(harness.load_json(ROOT, 'BENCHMARK.json'),
                      args.workload)
  faults = getattr(harness.load_module('configs', cell.cell['config']),
                   'FAULTS', ())
  runs = [(None, s) for s in args.seeds]
  runs += [('control', s) for s in args.control_seeds]
  runs += [(f, s) for f in faults for s in args.fault_seeds]
  readings = {}
  out = open(args.out, 'a') if args.out else None
  try:
    for variant, seed in runs:
      t = time.perf_counter()
      details = {}
      line = harness.execute(cell, seed, args.seconds, False, 'cuda',
                             variant=variant, details=details)
      row = {'workload': cell.name, 'variant': variant or 'program',
             'seed': seed, 'seconds': time.perf_counter() - t,
             'attempted': line['attempted'], 'failed': line['failed'],
             'checks': {k: v['value'] for k, v in line['checks'].items()},
             'metrics': {k: v['value'] for k, v in line['metrics'].items()},
             'details': details}
      print(json.dumps(row), flush=True)
      if out:
        out.write(json.dumps(row) + '\n')
      for name, value in row['checks'].items():
        readings.setdefault((row['variant'], name), []).append(value)
      torch.cuda.empty_cache()
  finally:
    if out:
      out.close()
  for (variant, name), values in sorted(readings.items()):
    print('{} {} {}: max {!r} min {!r} over {} seeds'.format(
        cell.name, variant, name, max(values), min(values), len(values)))
  return 0


if __name__ == '__main__':
  sys.exit(main())
