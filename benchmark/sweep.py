"""The highest rate a served cell sustains, by a sweep on the card.

    python3 benchmark/sweep.py --workload NAME --seed N \\
        [--fractions 0.7 0.8 0.9 1.0 1.1] [--seconds 10]

First the cell's requests back to back (no ``rate``): the capacity in
requests a second. Then the cell's traffic at each fraction of that
capacity: each request's latency from when it was due (median, 95th
percentile), the mean wait before the server began it, and the requests
still due and not begun when the window closed. A rate the system
sustains shows a steady wait; above it the wait grows all through the
window. The cells' rates are set from this once, by hand; the benchmark's
own runs never search for one.
"""

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--fractions', type=float, nargs='+',
                      default=[0.7, 0.8, 0.9, 1.0, 1.1])
  parser.add_argument('--seconds', type=float, default=10.0)
  args = parser.parse_args(argv)

  from benchmark import harness
  import torch
  if not torch.cuda.is_available():
    print('sweep: no CUDA device', file=sys.stderr)
    return 2
  spec = harness.load_json(ROOT, 'BENCHMARK.json')

  def measure(rate):
    cell = harness.Cell(spec, args.workload)
    cell.traffic['rate'] = rate
    system = harness.load_module('configs', cell.cell['config']).build(
        cell.conf, cell.traffic, args.seed, 'cuda')
    for i in range(cell.traffic['warm_calls']):
      system.call(i)
      torch.cuda.synchronize()
    rec = harness.window(system, cell.traffic, args.seconds,
                         cell.traffic['warm_calls'], torch.cuda.synchronize,
                         lambda i, out: None)
    lat = sorted(rec.latency)
    half = len(lat) // 2
    row = {'rate': rate, 'calls': rec.calls, 'window_s': rec.window_s,
           'per_s': rec.calls / rec.window_s,
           'p50_ms': statistics.median(lat) * 1e3,
           'p95_ms': statistics.quantiles(lat, n=20)[18] * 1e3,
           'wait_ms': statistics.fmean(rec.wait) * 1e3,
           'wait_first_half_ms': statistics.fmean(rec.wait[:half]) * 1e3,
           'wait_second_half_ms': statistics.fmean(rec.wait[half:]) * 1e3,
           'backlog': rec.backlog}
    print(json.dumps(row), flush=True)
    del system
    torch.cuda.empty_cache()
    return row

  capacity = measure(None)['per_s']
  for fraction in args.fractions:
    measure(fraction * capacity)
  return 0


if __name__ == '__main__':
  sys.exit(main())
