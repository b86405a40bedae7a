"""Run one cell of the benchmark once, on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration and traffic; ``benchmark/harness.py`` builds the
program from the seed, warms it up, measures for ``--seconds`` and checks
what the window produced against the plain reference. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics and ``breakdown``; last, ``checks``: each compared number beside
its limit, which are also the last lines of standard error). Without a
CUDA device, or with fewer than the cell asks for, it exits with code 2
and prints no result.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this script's folder, so that the
# benchmark's own file names never shadow a module of the same name
sys.path[0] = ROOT


def parse(argv):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return parser.parse_args(argv)


def main(argv=None):
  args = parse(argv)
  from benchmark import harness
  return harness.main(args, T0)


if __name__ == '__main__':
  sys.exit(main())
