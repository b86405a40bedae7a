"""The benchmark's tests: the CPU ones run anywhere; those marked ``cuda``
need the card and skip without it (decided in the ``card`` fixture, never
while a module is imported)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'cuda: needs an NVIDIA GPU and nvcc (skips without a card; '
      'run on the card with -m cuda)')


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip('no CUDA device')


TINY = {'height': 32, 'width': 32, 'batch': 4, 'pool': 3, 'check_block': 2}


@pytest.fixture
def tiny_cell():
  """A cell of ``BENCHMARK.json`` at 32 × 32, batch 4, for the CPU."""
  from benchmark import harness
  spec = harness.load_json(ROOT, 'BENCHMARK.json')

  def make(workload):
    cell = harness.Cell(copy.deepcopy(spec), workload)
    cell.traffic.update(TINY)
    if 'batch_size' in cell.conf:
      cell.conf['batch_size'] = TINY['batch']
    if cell.traffic.get('rate'):
      cell.traffic['rate'] = 40.0
    return cell

  return make
