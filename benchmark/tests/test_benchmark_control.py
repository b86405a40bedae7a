"""On the card, at each cell's own size: the control (one precision below
the configuration's: the reference in the program's place with its convs
in float8 for the bf16 serving forward, the program's own bfloat16
training for the TF32 train step) comes out not correct, and the program
as stated comes out correct, each in a short window at the cell's own
load.

    python -m pytest benchmark/tests -m cuda
"""

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT, 'BENCHMARK.json')
CELLS = [w['name'] for w in SPEC['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_control_is_not_correct(card, workload):
  line = harness.execute(harness.Cell(SPEC, workload), 2 ** 31 + 77, 2.0,
                         False, 'cuda', variant='control')
  assert not line['correct'], line['checks']


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_program_is_correct(card, workload):
  line = harness.execute(harness.Cell(SPEC, workload), 2 ** 31 + 78, 2.0,
                         False, 'cuda')
  assert line['correct'], line['checks']
