"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at a tiny size (the
harness's look for a chip skipped), once sound and once with each fault
the cell can have planted in the program: half of the batch left out
(the rest's outputs standing in for it), an answer altered where it is
produced, a train step that returns its state unchanged, on every step
or only once the window has begun, and a window's step that trains on
the batch of the step before. A cell on one chip has no exchange between
chips to leave out.
"""

import pytest
import torch

from benchmark import harness


def _half_batch_forward(forward):
  def broken(self, inp, *extra):
    half = inp.shape[0] // 2
    out = forward(self, inp[:half], *(e[:half] for e in extra))
    return {k: torch.cat([v, v[:inp.shape[0] - half]]) for k, v in
            out.items()}
  return broken


def _altered_forward(forward):
  def broken(self, *args):
    out = forward(self, *args)
    pred = out['pred'].clone()
    pred[0] = pred[0] * 2.0
    out['pred'] = pred
    return out
  return broken


def _half_batch_step(train_batch):
  def broken(self, batch):
    return train_batch(self, {k: v[:v.shape[0] // 2]
                              for k, v in batch.items()})
  return broken


def _unchanged_step(train_batch):
  def broken(self, batch):
    before = [p.detach().clone() for p in self.model.parameters()]
    out = train_batch(self, batch)
    with torch.no_grad():
      for p, b in zip(self.model.parameters(), before):
        p.copy_(b)
    return out
  return broken


def _in_window(fault):
  """``fault`` from the window's first step on, the warm-up's steps
  sound."""
  def wrap(train_batch):
    broken = fault(train_batch)

    def step(self, batch):
      self._steps_seen = getattr(self, '_steps_seen', 0) + 1
      sound = self._steps_seen <= WARM_CALLS
      return (train_batch if sound else broken)(self, batch)
    return step
  return wrap


def _stale_in_window(train_batch):
  """From the window's first step on, each step trains on the batch the
  step before it was given."""
  def broken(self, batch):
    self._steps_seen = getattr(self, '_steps_seen', 0) + 1
    stale = getattr(self, '_stale_batch', batch)
    self._stale_batch = batch
    return train_batch(self, batch if self._steps_seen <= WARM_CALLS
                       else stale)
  return broken


WARM_CALLS = harness.load_json(harness.HERE, 'traffic',
                               'train.512.b20.json')['warm_calls']
SERVE = {'half_batch': _half_batch_forward, 'altered': _altered_forward}
TRAIN = {'half_batch': _half_batch_step, 'unchanged': _unchanged_step,
         'unchanged_in_window': _in_window(_unchanged_step),
         'stale_batch_in_window': _stale_in_window}


def _run(cell):
  return harness.execute(cell, 2 ** 31 + 5, 0.3, False, device='cpu')


@pytest.mark.parametrize('workload', ['flagship.512.b32',
                                      'flagship.512.b32.load80'])
def test_sound_serving_run_is_correct(tiny_cell, workload):
  line = _run(tiny_cell(workload))
  assert line['correct'], line['checks']


@pytest.mark.parametrize('fault', sorted(SERVE))
def test_broken_serving_run_is_not_correct(tiny_cell, monkeypatch, fault):
  from csmri_refinement_tpu_torch.models.refinement_wrapper import (
      RefinementWrapper)
  monkeypatch.setattr(RefinementWrapper, 'forward',
                      SERVE[fault](RefinementWrapper.forward))
  line = _run(tiny_cell('flagship.512.b32'))
  assert not line['correct'], line['checks']


def test_sound_training_run_is_correct(tiny_cell):
  line = _run(tiny_cell('recnet.train.512.b20'))
  assert line['correct'], line['checks']


@pytest.mark.parametrize('fault', sorted(TRAIN))
def test_broken_training_run_is_not_correct(tiny_cell, monkeypatch, fault):
  from csmri_refinement_tpu_torch.training.runner import Runner
  monkeypatch.setattr(Runner, 'train_batch', TRAIN[fault](Runner.train_batch))
  line = _run(tiny_cell('recnet.train.512.b20'))
  assert not line['correct'], line['checks']
