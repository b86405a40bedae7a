"""BaseRunner: the epoch loop over a runner's train and validation steps.

Port of ``csmri_refinement_tpu/training/base_runner.py``: the epoch loop,
metric accumulation, the validation loop (which returns its first
``num_batches_to_return`` batches, moved to the host) and the inference
loop (every batch, no losses or metrics) are the same; a subclass supplies
the steps. ``steps_per_fetch`` (several updates per loss fetch) is not
ported: each step's losses are fetched as it ends. With a summary writer
``train_epoch`` adds each summarised step's losses and metrics as
``train/<name>`` scalars at the JAX package's global step, ``n · (epoch −
1) + batch`` for n batches per epoch; they are the values the step already
fetched for its log line.
"""

import logging
from itertools import chain

import torch

from csmri_refinement_tpu_torch.data.transform_wrappers import (
    get_output_transform)
from csmri_refinement_tpu_torch.metrics import accumulate_metric


def to_host(tree):
  """``tree`` with every tensor moved to the CPU."""
  if isinstance(tree, dict):
    return {k: to_host(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(to_host(v) for v in tree)
  if isinstance(tree, torch.Tensor):
    return tree.cpu()
  return tree


class BaseRunner:

  def __init__(self, conf, mode):
    self.conf = conf
    self.mode = mode
    self.epoch = 0
    self.output_transform = get_output_transform(
        conf.get_attr('application', default='reconstruction'))

  # -- subclass hooks ---------------------------------------------------------

  def _train_step(self, batch_iter):
    """Consume a batch from ``batch_iter`` and update; returns
    (num_batches_consumed, loss_metrics, data for _compute_train_metrics)."""
    raise NotImplementedError

  def _val_step(self, batch, compute_metrics=True):
    """Returns (loss metrics, or {} without ``compute_metrics``; data for
    _compute_test_metrics and get_named_outputs)."""
    raise NotImplementedError

  def _compute_train_metrics(self, data):
    raise NotImplementedError

  def _compute_test_metrics(self, data):
    raise NotImplementedError

  def epoch_beginning(self, epoch):
    pass

  def epoch_finished(self, epoch):
    pass

  # -- engine -----------------------------------------------------------------

  def train_epoch(self, loader, epoch, summary_writer=None,
                  steps_per_train_summary=1, verbose=False):
    self.epoch = epoch
    num_batches_per_epoch = len(loader)
    epoch_loss_metrics = {}
    epoch_metrics = {}

    current_batch = 0
    batch_iter = iter(loader)
    while current_batch < num_batches_per_epoch:
      num_batches, loss_metrics, data = self._train_step(batch_iter)
      if num_batches == 0:
        break
      current_batch += num_batches
      metrics = self._compute_train_metrics(data)
      del data

      for name, loss_metric in loss_metrics.items():
        accumulate_metric(epoch_loss_metrics, name, loss_metric)
      for name, metric in metrics.items():
        accumulate_metric(epoch_metrics, name, metric)

      if current_batch % steps_per_train_summary == 0:
        s = '===> Epoch[{}]({}/{}): '.format(epoch, current_batch,
                                             num_batches_per_epoch)
        s += ', '.join('{}: {}'.format(name, metric)
                       for name, metric in loss_metrics.items())
        if verbose:
          s += '\n' + '\n'.join('     {}: {}'.format(name, metric)
                                for name, metric in metrics.items())
        logging.info(s)
        if summary_writer is not None:
          global_step = num_batches_per_epoch * (epoch - 1) + current_batch
          for name, metric in chain(loss_metrics.items(), metrics.items()):
            summary_writer.add_scalar('train/{}'.format(name), metric.value,
                                      global_step)

    value_by_loss = {name: m.average()
                     for name, m in epoch_loss_metrics.items()}
    value_by_metric = {name: m.average() for name, m in epoch_metrics.items()}
    return value_by_loss, value_by_metric

  def validate(self, loader, num_batches_to_return=0):
    """Returns (the first ``num_batches_to_return`` batches' data on the
    host, {loss name: metric}, {metric name: metric}) averaged over the
    loader."""
    epoch_data = []
    epoch_loss_metrics = {}
    epoch_metrics = {}
    for batch in loader:
      loss_metrics, data = self._val_step(batch)
      if len(epoch_data) < num_batches_to_return:
        epoch_data.append(to_host(data))
      metrics = self._compute_test_metrics(data)
      del data
      for name, loss_metric in loss_metrics.items():
        accumulate_metric(epoch_loss_metrics, name, loss_metric)
      for name, metric in metrics.items():
        accumulate_metric(epoch_metrics, name, metric)

    value_by_loss = {name: m.average()
                     for name, m in epoch_loss_metrics.items()}
    value_by_metric = {name: m.average() for name, m in epoch_metrics.items()}
    return epoch_data, value_by_loss, value_by_metric

  def get_named_outputs(self, data):
    """{'input', 'prediction', 'target'} of a validation step's data
    (batch, model output, ...), the prediction and target through the
    application's output transform."""
    batch, out = data[0], data[1]
    prediction = out['pred'] if isinstance(out, dict) else out
    target = batch['target']
    if self.output_transform is not None:
      prediction, target = self.output_transform(prediction, target)
    return {'input': batch['inp'], 'prediction': prediction,
            'target': target}

  def infer(self, loader):
    """Every batch's data on the host, without losses or metrics."""
    return [to_host(self._val_step(batch, compute_metrics=False)[1])
            for batch in loader]

  @staticmethod
  def _loss_weights(weights_by_criterion, *criteria_dicts):
    """Per-criterion weight dict, default 1.0."""
    weights = {}
    for criteria in criteria_dicts:
      for name in criteria:
        weights[name] = float(weights_by_criterion.get(name, 1.0))
    return weights
