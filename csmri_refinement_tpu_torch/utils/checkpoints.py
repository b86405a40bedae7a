"""Checkpoints with periodic / best / prune semantics.

Port of ``csmri_refinement_tpu/utils/checkpoints.py`` with ``torch.save``
in place of flax msgpack. Layout::

    {
      'conf': <resolved config dict>,
      'runner': <runner.state_dict(): model, optimizer, step>,
      'epoch': int,
      'best_val_metrics': {name: {'value': float, 'direction': 'min'|'max'}},
    }

Loading uses ``torch.load(weights_only=True)``: plain containers and
tensors only. ``load_model_state_dict`` and ``resolve_pretrained_weights``
read one network's state out of another run's checkpoint, for a config's
``pretrained_weights: [path, key]``. The JAX package's msgpack checkpoints
are not read yet.
"""

import logging
import os

import torch

from csmri_refinement_tpu_torch.metrics.metric import (MaxMetric, Metric,
                                                       MinMetric)
from csmri_refinement_tpu_torch.utils.checkpoint_paths import (
    is_checkpoint_path)


def _encode_metrics(best_val_metrics):
  out = {}
  for name, value in (best_val_metrics or {}).items():
    if isinstance(value, Metric):
      out[name] = {'value': float(value.value),
                   'direction': 'min' if isinstance(value, MinMetric)
                   else 'max'}
    else:
      out[name] = {'value': float(value), 'direction': 'max'}
  return out


def _decode_metrics(encoded):
  return {name: (MinMetric if entry['direction'] == 'min' else MaxMetric)(
      float(entry['value'])) for name, entry in (encoded or {}).items()}


def save_checkpoint(path, conf, runner, epoch, best_val_metrics):
  """Write {conf, runner state, epoch, best metrics} to ``path``."""
  state = {
      'conf': conf.to_dict(),
      'runner': runner.state_dict(),
      'epoch': int(epoch),
      'best_val_metrics': _encode_metrics(best_val_metrics),
  }
  tmp_path = path + '.tmp'
  torch.save(state, tmp_path)
  os.replace(tmp_path, path)


def load_checkpoint(path, map_location='cpu'):
  return torch.load(path, map_location=map_location, weights_only=True)


def restore_checkpoint(checkpoint_path, runner):
  """Restore a runner's state; returns {conf, start_epoch,
  best_val_metrics}."""
  checkpoint = load_checkpoint(checkpoint_path, runner.device)
  runner.load_state_dict(checkpoint['runner'])
  return {'conf': checkpoint.get('conf'),
          'start_epoch': int(checkpoint['epoch']),
          'best_val_metrics': _decode_metrics(
              checkpoint['best_val_metrics'])}


def prune_checkpoints(run_dir, num_checkpoints_to_retain=1):
  """Delete the oldest checkpoints beyond the retention count."""
  checkpoints = [f for f in os.listdir(run_dir) if is_checkpoint_path(f)]
  excess = len(checkpoints) - num_checkpoints_to_retain
  for f in sorted(checkpoints)[:max(excess, 0)]:
    chkpt_path = os.path.join(run_dir, f)
    try:
      os.remove(chkpt_path)
    except OSError:
      logging.warning('Could not remove old checkpoint %s', chkpt_path)


def load_model_state_dict(checkpoint_path, model_key):
  """The state dict of network ``model_key`` (``model``, ``generator``,
  ...) in a checkpoint's runner state."""
  checkpoint = load_checkpoint(checkpoint_path)
  if 'runner' not in checkpoint:
    raise ValueError(
        'Did not find runner in checkpoint {}'.format(checkpoint_path))
  if model_key not in checkpoint['runner']:
    raise ValueError('Did not find model {} in checkpoint {}'.format(
        model_key, checkpoint_path))
  return checkpoint['runner'][model_key]


def resolve_pretrained_weights(model_conf, conf_path):
  """Load the state a model section declares with ``pretrained_weights:
  [path, key]``, the path relative to the config file ``conf_path``;
  None when the section sets it to null."""
  if 'pretrained_weights' not in model_conf:
    raise ValueError('Can not initialize {} with pretrained weights: '
                     'missing config key "pretrained_weights"'.format(
                         model_conf.get('name')))
  if model_conf['pretrained_weights'] is None:
    logging.info('Skipping loading pretrained weights for %s (explicitly '
                 'disabled)', model_conf.get('name'))
    return None
  path, model_key = model_conf['pretrained_weights']
  if not os.path.isabs(path) and conf_path is not None:
    path = os.path.join(os.path.dirname(conf_path), path)
  state = load_model_state_dict(path, model_key)
  logging.info('Loaded pretrained weights from checkpoint %s, key %s', path,
               model_key)
  return state
