"""Checkpoints with periodic / best / prune semantics, in either package's
format.

Port of ``csmri_refinement_tpu/utils/checkpoints.py``. The port writes
``torch.save`` files where the JAX package writes flax msgpack; both hold
the layout::

    {
      'conf': <resolved config dict>,
      'runner': <runner.state_dict(): model, optimizer, step>,
      'epoch': int,
      'best_val_metrics': {name: {'value': float, 'direction': 'min'|'max'}},
    }

``load_checkpoint`` reads either: a file that starts as a zip archive is
the port's (``torch.load(weights_only=True)``: plain containers and tensors
only), any other the JAX package's (``utils/flax_msgpack.py``, no flax).
In a JAX checkpoint each network (``model``, ``generator``,
``discriminator``) is a flax variable tree ``{'params', 'batch_stats'}`` of
numpy arrays, which ``load_network_state`` copies into a port module
through ``utils/jax_weights.py``; its optax state has no port counterpart
yet, so ``restore_checkpoint`` restores the networks, their BN statistics
and the step of a JAX checkpoint and leaves the optimizers as they are
(ROADMAP Queue 1: ``--resume`` from a JAX checkpoint).
``load_model_state_dict`` and ``resolve_pretrained_weights`` read one
network's state out of another run's checkpoint, for a config's
``pretrained_weights: [path, key]``.
"""

import logging
import os

import torch

from csmri_refinement_tpu_torch.metrics.metric import (MaxMetric, Metric,
                                                       MinMetric)
from csmri_refinement_tpu_torch.utils.checkpoint_paths import (
    is_checkpoint_path)
from csmri_refinement_tpu_torch.utils.flax_msgpack import msgpack_restore
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

_ZIP_MAGIC = b'PK\x03\x04'
# Runner-state keys of optimizer state, which a JAX checkpoint holds as
# optax trees.
OPTIMIZER_KEYS = ('optimizer', 'gen_optimizer', 'disc_optimizer')


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
  out = {}
  for name, entry in (encoded or {}).items():
    if isinstance(entry, dict):
      cls = MinMetric if entry.get('direction') == 'min' else MaxMetric
      out[name] = cls(float(entry['value']))
    else:
      out[name] = MaxMetric(float(entry))
  return out


def is_flax_tree(state):
  """True for a flax variable tree (nested dicts), False for a port state
  dict (names to tensors)."""
  return any(isinstance(v, dict) for v in state.values())


def load_network_state(module, state):
  """Load a port state dict or a flax variable tree (``{'params', ...}``
  or a bare params tree) into ``module``, every tensor of it."""
  if not is_flax_tree(state):
    module.load_state_dict(state)
  elif 'params' in state:
    load_flax_variables(module, state)
  else:
    load_flax_variables(module, {'params': state})


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


def is_flax_checkpoint(path):
  with open(path, 'rb') as f:
    return f.read(len(_ZIP_MAGIC)) != _ZIP_MAGIC


def load_checkpoint(path, map_location='cpu'):
  """The checkpoint dict at ``path``, of either package."""
  if not is_flax_checkpoint(path):
    return torch.load(path, map_location=map_location, weights_only=True)
  with open(path, 'rb') as f:
    return msgpack_restore(f.read())


def restore_checkpoint(checkpoint_path, runner):
  """Restore a runner's state from a checkpoint of either package; returns
  {conf, start_epoch, best_val_metrics} (the last two where the checkpoint
  has them)."""
  checkpoint = load_checkpoint(checkpoint_path, runner.device)
  runner_state = checkpoint['runner']
  dropped = [k for k in OPTIMIZER_KEYS if k in runner_state] if \
      is_flax_checkpoint(checkpoint_path) else []
  if dropped:
    logging.warning('Not restoring %s of the JAX checkpoint %s (optax '
                    'state)', ', '.join(dropped), checkpoint_path)
    runner_state = {k: v for k, v in runner_state.items()
                    if k not in dropped}
  runner.load_state_dict(runner_state)
  state = {'conf': checkpoint.get('conf')}
  if 'epoch' in checkpoint:
    state['start_epoch'] = int(checkpoint['epoch'])
  if 'best_val_metrics' in checkpoint:
    state['best_val_metrics'] = _decode_metrics(
        checkpoint['best_val_metrics'])
  return state


def inference_checkpoint_from_training_checkpoint(checkpoint, runner_type):
  """The checkpoint with only its inference network (``model`` for the
  standard runner, ``generator`` for the adversarial one) and its conf."""
  inference_net = {'standard': 'model',
                   'adversarial': 'generator'}.get(runner_type)
  if inference_net is None:
    raise ValueError('Unknown runner_type {}'.format(runner_type))
  if inference_net not in checkpoint['runner']:
    raise ValueError('Checkpoint does not support runner_type {}'.format(
        runner_type))
  return {'conf': checkpoint['conf'],
          'runner': {inference_net: checkpoint['runner'][inference_net]}}


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
  """The state of network ``model_key`` (``model``, ``generator``, ...) in
  a checkpoint's runner state: a port state dict or a flax tree."""
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
