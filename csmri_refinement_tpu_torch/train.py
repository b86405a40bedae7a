"""Training CLI of the port.

    python -m csmri_refinement_tpu_torch.train CONFIG [--conf key=value ...]
        [--data-dir DIR] [--log-dir DIR] [--run-dir DIR]
        [--resume CHECKPOINT] [--dry] [--device cuda|cpu]

Counterpart of the JAX package's ``train.py:241-420``: JSON config plus
``--conf`` overrides, a timestamped run dir with the resolved config,
periodic checkpoints with pruning, per-metric best checkpoints after
``best_value_warmup_epochs``, early stopping and resume. It runs on the card
unless ``--device cpu`` is given (then every kernel's plain version runs);
with no card and no ``--device cpu`` it raises. ``--data-dir`` holds the
ScarSeg tree (``scar_segmentation/<case>/...``). The log goes to the run
dir, ``log_train_<time>.txt``; ``--dry`` writes nothing. ``--resume`` takes
a checkpoint of the port (a JAX checkpoint's optax state is not ported
yet: it raises). TensorBoard summaries (``use_tensorboard`` is ignored),
preemption handling and multi-host runs are not ported.
"""

import argparse
import logging
import os
import sys
import time
from itertools import chain

import torch

from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.training.early_stopping import EarlyStopper
from csmri_refinement_tpu_torch.utils.checkpoint_paths import (
    get_best_checkpoint_path, get_config_path, get_periodic_checkpoint_path,
    get_run_dir, get_time_string)
from csmri_refinement_tpu_torch.utils.checkpoints import (is_flax_checkpoint,
                                                          prune_checkpoints,
                                                          restore_checkpoint,
                                                          save_checkpoint)
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.logging import setup_logging

DEFAULT_EPOCHS_PER_CHECKPOINT = 5
DEFAULT_EPOCHS_PER_VALIDATION = 5
DEFAULT_STEPS_PER_TRAIN_SUMMARY = 1
DEFAULT_NUM_WORKERS = 2
DEFAULT_NUM_PERIODIC_CHECKPOINTS = 1
DEFAULT_NUM_BEST_CHECKPOINTS = 3
DEFAULT_INITIAL_VALIDATION = False
DEFAULT_BEST_VALUE_WARMUP_EPOCHS = 0


def _parser():
  parser = argparse.ArgumentParser(description='Train a model (PyTorch port)')
  parser.add_argument('--dry', action='store_true',
                      help='Do not create output directories')
  parser.add_argument('--conf', nargs='+',
                      help='Optional config values to set (key=value)')
  parser.add_argument('--data-dir', default='resources/data',
                      help='Path to data directory')
  parser.add_argument('--log-dir', default='resources/models',
                      help='Path to log directory')
  parser.add_argument('--run-dir', help='Path to specific output directory')
  parser.add_argument('--resume',
                      help='Path to a checkpoint to resume training from')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help='Device to train on (default: the card)')
  parser.add_argument('config', help='Config file to use')
  return parser


def _save(path, keep, conf, runner, epoch, best_val_metrics):
  if not os.path.isdir(os.path.dirname(path)):
    logging.warning('Skip saving checkpoint: %s does not exist',
                    os.path.dirname(path))
    return
  logging.info('Saving checkpoint to %s', path)
  save_checkpoint(path, conf, runner, epoch, best_val_metrics)
  prune_checkpoints(os.path.dirname(path), keep)


def save_periodic_checkpoint(conf, runner, epoch, best_val_metrics):
  _save(get_periodic_checkpoint_path(conf.run_dir, epoch),
        conf.get_attr('num_periodic_checkpoints',
                      default=DEFAULT_NUM_PERIODIC_CHECKPOINTS),
        conf, runner, epoch, best_val_metrics)


def save_best_checkpoint(best_dir, best_val, conf, runner, epoch,
                         best_val_metrics):
  _save(get_best_checkpoint_path(best_dir, epoch, best_val),
        conf.get_attr('num_best_checkpoints',
                      default=DEFAULT_NUM_BEST_CHECKPOINTS),
        conf, runner, epoch, best_val_metrics)


def run_validation(conf, runner, epoch, val_loader, best_val_metrics,
                   chkpt_metric_dirs, early_stoppers=()):
  best_value_warmup = conf.get_attr('best_value_warmup_epochs',
                                    default=DEFAULT_BEST_VALUE_WARMUP_EPOCHS)
  val_start_time = time.time()
  _, val_losses, val_metrics = runner.validate(val_loader)
  logging.info('===> Validation: %s, time: %.4fs\n%s', ', '.join(
      '{}: {}'.format(name, loss) for name, loss in val_losses.items()),
               time.time() - val_start_time, '\n'.join(
                   '     {}: {}'.format(name, metric)
                   for name, metric in val_metrics.items()))

  for name, value in chain(val_losses.items(), val_metrics.items()):
    if epoch <= best_value_warmup:
      continue
    best_value = name not in best_val_metrics or \
        value > best_val_metrics[name]
    if best_value:
      best_val_metrics[name] = value
      if name in chkpt_metric_dirs:
        save_best_checkpoint(chkpt_metric_dirs[name], value.value, conf,
                             runner, epoch + 1, best_val_metrics)
    for early_stopper in early_stoppers:
      if name == early_stopper.name:
        if best_value:
          early_stopper.record_best_value(value, epoch)
        early_stopper.record_value(value, epoch)
  return val_losses, val_metrics


def train_net(conf, runner, train_loader, val_loader, chkpt_metric_dirs=None,
              restore_state=None, early_stoppers=()):
  chkpt_metric_dirs = chkpt_metric_dirs or {}
  epochs_per_checkpoint = conf.get_attr(
      'epochs_per_checkpoint', default=DEFAULT_EPOCHS_PER_CHECKPOINT)
  epochs_per_validation = conf.get_attr(
      'epochs_per_validation', default=DEFAULT_EPOCHS_PER_VALIDATION)
  steps_per_summary = conf.get_attr(
      'steps_per_train_summary', default=DEFAULT_STEPS_PER_TRAIN_SUMMARY)

  if restore_state is None:
    start_epoch = 1
    best_val_metrics = {}
    if conf.get_attr('initial_validation',
                     default=DEFAULT_INITIAL_VALIDATION):
      logging.info('Running pretraining validation')
      run_validation(conf, runner, 0, val_loader, best_val_metrics,
                     chkpt_metric_dirs, early_stoppers)
      save_periodic_checkpoint(conf, runner, 0, best_val_metrics)
  else:
    start_epoch = restore_state['start_epoch']
    best_val_metrics = restore_state['best_val_metrics']

  for epoch in range(start_epoch, conf.num_epochs + 1):
    runner.epoch_beginning(epoch)
    epoch_start_time = time.time()
    train_losses, train_metrics = runner.train_epoch(
        train_loader, epoch, steps_per_summary)
    logging.info('===> Epoch %d Complete: %s, time: %.4fs\n%s', epoch,
                 ', '.join('{}: {}'.format(name, loss)
                           for name, loss in train_losses.items()),
                 time.time() - epoch_start_time,
                 '\n'.join('     {}: {}'.format(name, metric)
                           for name, metric in train_metrics.items()))

    if epoch % epochs_per_validation == 0:
      run_validation(conf, runner, epoch, val_loader, best_val_metrics,
                     chkpt_metric_dirs, early_stoppers)
    if epoch % epochs_per_checkpoint == 0 or epoch == conf.num_epochs:
      save_periodic_checkpoint(conf, runner, epoch + 1, best_val_metrics)
    for early_stopper in early_stoppers:
      if early_stopper.should_stop(epoch):
        logging.info(early_stopper.stop_reason(epoch))
        return


def build_early_stoppers(conf):
  if conf.has_attr('early_stopping'):
    stopper_confs = [conf.early_stopping]
  else:
    stopper_confs = conf.get_attr('early_stoppers', default=[])
  return [EarlyStopper(c['metric_name'], c['patience'], c.get('min_value'),
                       c.get('max_difference')) for c in stopper_confs]


def main(argv):
  """Run the CLI on ``argv``; returns the runner."""
  args = _parser().parse_args(argv)
  if args.device == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device; pass --device cpu to train on the '
                       'CPU with the plain versions')
  conf = Configuration.from_json(args.config)
  if args.conf:
    conf.update(dict(arg.split('=', 1) for arg in args.conf))

  if args.run_dir:
    conf.run_dir = args.run_dir
  elif args.resume and os.path.exists(args.resume):
    conf.run_dir = os.path.dirname(args.resume)
  if not conf.has_attr('run_dir'):
    conf.run_dir = get_run_dir(args.log_dir,
                               conf.get_attr('run_name',
                                             default='unnamed_run'))
  setup_logging(None if args.dry else conf.run_dir, 'train',
                get_time_string())
  logging.info('Commandline arguments: %s', ' '.join(argv))
  if not args.dry:
    os.makedirs(conf.run_dir, exist_ok=True)
    logging.info('This run is saved to: %s', conf.run_dir)
    conf.serialize(get_config_path(conf.run_dir))

  runner = build_runner(conf, conf.runner_type, 'train', args.device)
  restore_state = None
  if args.resume:
    if not os.path.exists(args.resume):
      raise FileNotFoundError('Checkpoint {} to restore from not '
                              'found'.format(args.resume))
    if is_flax_checkpoint(args.resume):
      raise NotImplementedError('--resume from a JAX checkpoint (its optax '
                                'state) is not ported yet')
    restore_state = restore_checkpoint(args.resume, runner)
    logging.info('Restored checkpoint from %s', args.resume)

  num_workers = conf.get_attr('num_data_workers', default=DEFAULT_NUM_WORKERS)
  train_dataset = load_dataset(
      conf, args.data_dir,
      conf.get_attr('train_dataset', alternative='dataset'), 'train')
  train_loader = DataLoader(
      train_dataset, conf.batch_size, shuffle=True, seed=conf.seed,
      num_workers=num_workers,
      num_samples=conf.get_attr('num_train_subset_samples'))
  val_dataset = load_dataset(
      conf, args.data_dir,
      conf.get_attr('validation_dataset', alternative='dataset'), 'val')
  val_loader = DataLoader(
      val_dataset,
      conf.get_attr('validation_batch_size', default=conf.batch_size),
      num_workers=num_workers,
      num_samples=conf.get_attr('num_validation_subset_samples'))

  chkpt_metrics = conf.get_attr(
      'validation_checkpoint_metrics',
      default=conf.get_attr('best_checkpoint_metrics', default=[]))
  chkpt_metric_dirs = {metric: os.path.join(conf.run_dir, 'best_' + metric)
                       for metric in chkpt_metrics}
  if not args.dry:
    for metric_dir in chkpt_metric_dirs.values():
      os.makedirs(metric_dir, exist_ok=True)

  logging.info('Starting training run of %s epochs on %s', conf.num_epochs,
               runner.device)
  train_net(conf, runner, train_loader, val_loader, chkpt_metric_dirs,
            restore_state, build_early_stoppers(conf))
  return runner


if __name__ == '__main__':
  main(sys.argv[1:])
