"""Training CLI of the port.

    python -m csmri_refinement_tpu_torch.train CONFIG [--conf key=value ...]
        [--data-dir DIR] [--log-dir DIR] [--run-dir DIR]
        [--resume CHECKPOINT] [--dry] [--device cuda|cpu]
        [-v] [-p] [--print-parameters] [--profile-dir DIR]

Counterpart of the JAX package's ``train.py``: JSON config plus ``--conf``
overrides, a timestamped run dir with the resolved config, periodic
checkpoints with pruning, per-metric best checkpoints after
``best_value_warmup_epochs``, early stopping and resume. It runs on the card
unless ``--device cpu`` is given (then every kernel's plain version runs);
with no card and no ``--device cpu`` it raises. ``--data-dir`` holds the
ScarSeg tree (``scar_segmentation/<case>/...``). The log goes to the run
dir, ``log_train_<time>.txt``; ``--dry`` writes nothing. ``--resume`` takes
a checkpoint of either package (a JAX checkpoint's optax state included).

With ``use_tensorboard`` the run dir gets tensorboardX summaries:
``train/<name>`` scalars per summarised step, ``validation/<name>``
scalars and ``validation/targets_and_predictions_{i}`` image grids
(``num_image_summaries`` images; ``tensorboard_segmentation`` scales class
maps by ``num_classes``). Where tensorboardX cannot be imported the run
logs a warning and trains without summaries, as the JAX CLI does. SIGTERM
(a preemption notice) ends the run after the current epoch with a
checkpoint for the next one and exit status 0 (``utils/preemption.py``).
``-v`` logs at DEBUG with the resolved config and each step's metrics;
``-p`` prints the runner's networks; ``--print-parameters`` their
parameters under the flax names (``utils/diagnostics.py``);
``--profile-dir`` writes a ``torch.profiler`` trace of the training
(``utils/profiling.py``).

Data-parallel runs, one process per card (JAX ``train.py:90``,
``:335-338``, ``:401-424``): ``parallel.distributed.initialize`` starts the
process group from the config's ``distributed`` section, the JAX cluster
environment or torchrun's before the runner is built, e.g.

    torchrun --nproc-per-node 4 -m csmri_refinement_tpu_torch.train CONFIG

or on the CPU, one gloo process per rank with ``--device cpu`` and
``distributed={"coordinator_address": "127.0.0.1:PORT", "num_processes":
2, "process_id": R}``. Both loaders then take the process's slice of
every global batch (``process_shard``; ``batch_size`` stays global), the
runner averages gradients and losses and gathers the validation data, and
only rank 0 writes the run dir, its log file, summaries and checkpoints. A
SIGTERM on any rank stops every rank after the epoch, rank 0 saving once.
The group is destroyed at exit. A config's ``"mesh": {"data": D,
"spatial": S}`` takes D·S processes (``torchrun --nproc-per-node`` D·S);
the S ranks of a spatial group load the same items and each trains on its
image rows (``parallel/halo.py``).
"""

import argparse
import logging
import math
import os
import sys
import time
from itertools import chain

import numpy as np
import torch

from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.parallel import distributed
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.training.early_stopping import EarlyStopper
from csmri_refinement_tpu_torch.utils.checkpoint_paths import (
    get_best_checkpoint_path, get_config_path, get_periodic_checkpoint_path,
    get_run_dir, get_time_string)
from csmri_refinement_tpu_torch.utils import preemption
from csmri_refinement_tpu_torch.utils.checkpoints import (prune_checkpoints,
                                                          restore_checkpoint,
                                                          save_checkpoint)
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.diagnostics import (
    print_model_parameters)
from csmri_refinement_tpu_torch.utils.logging import setup_logging
from csmri_refinement_tpu_torch.utils.profiling import trace

DEFAULT_EPOCHS_PER_CHECKPOINT = 5
DEFAULT_EPOCHS_PER_VALIDATION = 5
DEFAULT_STEPS_PER_TRAIN_SUMMARY = 1
DEFAULT_NUM_WORKERS = 2
DEFAULT_NUM_PERIODIC_CHECKPOINTS = 1
DEFAULT_NUM_BEST_CHECKPOINTS = 3
DEFAULT_USE_TENSORBOARD = False
DEFAULT_NUM_IMAGE_SUMMARIES = 0
DEFAULT_INITIAL_VALIDATION = False
DEFAULT_BEST_VALUE_WARMUP_EPOCHS = 0


def _parser():
  parser = argparse.ArgumentParser(description='Train a model (PyTorch port)')
  parser.add_argument('-v', '--verbose', action='store_true',
                      help='Print more info')
  parser.add_argument('-p', '--print-model', action='store_true',
                      help='Print model informations')
  parser.add_argument('--print-parameters', action='store_true',
                      help='Print parameter information')
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
  parser.add_argument('--profile-dir', default=None,
                      help='Write a torch.profiler trace of training here')
  parser.add_argument('config', help='Config file to use')
  return parser


def _rank_zero():
  """Rank 0 writes (the state is the same on every rank)."""
  return not torch.distributed.is_initialized() or \
      torch.distributed.get_rank() == 0


def _stop_requested(runner):
  """A preemption notice on any rank, so that every rank stops at the same
  epoch."""
  requested = preemption.requested()
  if runner.mesh is None or runner.mesh.group is None:
    return requested
  flag = torch.tensor([float(requested)], device=runner.device)
  mesh_lib.all_reduce(flag, runner.mesh.group, torch.distributed.ReduceOp.MAX)
  return bool(flag.item())


def _save(path, keep, conf, runner, epoch, best_val_metrics):
  if not _rank_zero():
    return
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


def _summary_writer(run_dir):
  """tensorboardX's ``SummaryWriter`` on ``run_dir``; None, with the JAX
  CLI's warning, where tensorboardX cannot be imported."""
  try:
    from tensorboardX import SummaryWriter
  except ImportError:
    logging.warning('tensorboardX not available; disabling summaries')
    return None
  logging.debug('Using tensorboardX summary writer')
  return SummaryWriter(run_dir)


def make_comparison_grid(targets, predictions, num_images, pad=2):
  """Interleave target and prediction images (NHWC, the first channel)
  into one (1, H, W) float32 grid, up to four images per row."""
  images = []
  for idx, (target, prediction) in enumerate(zip(targets, predictions)):
    if idx >= num_images:
      break
    images += [np.asarray(target), np.asarray(prediction)]

  nrow = max(int(math.ceil(len(images) / 4)), 1)
  h, w = images[0].shape[0], images[0].shape[1]
  ncol = int(math.ceil(len(images) / nrow))
  grid = np.zeros((nrow * (h + pad) + pad, ncol * (w + pad) + pad, 1),
                  np.float32)
  for i, img in enumerate(images):
    r, c = divmod(i, ncol)
    y = pad + r * (h + pad)
    x = pad + c * (w + pad)
    grid[y:y + h, x:x + w] = img[..., :1]
  return np.transpose(grid, (2, 0, 1))


def save_images_to_tensorboard(summary_writer, conf, num_image_summaries,
                               global_step, tag, prediction, target):
  """Add a comparison grid of the first ``num_image_summaries`` examples;
  returns how many examples it covers."""
  prediction = np.asarray(prediction)
  target = np.asarray(target)
  if prediction.shape != target.shape:
    logging.warning('Shape of prediction %s differs from target %s while '
                    'saving images', prediction.shape, target.shape)

  num_images = min(target.shape[0], num_image_summaries)
  if target.ndim != 4 or target.shape[-1] not in (1, 3):
    logging.debug('Skipping image summary with shape %s, tag %s',
                  target.shape, tag)
    return num_images

  if conf.get_attr('tensorboard_segmentation', default=False):
    num_classes = conf.get_attr('num_classes', default=None)
    if num_classes is None:
      num_classes = max(2, int(max(prediction.max(), target.max())) + 1)
    prediction = prediction.astype(np.float32) / (num_classes - 1)
    target = target.astype(np.float32) / (num_classes - 1)

  grid = make_comparison_grid(target, prediction, num_images)
  summary_writer.add_image(tag, grid, global_step)
  return num_images


def run_validation(conf, runner, epoch, val_loader, best_val_metrics,
                   chkpt_metric_dirs, summary_writer=None,
                   num_batches_per_epoch=0, early_stoppers=()):
  best_value_warmup = conf.get_attr('best_value_warmup_epochs',
                                    default=DEFAULT_BEST_VALUE_WARMUP_EPOCHS)
  num_image_summaries = conf.get_attr('num_image_summaries',
                                      default=DEFAULT_NUM_IMAGE_SUMMARIES)
  num_batches = int(np.ceil(num_image_summaries / val_loader.batch_size)) \
      if summary_writer is not None else 0
  val_start_time = time.time()
  data, val_losses, val_metrics = runner.validate(
      val_loader, num_batches_to_return=num_batches)
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

  if summary_writer is not None:
    global_step = num_batches_per_epoch * epoch
    for name, metric in chain(val_losses.items(), val_metrics.items()):
      summary_writer.add_scalar('validation/{}'.format(name), metric.value,
                                global_step)
    remaining = num_image_summaries
    for idx, batch in enumerate(data):
      if remaining <= 0:
        break
      named = runner.get_named_outputs(batch)
      remaining -= save_images_to_tensorboard(
          summary_writer, conf, remaining, global_step,
          'validation/targets_and_predictions_{}'.format(idx),
          named['prediction'], named['target'])
  return val_losses, val_metrics


def train_net(conf, runner, train_loader, val_loader, chkpt_metric_dirs=None,
              restore_state=None, summary_writer=None, early_stoppers=(),
              verbose=False):
  chkpt_metric_dirs = chkpt_metric_dirs or {}
  num_batches_per_epoch = len(train_loader)
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
                     chkpt_metric_dirs, summary_writer,
                     num_batches_per_epoch, early_stoppers)
      save_periodic_checkpoint(conf, runner, 0, best_val_metrics)
  else:
    if 'start_epoch' not in restore_state or \
        'best_val_metrics' not in restore_state:
      raise ValueError('Invalid checkpoint for resuming training. Inference '
                       'checkpoint?')
    start_epoch = restore_state['start_epoch']
    best_val_metrics = restore_state['best_val_metrics']

  for epoch in range(start_epoch, conf.num_epochs + 1):
    runner.epoch_beginning(epoch)
    epoch_start_time = time.time()
    train_losses, train_metrics = runner.train_epoch(
        train_loader, epoch, summary_writer, steps_per_summary, verbose)
    epoch_duration = time.time() - epoch_start_time
    runner.epoch_finished(epoch)
    logging.info('===> Epoch %d Complete: %s, time: %.4fs\n%s', epoch,
                 ', '.join('{}: {}'.format(name, loss)
                           for name, loss in train_losses.items()),
                 epoch_duration,
                 '\n'.join('     {}: {}'.format(name, metric)
                           for name, metric in train_metrics.items()))

    if epoch % epochs_per_validation == 0:
      run_validation(conf, runner, epoch, val_loader, best_val_metrics,
                     chkpt_metric_dirs, summary_writer,
                     num_batches_per_epoch, early_stoppers)
    saved_this_epoch = (epoch % epochs_per_checkpoint == 0
                        or epoch == conf.num_epochs)
    if saved_this_epoch:
      save_periodic_checkpoint(conf, runner, epoch + 1, best_val_metrics)

    if _stop_requested(runner):
      logging.info('Preemption: stopping after epoch %d (resume with '
                   '--resume to continue at epoch %d)', epoch, epoch + 1)
      if not saved_this_epoch:
        save_periodic_checkpoint(conf, runner, epoch + 1, best_val_metrics)
      return
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
  started = not torch.distributed.is_initialized()
  device = distributed.initialize(conf, args.device)
  try:
    return _main(args, argv, conf, device)
  finally:
    if started:
      distributed.shutdown()


def _main(args, argv, conf, device):
  writer = _rank_zero()
  dry = args.dry or not writer

  if args.run_dir:
    conf.run_dir = args.run_dir
  elif args.resume and os.path.exists(args.resume):
    conf.run_dir = os.path.dirname(args.resume)
  if not conf.has_attr('run_dir'):
    conf.run_dir = get_run_dir(args.log_dir,
                               conf.get_attr('run_name',
                                             default='unnamed_run'))
  setup_logging(None if dry else conf.run_dir, 'train',
                get_time_string(), verbose=args.verbose)
  logging.info('Commandline arguments: %s', ' '.join(argv))
  if not dry:
    os.makedirs(conf.run_dir, exist_ok=True)
    logging.info('This run is saved to: %s', conf.run_dir)
    conf.serialize(get_config_path(conf.run_dir))
  if args.verbose:
    logging.debug(str(conf))

  runner = build_runner(conf, conf.runner_type, 'train', device)
  if args.print_model and writer:
    print(str(runner))
  restore_state = None
  if args.resume:
    if not os.path.exists(args.resume):
      raise FileNotFoundError('Checkpoint {} to restore from not '
                              'found'.format(args.resume))
    restore_state = restore_checkpoint(args.resume, runner)
    logging.info('Restored checkpoint from %s', args.resume)

  summary_writer = None
  if conf.get_attr('use_tensorboard', default=DEFAULT_USE_TENSORBOARD) and \
      not dry:
    summary_writer = _summary_writer(conf.run_dir)

  num_workers = conf.get_attr('num_data_workers', default=DEFAULT_NUM_WORKERS)
  shard = None if runner.mesh is None else runner.mesh.shard
  train_dataset = load_dataset(
      conf, args.data_dir,
      conf.get_attr('train_dataset', alternative='dataset'), 'train')
  train_loader = DataLoader(
      train_dataset, conf.batch_size, shuffle=True, seed=conf.seed,
      num_workers=num_workers,
      num_samples=conf.get_attr('num_train_subset_samples'),
      process_shard=shard)
  val_dataset = load_dataset(
      conf, args.data_dir,
      conf.get_attr('validation_dataset', alternative='dataset'), 'val')
  val_loader = DataLoader(
      val_dataset,
      conf.get_attr('validation_batch_size', default=conf.batch_size),
      num_workers=num_workers,
      num_samples=conf.get_attr('num_validation_subset_samples'),
      process_shard=shard)

  chkpt_metrics = conf.get_attr(
      'validation_checkpoint_metrics',
      default=conf.get_attr('best_checkpoint_metrics', default=[]))
  chkpt_metric_dirs = {metric: os.path.join(conf.run_dir, 'best_' + metric)
                       for metric in chkpt_metrics}
  if not dry:
    for metric_dir in chkpt_metric_dirs.values():
      os.makedirs(metric_dir, exist_ok=True)

  if args.print_parameters and writer:
    print_model_parameters(runner)
  preemption.install()

  logging.info('Starting training run of %s epochs on %s', conf.num_epochs,
               runner.device)
  try:
    with trace(args.profile_dir if writer else None):
      train_net(conf, runner, train_loader, val_loader, chkpt_metric_dirs,
                restore_state, summary_writer, build_early_stoppers(conf),
                args.verbose)
  except KeyboardInterrupt:
    logging.info('Interrupted')
  finally:
    if summary_writer is not None:
      summary_writer.close()
  return runner


if __name__ == '__main__':
  main(sys.argv[1:])
