"""Validation and inference CLI of the port.

    python -m csmri_refinement_tpu_torch.validate CONFIG CHECKPOINT
        [DATASETS ...] [--data-dir DIR] [-f train|val|test] [-b N] [-i] [-d]
        [--raw] [--dry] [--out-dir DIR] [--conf key=value ...] [-v]
        [--device cuda|cpu]

Counterpart of the JAX package's ``validate.py``: restores CHECKPOINT (a
checkpoint of either package; ``NONE`` keeps the seeded init) into the
config's runner in test mode, then for each dataset (default: the config's
``validation_dataset``) runs the validation loop and logs the averaged
metrics, or with ``--raw`` the inference loop. ``-i`` writes each
prediction as an 8-bit grayscale PNG of its clipped magnitude, ``-d`` also
the input and the target, ``--raw`` one ``.mat`` record per slice of the
unprocessed input, prediction and target (the output transform off, so
``-b 1``), into a timestamped ``<out-dir>/<dataset>_<config>_<time>``.
The log goes beside the checkpoint unless ``--dry``. It runs on the card
unless ``--device cpu`` is given; with no card and no ``--device cpu`` it
raises. PNGs are written with ``zlib`` and ``struct`` (no PIL).

Under torchrun or a config's ``distributed`` section it starts the process
group as the training CLI does: each rank evaluates its part of every
batch (its batch rows, and its image rows under the ``mesh`` section's
``spatial`` axis), the metrics and outputs are gathered to every rank,
and only rank 0 writes.
"""

import argparse
import logging
import os
import struct
import sys
import zlib

import numpy as np
import torch

from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.data.datasets import is_dataset
from csmri_refinement_tpu_torch.data.io_mat import save_raw
from csmri_refinement_tpu_torch.parallel import distributed
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.utils.checkpoint_paths import get_run_dir
from csmri_refinement_tpu_torch.utils.checkpoints import restore_checkpoint
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.logging import setup_logging

DEFAULT_NUM_WORKERS = 1


def _parser():
  parser = argparse.ArgumentParser(
      description='Validate a model and infer predictions (PyTorch port)')
  parser.add_argument('-v', '--verbose', action='store_true',
                      help='Print more info')
  parser.add_argument('--dry', action='store_true',
                      help='Do not create output directories')
  parser.add_argument('--data-dir', default='resources/data',
                      help='Path to data directory')
  parser.add_argument('--out-dir', default='resources/outputs',
                      help='Path to where to save outputs')
  parser.add_argument('-i', '--infer', action='store_true',
                      help='Save predicted images')
  parser.add_argument('-d', '--dump', action='store_true',
                      help='Save input, target and predicted images')
  parser.add_argument('--raw', action='store_true',
                      help='Save network outputs in matrix format')
  parser.add_argument('-f', '--fold', choices=['train', 'val', 'test'],
                      default='val', help='Fold of dataset to use')
  parser.add_argument('--conf', nargs='+',
                      help='Optional config values to set (key=value)')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help='Device to run on (default: the card)')
  parser.add_argument('-b', '--batch-size', type=int, default=1,
                      help='Evaluation batch size (masks are drawn per '
                           'slice index, so any batch size gives the same '
                           'results)')
  parser.add_argument('config', help='Config file to use')
  parser.add_argument('checkpoint', help='Checkpoint to use weights from')
  parser.add_argument('files_or_dirs', nargs='*',
                      help='Datasets to evaluate')
  return parser


def write_png(path, image):
  """Write a (H, W) uint8 array as an 8-bit grayscale PNG."""
  image = np.ascontiguousarray(image, np.uint8)
  height, width = image.shape

  def chunk(kind, data):
    body = kind + data
    return struct.pack('>I', len(data)) + body + \
        struct.pack('>I', zlib.crc32(body) & 0xffffffff)

  rows = np.concatenate([np.zeros((height, 1), np.uint8), image], axis=1)
  with open(path, 'wb') as f:
    f.write(b'\x89PNG\r\n\x1a\n')
    f.write(chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, 0, 0,
                                       0, 0)))
    f.write(chunk(b'IDAT', zlib.compress(rows.tobytes())))
    f.write(chunk(b'IEND', b''))


def _save_image(image, path):
  """The clipped magnitude of a (H, W[, 1|2]) image as a PNG, scaled to
  0-255 and truncated, as the JAX package's ``_save_image`` computes it."""
  image = np.asarray(image)
  if image.ndim == 3 and image.shape[-1] == 2:
    image = np.sqrt(image[..., 0] ** 2 + image[..., 1] ** 2)
  image = np.clip(np.squeeze(image), 0.0, 1.0)
  write_png(path, (image * 255).astype(np.uint8))


def save_output_images(dataset, inputs, predictions, targets, output_dir,
                       filenames, dump, raw):
  for idx, name in enumerate(filenames):
    if raw:
      save_raw(os.path.join(output_dir, '{}.mat'.format(name)), name,
               inputs, predictions, targets, dataset)
      continue
    if dump:
      _save_image(inputs[idx],
                  os.path.join(output_dir, '{}_input.png'.format(name)))
      _save_image(targets[idx],
                  os.path.join(output_dir, '{}_target.png'.format(name)))
    _save_image(predictions[idx],
                os.path.join(output_dir, '{}_pred.png'.format(name)))
    logging.debug('Wrote images for %s', name)


def _numpy(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main(argv):
  """Run the CLI on ``argv``; returns {dataset name: {'metrics': {name:
  value} (None with --raw), 'output_dir': path or None}}."""
  args = _parser().parse_args(argv)
  if args.device == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device; pass --device cpu to validate on the '
                       'CPU with the plain versions')
  if args.raw and args.batch_size != 1:
    raise ValueError('--raw writes one slice per record: use -b 1')
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
  rank_zero = not torch.distributed.is_initialized() or \
      torch.distributed.get_rank() == 0
  dry = args.dry or not rank_zero
  setup_logging(None if dry else os.path.dirname(args.checkpoint),
                'eval', verbose=args.verbose)
  logging.info('Commandline arguments: %s', ' '.join(argv))
  if args.verbose:
    logging.debug(str(conf.to_dict()))
  if args.raw:
    # Raw matrices: no output transform
    conf.application = 'none'

  runner = build_runner(conf, conf.runner_type, 'test', device)
  if args.checkpoint != 'NONE':
    if not os.path.exists(args.checkpoint):
      raise FileNotFoundError('Checkpoint {} to restore from not '
                              'found'.format(args.checkpoint))
    restore_checkpoint(args.checkpoint, runner)
    logging.info('Restored checkpoint from %s', args.checkpoint)

  names = args.files_or_dirs or [conf.validation_dataset]
  datasets = [load_dataset(conf, args.data_dir, name, args.fold)
              for name in names if is_dataset(name)]
  num_samples = conf.get_attr('num_validation_subset_samples')
  write = not dry and (args.infer or args.dump or args.raw)
  results = {}
  for dataset in datasets:
    logging.info('Evaluating dataset %s', dataset.name)
    loader = DataLoader(dataset, args.batch_size,
                        num_workers=DEFAULT_NUM_WORKERS,
                        num_samples=num_samples,
                        process_shard=None if runner.mesh is None else
                        runner.mesh.shard)
    metrics = None
    if args.raw:
      data = runner.infer(loader)
    else:
      data, _, val_metrics = runner.validate(loader,
                                             len(loader) if write else 0)
      metrics = {name: metric.value for name, metric in val_metrics.items()}
      logging.info('Average metrics for %s\n%s', dataset.name, ''.join(
          '     {}: {}\n'.format(name, metric)
          for name, metric in val_metrics.items()))
    results[dataset.name] = {'metrics': metrics, 'output_dir': None}
    if not write:
      continue

    conf_name = os.path.splitext(os.path.basename(conf.file or 'conf'))[0]
    output_dir = get_run_dir(args.out_dir,
                             '{}_{}'.format(dataset.name, conf_name))
    os.makedirs(output_dir, exist_ok=True)
    logging.info('Writing outputs to %s', output_dir)
    file_idx = 0
    for batch in data:
      named = runner.get_named_outputs(batch)
      inputs, predictions, targets = (
          _numpy(named[k]) for k in ('input', 'prediction', 'target'))
      batch_size = predictions.shape[0]
      filenames = [dataset.get_filename(idx)
                   for idx in range(file_idx, file_idx + batch_size)]
      save_output_images(dataset, inputs, predictions, targets, output_dir,
                         filenames, args.dump, args.raw)
      file_idx += batch_size
    results[dataset.name]['output_dir'] = output_dir
    logging.info('Finished writing outputs for dataset %s', dataset.name)
  return results


if __name__ == '__main__':
  main(sys.argv[1:])
