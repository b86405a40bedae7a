"""Export a checkpoint as a one-file serving artifact (the port's CLI).

    python -m csmri_refinement_tpu_torch.export_model CONFIG CHECKPOINT OUTPUT
        [-b N] [-f train|val|test] [--data-dir DIR] [--platforms cpu,cuda]
        [--device cuda|cpu] [--verify] [--conf key=value ...] [-v]

Counterpart of the JAX package's ``export_model.py``, with its flags: one
step past ``deploy_checkpoint`` in the deployment funnel, it freezes the
restored inference network (weights and forward graph, ``torch.export``)
into OUTPUT (``utils/export.py``), which replays without the model code on
the CPU or on the card through the kernels' custom ops. CHECKPOINT is a
checkpoint of either package, or ``NONE`` for the seeded init. The batch
of ``-b`` slices from fold ``-f`` of the config's validation dataset fixes
the artifact's static shapes. It traces on the card unless ``--device cpu``
(``--platform`` is the same flag under the JAX CLI's name); the artifact
lists ``--platforms`` and replays on both. ``--verify`` replays the written
file against ``runner.predict`` on that batch and fails above 1e-3, as
the JAX CLI does.
"""

import argparse
import logging
import os
import sys

import torch

from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.utils.checkpoints import restore_checkpoint
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.export import (export_predict,
                                                     save_artifact,
                                                     verify_artifact)
from csmri_refinement_tpu_torch.utils.logging import setup_logging

VERIFY_ATOL = 1e-3


def _parser():
  parser = argparse.ArgumentParser(
      description='Export a checkpoint as a serving artifact (PyTorch port)')
  parser.add_argument('-v', '--verbose', action='store_true',
                      help='Print more info')
  parser.add_argument('--data-dir', default='resources/data',
                      help='Path to data directory (shape source)')
  parser.add_argument('-f', '--fold', choices=['train', 'val', 'test'],
                      default='val', help='Fold supplying the example batch')
  parser.add_argument('-b', '--batch-size', type=int, default=1,
                      help='Serving batch size baked into the artifact')
  parser.add_argument('--platforms', default='cpu,cuda',
                      help='Comma-separated platforms the artifact lists')
  parser.add_argument('--device', '--platform', dest='device',
                      default='cuda', choices=['cuda', 'cpu'],
                      help='Device to trace and verify on (default: the '
                           'card)')
  parser.add_argument('--verify', action='store_true',
                      help='Replay the written artifact against '
                           'runner.predict and fail on mismatch > 1e-3')
  parser.add_argument('--conf', nargs='+',
                      help='Optional config values to set')
  parser.add_argument('config', help='Config file to use')
  parser.add_argument('checkpoint',
                      help="Checkpoint to export ('NONE' for fresh init)")
  parser.add_argument('output', help='Artifact file to write')
  return parser


def main(argv):
  args = _parser().parse_args(argv)
  if args.device == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device; pass --device cpu to export on the '
                       'CPU with the plain versions')
  setup_logging(None, 'export', verbose=args.verbose)
  logging.info('Commandline arguments: %s', ' '.join(argv))

  conf = Configuration.from_json(args.config)
  if args.conf:
    conf.update(dict(arg.split('=', 1) for arg in args.conf))

  runner = build_runner(conf, conf.runner_type, 'test', args.device)
  if args.checkpoint != 'NONE':
    if not os.path.exists(args.checkpoint):
      logging.critical('Checkpoint %s to export not found', args.checkpoint)
      return 1
    restore_checkpoint(args.checkpoint, runner)
    logging.info('Restored checkpoint from %s', args.checkpoint)

  dataset = load_dataset(conf, args.data_dir, conf.validation_dataset,
                         args.fold)
  loader = DataLoader(dataset, batch_size=args.batch_size, num_workers=1,
                      shuffle=False)
  host_batch = next(iter(loader))

  platforms = tuple(p.strip() for p in args.platforms.split(',') if p.strip())
  exported, header = export_predict(runner, host_batch, platforms)
  save_artifact(args.output, exported, header, extra_meta={
      'config': os.path.basename(args.config),
      'checkpoint': os.path.basename(args.checkpoint),
      'runner_type': conf.runner_type,
  })
  size = os.path.getsize(args.output)
  print('Wrote serving artifact to {} ({:.1f} KiB, platforms {}, inputs '
        '{})'.format(args.output, size / 1024.0, header['platforms'],
                     header['input_shapes']))

  if args.verify:
    diff = verify_artifact(args.output, runner, host_batch)
    print('Verify: max |artifact - runner.predict| = {:.3g}'.format(diff))
    if not diff < VERIFY_ATOL:
      logging.critical('Artifact verification FAILED (diff %g)', diff)
      return 1
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]) or 0)
