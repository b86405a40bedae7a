"""Offline evaluation of saved reconstructions, the port's CLI.

    python -m csmri_refinement_tpu_torch.eval_results INPUT_DIR
        [--fold val|test] [--src-path DIR] [--results-path DIR]
        [--segscore-conf CONF] [--data-format default|jo] [--pred-key KEY]
        [--device cuda|cpu]

Counterpart of the JAX package's ``eval_results.py``: reads the ``.mat``
records the validate CLI writes with ``--raw`` (or "jo"-format volumes)
and the ScarSeg labels of the fold's cases under ``--src-path``, and
computes each slice's PSNR, SSIM and, with ``--segscore-conf`` (a config
with a ``segmentation_score_metric`` section), its segmentation score.
Prints each metric's mean and standard deviation and writes
``scarseg_<input dir>.csv`` (header ``,psnr,name,ssim[,segscore]``, one
row per slice keyed ``<case>_<slice:02d>``, the slices in case and slice
order, an empty cell where the score skipped a slice) and
``scarseg_<input dir>.txt`` into ``--results-path``, with the stdlib
``csv`` module (no pandas). Where the JAX CLI's ``name`` column comes out
empty (its pandas join matches the case names on a range index), this one
holds each slice's case. The segmentation network runs on the card unless
``--device cpu`` is given.
"""

import argparse
import csv
import os
import sys
from functools import partial

import numpy as np
import torch

from csmri_refinement_tpu_torch.data.io_mat import CASE_KEY
from csmri_refinement_tpu_torch.data.results_io import (add_gt_labels,
                                                        load_results_dataset)
from csmri_refinement_tpu_torch.data.statistics import (compute_psnr,
                                                        compute_seg_score,
                                                        compute_ssim)
from csmri_refinement_tpu_torch.utils.config import Configuration


def _parser():
  parser = argparse.ArgumentParser(
      description='Offline eval of saved reconstruction results (PyTorch '
                  'port)')
  parser.add_argument('--fold', choices=['val', 'test'], default='val')
  parser.add_argument('--src-path',
                      default='resources/data/scar_segmentation',
                      help='Path to the ScarSeg dataset (for GT labels)')
  parser.add_argument('--results-path', default='.',
                      help='Where to write csv/txt outputs')
  parser.add_argument('--segscore-conf',
                      help='JSON config with segmentation_score_metric entry')
  parser.add_argument('--data-format', default='default',
                      choices=['default', 'jo'])
  parser.add_argument('--pred-key', default=None,
                      help='Prediction key for jo-format inputs')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help='Device of the segmentation network (default: '
                           'the card)')
  parser.add_argument('input', help='Directory of saved .mat results')
  return parser


def get_seg_score_obj(segscore_conf_path):
  from csmri_refinement_tpu_torch.metrics.segmentation_score import (
      SegmentationScore)
  conf = Configuration.from_json(segscore_conf_path)
  metric_conf = conf.segmentation_score_metric
  return SegmentationScore(
      metric_conf['model'], conf.file, class_idx=metric_conf.get('class', 1),
      skip_empty_images=metric_conf.get('skip_empty_images', False))


def main(argv):
  """Run the CLI on ``argv``; returns (the CSV's path, {metric id:
  OrderedDict of per-slice values})."""
  args = _parser().parse_args(argv)
  if args.segscore_conf and args.device == 'cuda' and \
      not torch.cuda.is_available():
    raise RuntimeError('no CUDA device; pass --device cpu to run the '
                       'segmentation network on the CPU')
  dataset = load_results_dataset(args.input, data_format=args.data_format,
                                 pred_key=args.pred_key)
  dataset = list(add_gt_labels(dataset, args.src_path, args.fold)
                 .slice_iter())

  metrics = [('PSNR', 'psnr', compute_psnr), ('SSIM', 'ssim', compute_ssim)]
  if args.segscore_conf:
    metrics.append(('SegScore', 'segscore', partial(
        compute_seg_score, seg_score=get_seg_score_obj(args.segscore_conf),
        device=args.device)))

  out_str = ''
  values = {}
  for name, metric_id, metric_fn in metrics:
    values[metric_id] = metric_fn(dataset)
    column = list(values[metric_id].values())
    s = '{}:\n{:.4f} +- {:.4f}\n'.format(name, np.mean(column),
                                         np.std(column))
    print(s)
    out_str += s + '\n'

  # The first metric's rows, with the slice's case and every other metric
  # beside them (the JAX CLI's left join).
  ids = [metric_id for _, metric_id, _ in metrics]
  header = ['', ids[0], 'name'] + ids[1:]
  cases = [data[CASE_KEY] for data in dataset]
  base = os.path.basename(os.path.normpath(args.input))
  csv_path = os.path.join(args.results_path, 'scarseg_{}.csv'.format(base))
  with open(csv_path, 'w', newline='') as f:
    writer = csv.writer(f, lineterminator='\n')
    writer.writerow(header)
    for key, case in zip(values[ids[0]], cases):
      row = [key, repr(float(values[ids[0]][key])), case]
      row += [repr(float(values[i][key])) if key in values[i] else ''
              for i in ids[1:]]
      writer.writerow(row)
  with open(os.path.join(args.results_path,
                         'scarseg_{}.txt'.format(base)), 'w') as f:
    f.write(out_str)
  return csv_path, values


if __name__ == '__main__':
  main(sys.argv[1:])
