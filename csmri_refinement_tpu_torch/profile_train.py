"""Where a RecNet train step's device time goes, by kernel.

    python -m csmri_refinement_tpu_torch.profile_train [--tf32] [--size N]
                                                        [--train-dtype bfloat16]

Builds the port's standard ``Runner`` from ``configs/synthetic-recnet.json``
on the card (RecNet 3 blocks × 3 convs × 32 filters, f32, 256², B = 16,
varden 8×, MSE, Adam), warms up, then traces a few train steps on one
prepared batch with ``torch.profiler`` (CPU + CUDA activities) and prints:
the card's name and power limit, the wall time per step, the summed device
time of every kernel, the device's idle share over the window, and the
kernels with the most device time. TF32 is off unless ``--tf32``.
``--size`` sets the side (the config's 256 by default; the paper's slices
are 512²), ``--train-dtype`` the run's ``train_dtype``. Needs a CUDA
device.
"""

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from csmri_refinement_tpu_torch.profile_flagship import card_line, report
from csmri_refinement_tpu_torch.training.runner import Runner
from csmri_refinement_tpu_torch.utils.config import Configuration

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'configs', 'synthetic-recnet.json')
WARMUP, STEPS = 3, 5


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--tf32', action='store_true',
                      help='let cuDNN run the f32 convs in TF32')
  parser.add_argument('--size', type=int, help='side of the slices')
  parser.add_argument('--train-dtype', choices=('bfloat16',),
                      help='the run\'s train_dtype')
  args = parser.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = args.tf32
  torch.backends.cuda.matmul.allow_tf32 = False

  card = card_line()
  conf = Configuration.from_json(CONFIG)
  if args.train_dtype:
    conf.train_dtype = args.train_dtype
  runner = Runner(conf, 'train', 'cuda')
  size = args.size or conf.synthetic['image_size']
  gen = torch.Generator(device='cuda').manual_seed(0)
  gt = torch.rand(conf.batch_size, size, size, device='cuda', generator=gen)
  batch = runner.preparer.prepare_train(gen, {'gt': gt})
  for _ in range(WARMUP):
    runner.train_batch(batch)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(STEPS):
      runner.train_batch(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  print(card)
  report(prof, wall_ms, STEPS, 'RecNet train step {}^2 {} B{} TF32 {}'.format(
      size, args.train_dtype or 'f32', conf.batch_size,
      'on' if args.tf32 else 'off'), 'step')


if __name__ == '__main__':
  main()
