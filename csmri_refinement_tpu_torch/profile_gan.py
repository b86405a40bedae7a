"""Where a GAN refinement step's device time goes, by kernel.

    python -m csmri_refinement_tpu_torch.profile_gan [--tf32] [--size N]
                                                      [--train-dtype bfloat16]

Builds the port's ``AdversarialRunner`` on the card from
``configs/2-refinement.json`` at its full widths (RecNet 3×3×32 frozen,
U-Net [32, 64, 128]/[64, 32] k4, discriminator [64 ... 1024], VGG19 to
block 4, B = 5), on Synthetic phantoms (``synthetic_refinement_conf``:
there is no ScarSeg data in the repository) with the VGG19 from its seeded
random init (no ImageNet weights file is in the repository either) and the
RecNet from its seeded init; warms up, then traces a few train steps on
one prepared batch with ``torch.profiler`` (CPU + CUDA activities) and
prints the card's name and power limit, the wall time per step, the summed
device time of every kernel, the device's idle share over the window and
the kernels with the most device time. TF32 is off unless ``--tf32``.
``--size`` sets the phantoms' side (256 by default; the paper's slices are
512²), ``--train-dtype`` the run's ``train_dtype``. Needs a CUDA device.
"""

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'configs', '2-refinement.json')
BATCH = 5
WARMUP, STEPS = 3, 5


def synthetic_refinement_conf(size, num_train, num_val, batch_size,
                              pretrained_weights=None, dropout=True,
                              narrow=False):
  """``configs/2-refinement.json`` as a dict, on Synthetic phantoms of side
  ``size``, with the VGG19's seeded random init and the given RecNet
  ``pretrained_weights`` ([path, key], or None for its seeded init);
  ``dropout=False`` empties the discriminator's ``dropout_after``;
  ``narrow=True`` cuts the widths for checks at small sides (RecNet 8
  filters, U-Net [8, 16, 16]/[16, 8], discriminator [8, 16, 16] at
  strides [2, 2, 1], whose 4×4 head fits a side of 32)."""
  with open(CONFIG) as f:
    conf = json.load(f)
  conf.update(
      train_dataset='Synthetic', validation_dataset='Synthetic',
      synthetic={'image_size': size, 'num_train': num_train,
                 'num_val': num_val},
      batch_size=batch_size, validation_batch_size=batch_size,
      vgg_random_init=True, num_epochs=1)
  conf['generator_model']['pretrained_model']['pretrained_weights'] = \
      pretrained_weights
  if not dropout:
    conf['discriminator_model']['dropout_after'] = []
  if narrow:
    gen = conf['generator_model']
    gen['pretrained_model']['num_filters'] = 8
    gen['learnable_model'].update(encode_filters=[8, 16, 16],
                                  decode_filters=[16, 8])
    conf['discriminator_model'].update(num_filters_per_layer=[8, 16, 16],
                                       strides=[2, 2, 1])
  return conf


def main(argv=None):
  from csmri_refinement_tpu_torch.profile_flagship import card_line, report
  from csmri_refinement_tpu_torch.training.adversarial_runner import (
      AdversarialRunner)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--tf32', action='store_true',
                      help='let cuDNN run the f32 convs in TF32')
  parser.add_argument('--size', type=int, default=256,
                      help='side of the phantoms')
  parser.add_argument('--train-dtype', choices=('bfloat16',),
                      help='the run\'s train_dtype')
  args = parser.parse_args(argv)
  torch.backends.cudnn.allow_tf32 = args.tf32
  torch.backends.cuda.matmul.allow_tf32 = args.tf32

  card = card_line()
  conf_d = synthetic_refinement_conf(args.size, 8 * BATCH, 2 * BATCH, BATCH)
  if args.train_dtype:
    conf_d['train_dtype'] = args.train_dtype
  conf = Configuration.from_dict(conf_d)
  runner = AdversarialRunner(conf, 'train', 'cuda')
  gen = torch.Generator(device='cuda').manual_seed(0)
  gt = torch.rand(BATCH, args.size, args.size, device='cuda', generator=gen)
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
  report(prof, wall_ms, STEPS, 'GAN refinement step {}^2 {} B{} TF32 {}'
         .format(args.size, args.train_dtype or 'f32', BATCH,
                 'on' if args.tf32 else 'off'), 'step')


if __name__ == '__main__':
  main()
