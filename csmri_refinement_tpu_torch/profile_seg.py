"""Where a segmentation U-Net train step's (or eval forward's) device time
goes, by kernel.

    python -m csmri_refinement_tpu_torch.profile_seg [--tf32] [--forward]
        [--size N] [--train-dtype bfloat16]

Builds the port's standard ``Runner`` on the card from
``configs/3-train-segmentation-unet.json`` at its full widths (U-Net
[32, 64, 128, 256, 512]/[256, 128, 64, 32], 2 layers per scale, k3, BN,
reflection, ``pixelshuffle``, CrossEntropy, Adam 2e-4, B = 8) on Synthetic
256² phantoms (``synthetic_segmentation_conf``: there is no ScarSeg data in
the repository), warms up, then traces a few train steps on one batch with
``torch.profiler`` (CPU + CUDA activities) and prints the card's name and
power limit, the wall time per step, the summed device time of every
kernel, the device's idle share over the window and the kernels with the
most device time. ``--forward`` traces the eval-mode forward instead (the
validation forward and the segmentation score's, whose conv chains run the
conv-chain kernel's f32 route), in full f32. TF32 is off unless ``--tf32``
(train steps only). ``--size`` sets the phantoms' side (256 by default;
the paper's slices are 512²), ``--train-dtype`` the run's ``train_dtype``
(the model built in mode 'train' computes in it, its eval forward too,
whose chains then take the kernel's bf16 route). Needs a CUDA device.
"""

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'configs', '3-train-segmentation-unet.json')
WARMUP, STEPS = 3, 5
NARROW = {'encode_filters': [8, 16, 32], 'decode_filters': [16, 8]}


def synthetic_segmentation_conf(size, num_train, num_val, batch_size=8,
                                narrow=False):
  """``configs/3-train-segmentation-unet.json`` as a dict, on Synthetic
  phantoms of side ``size``, one epoch; ``narrow=True`` cuts the U-Net to
  encoders [8, 16, 32] and decoders [16, 8] for checks at small sides."""
  with open(CONFIG) as f:
    conf = json.load(f)
  conf.update(
      train_dataset='Synthetic', validation_dataset='Synthetic',
      synthetic={'image_size': size, 'num_train': num_train,
                 'num_val': num_val},
      batch_size=batch_size, num_epochs=1)
  if narrow:
    conf['model'].update(NARROW)
  return conf


def main(argv=None):
  from csmri_refinement_tpu_torch.profile_flagship import card_line, report
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  from csmri_refinement_tpu_torch.utils.precision import full_f32
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--tf32', action='store_true',
                      help='let cuDNN run the train step\'s f32 convs in '
                      'TF32')
  parser.add_argument('--forward', action='store_true',
                      help='trace the eval-mode forward, not a train step')
  parser.add_argument('--size', type=int, default=256,
                      help='side of the phantoms')
  parser.add_argument('--train-dtype', choices=('bfloat16',),
                      help='the run\'s train_dtype')
  args = parser.parse_args(argv)
  size, dtype = args.size, args.train_dtype or 'f32'
  torch.backends.cudnn.allow_tf32 = args.tf32
  torch.backends.cuda.matmul.allow_tf32 = args.tf32

  card = card_line()
  conf_d = synthetic_segmentation_conf(size, 8, 8)
  if args.train_dtype:
    conf_d['train_dtype'] = args.train_dtype
  conf = Configuration.from_dict(conf_d)
  runner = Runner(conf, 'train', 'cuda')
  gen = torch.Generator().manual_seed(0)
  batch = runner.preparer.prepare_train(None, {
      'inp': torch.rand(conf.batch_size, size, size, 2, generator=gen),
      'target': torch.randint(0, 2, (conf.batch_size, size, size),
                              generator=gen)})
  if args.forward:
    runner.model.eval()

    def step():
      with torch.no_grad(), full_f32():
        runner.model(batch['inp'])
    label = 'segmentation U-Net eval forward {}^2 {} B{}'.format(
        size, dtype, conf.batch_size)
  else:
    def step():
      runner.train_batch(batch)
    label = 'segmentation train step {}^2 {} B{} TF32 {}'.format(
        size, dtype, conf.batch_size, 'on' if args.tf32 else 'off')
  for _ in range(WARMUP):
    step()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(STEPS):
      step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  print(card)
  report(prof, wall_ms, STEPS, label, 'forward' if args.forward else 'step')


if __name__ == '__main__':
  main()
