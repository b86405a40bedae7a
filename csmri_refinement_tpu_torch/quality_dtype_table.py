"""Quality against compute dtype for the flagship forward.

Counterpart of ``scripts/quality_dtype_table.py``: synthetic phantoms go
through the varden-8× undersampling and the flagship RecNet + refinement
forward (``build_flagship``) in each mode, with the same f32 weights, and the
table gives PSNR and SSIM of the reconstruction magnitudes (clipped to
[0, 1]) against the ground truth:

    f32   the reference semantics
    bf16  the default serving dtype (every eval chain through the conv
          kernel: the JAX script's ``bf16+fused`` row is the same here)
    int8  the opt-in quantized U-Net serving mode (``ops/quantize.py``),
          outside the 0.1 dB default budget; labelled
          ``[bf16 VMEM-fallback]`` where a chain quantized no layer

    python -m csmri_refinement_tpu_torch.quality_dtype_table \
        [--sizes 256 512] [--batch 8] [--device cuda|cpu] \
        [--refinement-scale S] [--checkpoint CKPT [--model-key KEY]]

Prints one markdown table. Weights are the seeded random init, or with
``--checkpoint`` the network ``--model-key`` (default ``generator``) of a
checkpoint of either package, read by
``utils/checkpoints.py::load_model_state_dict`` (it must have the flagship's
architecture). The random init sets the wrapper's ``scale`` to 0, so the
U-Net (the only part that int8 changes) does not reach the output and the
int8 row equals the bf16 row; ``--refinement-scale`` (default 0.5 without
a checkpoint, the checkpoint's own scale with one) sets the scale so that
it does. ``--refinement-scale 0`` keeps the init.
"""

import argparse

import numpy as np
import torch

from csmri_refinement_tpu_torch.data.datasets import _make_phantoms
from csmri_refinement_tpu_torch.flagship import build_flagship
from csmri_refinement_tpu_torch.ops import quantize
from csmri_refinement_tpu_torch.ops.ssim import ssim
from csmri_refinement_tpu_torch.utils.checkpoints import (
    load_model_state_dict, load_network_state)

MODES = (('f32', torch.float32, False), ('bf16', torch.bfloat16, False),
         ('int8', torch.bfloat16, True))


def _scores(pred, target):
  """(PSNR dB, SSIM) of the magnitude of packed-complex ``pred``."""
  pred = pred.float()
  mag = torch.sqrt(pred[..., 0] ** 2 + pred[..., 1] ** 2).clamp(0.0, 1.0)
  mse = torch.mean((mag - target) ** 2)
  psnr = 10.0 * torch.log10(1.0 / mse)
  return psnr.item(), ssim(mag[..., None], target[..., None]).item()


def table(sizes=(256, 512), batch=8, device='cuda', refinement_scale=None,
          state=None):
  """Rows ``(size, label, psnr, dpsnr, ssim, dssim)``, deltas against the
  f32 row of the same size; masks from seed 0, weights from seed 0 or
  the network ``state`` (a port state dict or a flax tree)."""
  device = torch.device(device)
  rows = []
  for size in sizes:
    phantoms, _ = _make_phantoms(batch, size, seed=123)
    target = torch.from_numpy(np.stack(phantoms)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    base = None
    for name, dtype, quantized in MODES:
      model, undersample_batch = build_flagship(
          size, dtype, device, 0, quantize_inference=quantized)
      if state is not None:
        load_network_state(model, state)
      if refinement_scale is not None:
        with torch.no_grad():
          model.scale.fill_(refinement_scale)
      if base is None:
        data = undersample_batch(gen, target, 'varden', 8)
      quantize.reset_trace_log()
      with torch.inference_mode():
        out = model(data['inp'], data['kspace'], data['mask'])
      psnr, s = _scores(out['pred'], target)
      if base is None:
        base = (psnr, s)
      label = name
      if quantized and quantize.fell_back_to_bf16():
        label += ' [bf16 VMEM-fallback]'
      rows.append((size, label, psnr, psnr - base[0], s, s - base[1]))
  return rows


def print_table(rows):
  print('| size | mode | PSNR (dB) | dPSNR | SSIM | dSSIM |')
  print('|---|---|---|---|---|---|')
  for size, label, p, dp, s, ds in rows:
    print('| {} | {} | {:.4f} | {:+.4f} | {:.4f} | {:+.4f} |'.format(
        size, label, p, dp, s, ds), flush=True)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--sizes', type=int, nargs='*', default=[256, 512])
  parser.add_argument('--batch', type=int, default=8)
  parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
  parser.add_argument('--refinement-scale', type=float, default=None,
                      help='the wrapper\'s scale (default 0.5 without a '
                      'checkpoint: 0 at the random init, where the U-Net '
                      'does not reach the output)')
  parser.add_argument('--checkpoint', default=None,
                      help='trained checkpoint of either package; its '
                      'network replaces the random init')
  parser.add_argument('--model-key', default='generator')
  args = parser.parse_args(argv)
  if args.device == 'cuda':
    torch.backends.cudnn.allow_tf32 = False    # f32 means f32
    torch.backends.cuda.matmul.allow_tf32 = False
  state, scale = None, args.refinement_scale
  if args.checkpoint:
    state = load_model_state_dict(args.checkpoint, args.model_key)
  elif scale is None:
    scale = 0.5
  rows = table(args.sizes, args.batch, args.device, scale, state)
  print_table(rows)
  return rows


if __name__ == '__main__':
  main()
