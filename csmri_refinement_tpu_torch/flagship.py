"""The flagship serving forward: RecNet cascade + refinement U-Net.

Counterpart of ``bench.py:build_forward`` with ``fused_conv=True`` and of
``__graft_entry__.py:_flagship_model``: a frozen RecNet (3 blocks × 3 convs ×
32 filters, zero padding) with data consistency after each block, then the
refinement U-Net (encoders [32, 64, 128], decoders [64, 32], k4, reflection
padding, ``nn-resize-conv``, one output channel) in a ``real-penalty-add``
``RefinementWrapper`` fed the RecNet output. In eval mode every DC runs the
DC kernel and every U-Net conv chain the conv-chain kernel on the card.

With ``quantize_inference=True`` it is the counterpart of
``bench.py:build_forward(size, 'int8')``: the opt-in int8 serving mode, in
which each U-Net chain's quantized suffix (``ops/quantize.py``) runs the int8
conv kernel and its prefix the conv-chain kernel in the compute dtype. The
mode sits outside the 0.1 dB default quality budget.
"""

import torch

from csmri_refinement_tpu_torch.models.recnet import RecNet
from csmri_refinement_tpu_torch.models.refinement_wrapper import (
    RefinementWrapper)
from csmri_refinement_tpu_torch.models.unet import UNET
from csmri_refinement_tpu_torch.ops.undersample import undersample_batch


def flagship_model(dtype=None, quantize_inference=False):
  """The flagship wrapper at its published widths, weights uninitialised;
  ``quantize_inference`` selects the U-Net's int8 serving mode."""
  pretrained = RecNet(num_blocks=3, num_convs=3, num_filters=32, dtype=dtype)
  learnable = UNET(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
                   encode_filters=[32, 64, 128], decode_filters=[64, 32],
                   kernel_size=4, upsampling_mode='nn-resize-conv',
                   output_activation='none', padding='reflection',
                   decoder_act_upsampling_only=True,
                   quantize_inference=quantize_inference, dtype=dtype)
  return RefinementWrapper(pretrained, learnable, mode='real-penalty-add',
                           input_mode='output')


def build_flagship(image_size=256, dtype=torch.bfloat16, device='cuda',
                   seed=0, quantize_inference=False):
  """(model, undersample_batch) for the flagship serving forward.

  The model is in eval mode on ``device`` with weights drawn from ``seed``
  (f32 parameters; ``dtype`` is the compute dtype, the DC always runs in
  f32). Call it as ``model(batch['inp'], batch['kspace'], batch['mask'])``
  on a batch from ``undersample_batch(generator, gt, 'varden', 8)``. With
  ``device='cuda'`` and no card it raises. ``quantize_inference=True`` is
  the int8 serving mode (``dtype`` stays the compute dtype of everything
  outside the quantized layers: bf16 for ``bench.py --dtype int8``); the
  weights drawn from ``seed`` are the same as without it.
  """
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('build_flagship: no CUDA device; pass device="cpu" '
                       'to run the plain versions on the CPU')
  # The U-Net pools twice. The DC kernel takes every side, one route per
  # axis (``ops/dc_kernel.py::dc_route``); on the CPU the plain version.
  if image_size < 16 or image_size % 4:
    raise ValueError('image_size must be a multiple of 4 and at least 16, '
                     'got {}'.format(image_size))
  model = flagship_model(dtype, quantize_inference)
  model.init_weights(torch.Generator().manual_seed(seed))
  return model.to(device).eval(), undersample_batch
