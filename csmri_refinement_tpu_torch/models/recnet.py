"""RecNet — deep cascade of CNNs with k-space data consistency.

Port of ``csmri_refinement_tpu/models/recnet.py`` (``ConvBlock``
``:61-109``, ``RecNet`` ``:169-203``) as ``nn.Module``s on NHWC tensors:

* each block = ``num_convs`` dilated SAME convs with LeakyReLU between,
  followed by a data-consistency step;
* optional residual add per block (``use_refinement``), skip of the final
  DC (``skip_final_dc``), intermediate reconstructions
  (``return_intermediate_recs``);
* init: first conv of each block xavier_uniform(1), the rest
  he_normal(relu_leakiness), unless the config overrides ``conv_weight``.

Under a bf16 compute dtype the parameters stay f32 (each conv casts its
weights, as flax's ``param_dtype`` default keeps them) and the DC runs in
float32: ``ops/dc.py::data_consistency`` casts its input and the result
goes back to the compute dtype (JAX ``:194-197``). The DC is
differentiable on the card (``ops/dc_kernel.py::_DCFunction``: K1 forward,
K1-bwd backward). The convs are plain ``F.conv2d`` (cuDNN on the card), as
the JAX package leaves them to XLA. ``dc_lines_acc`` and
``dc_zero_filled_input`` are accepted (``construct_model`` derives the
former from a threaded ``undersampling`` section, as the JAX runner does)
but every DC runs the dense K1 kernel: the JAX package's
``CSMRI_TPU_FUSED_DC=1`` route, which its sampled-lines ("skinny") lowering
equals exactly (its ``ops/dc.py:310-332``). The skinny lowering is not ported.
``use_scan`` (JAX ``:170-179``, ``_forward_scan`` ``:205-231``) runs the
same loop: the scan only bounds XLA's compile time, and its
``(block, DC)`` step is the loop's. It changes the flax tree, which keeps a
homogeneous cascade's blocks stacked under ``blocks/block``; ``scan_layout``
says when (``utils/jax_weights.py`` reads that layout). Submodule names
follow the flax tree otherwise (``block_{i}.conv_{j}``).
"""

import torch
from torch import nn

from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.models.layers import leaky_relu, same_conv
from csmri_refinement_tpu_torch.ops import dc as dc_ops
from csmri_refinement_tpu_torch.utils import profiling

DEFAULT_RELU_LEAKINESS = 0.01


class ConvBlock(nn.Module):
  """``num_convs`` SAME convs; LeakyReLU after all but the last."""

  def __init__(self, in_channels, num_convs, num_filters, kernel_size,
               relu_leakiness, dilations, padding='zero', num_outputs=2,
               final_act=False, dtype=None):
    super().__init__()
    self.num_convs = num_convs
    self.relu_leakiness = relu_leakiness
    self.dilations = tuple(dilations)
    self.padding = padding
    self.final_act = final_act
    self.dtype = dtype
    cin = in_channels
    for i in range(num_convs):
      cout = num_outputs if i == num_convs - 1 else num_filters
      self.add_module('conv_{}'.format(i),
                      nn.Conv2d(cin, cout, kernel_size, bias=True))
      cin = cout

  def convs(self):
    return [getattr(self, 'conv_{}'.format(i)) for i in range(self.num_convs)]

  def forward(self, x):
    """x: (B, H, W, C) → (B, H, W, num_outputs) in the compute dtype; in
    the span ``csmri.recnet.block``."""
    with profiling.span('csmri.recnet.block'):
      dt = self.dtype or x.dtype
      h = x.to(dt).permute(0, 3, 1, 2)
      for i, conv in enumerate(self.convs()):
        h = same_conv(h, conv.weight.to(dt), conv.bias.to(dt), self.padding,
                      dilation=self.dilations[i])
        if i < self.num_convs - 1 or self.final_act:
          h = leaky_relu(h, self.relu_leakiness)
      return h.permute(0, 2, 3, 1)


class RecNet(nn.Module):
  """Cascade of (ConvBlock → data consistency) on (B, H, W, 2) inputs;
  ``forward(inp, kspace, mask)``."""

  INPUT_KEYS = ('inp', 'kspace', 'mask')

  def __init__(self, num_blocks, num_convs, num_filters, num_final_outputs=2,
               dilations_per_conv=1, kernel_size=3,
               relu_leakiness=DEFAULT_RELU_LEAKINESS, padding='zero',
               use_refinement=False, skip_final_dc=False,
               return_intermediate_recs=False, use_scan=False,
               weight_init=None, dtype=None, dc_lines_acc=None,
               dc_zero_filled_input=True):
    super().__init__()
    if isinstance(num_filters, int):
      num_filters = [num_filters] * num_blocks
    if isinstance(dilations_per_conv, int):
      dilations_per_conv = [dilations_per_conv] * num_convs
    if len(num_filters) != num_blocks:
      raise ValueError('Number of given filters must match number of blocks')
    if len(dilations_per_conv) != num_convs:
      raise ValueError(
          'Number of dilations must match number of convolutions')
    self.num_blocks = num_blocks
    self.use_refinement = use_refinement
    self.skip_final_dc = skip_final_dc
    self.return_intermediate_recs = return_intermediate_recs
    self.relu_leakiness = relu_leakiness
    self.weight_init = weight_init or {}
    self.dtype = dtype
    # JAX scans (and stacks the blocks' parameters) only over a cascade
    # whose blocks are all alike.
    self.scan_layout = use_scan and len(set(num_filters)) == 1 and \
        num_final_outputs == 2 and not skip_final_dc and \
        not return_intermediate_recs
    # Kept for the config's sake; the dense DC they would lower is exact.
    self.dc_lines_acc = dc_lines_acc
    self.dc_zero_filled_input = dc_zero_filled_input
    for idx in range(num_blocks):
      num_outputs = 2 if idx < num_blocks - 1 else num_final_outputs
      self.add_module('block_{}'.format(idx), ConvBlock(
          2, num_convs, num_filters[idx], kernel_size, relu_leakiness,
          dilations_per_conv, padding=padding, num_outputs=num_outputs,
          dtype=dtype))

  def blocks(self):
    return [getattr(self, 'block_{}'.format(i))
            for i in range(self.num_blocks)]

  def init_weights(self, generator):
    """Seeded init with the JAX package's initialisers."""
    inits = weight_inits.resolve_inits(
        {'conv_weight': ('he_normal', DEFAULT_RELU_LEAKINESS)},
        self.weight_init)
    first = inits['conv_weight'] if 'conv_weight' in self.weight_init \
        else ('xavier', 1.0)
    for block in self.blocks():
      for i, conv in enumerate(block.convs()):
        weight_inits.init_(conv.weight,
                           first if i == 0 else inits['conv_weight'],
                           generator)
        weight_inits.init_(conv.bias, inits['conv_bias'], generator)

  def forward(self, inp, kspace, mask):
    num_dc_layers = self.num_blocks - (1 if self.skip_final_dc else 0)
    x = inp
    reconstructions = []
    for idx, block in enumerate(self.blocks()):
      block_input = x
      x = block(x)
      if self.use_refinement:
        x = x + block_input
      if idx < num_dc_layers:
        # DC is precision-critical: always merge in float32 k-space.
        x = dc_ops.data_consistency(x, kspace, mask).to(x.dtype)
        if self.return_intermediate_recs:
          reconstructions.append(x)
    if self.return_intermediate_recs:
      return {'pred': x, 'reconstructions': reconstructions}
    return x
