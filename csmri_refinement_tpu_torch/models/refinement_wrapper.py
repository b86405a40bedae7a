"""RefinementWrapper: frozen pretrained path + learnable residual path.

Port of ``csmri_refinement_tpu/models/refinement_wrapper.py``:

* ``mode='add'``: pretrained output + learnable output;
* ``mode='real-penalty-add'``: per-example min/max scaling of the pretrained
  real channel to (−1, 1) (``_scale``/``_unscale``, ``:75-96``), the
  learnable output times a learned scalar ``scale`` (initialised to 0,
  ``:159``) added, then unscaled; the imaginary channel passes through;
  returns {pred, pretrained, prescaled_refinement, scaled_refinement};
* ``input_mode``: the learnable path sees the input, the pretrained output,
  or their concat;
* freezing: the pretrained model's parameters take no gradient and its
  forward runs under ``torch.no_grad()``, so autograd records nothing
  through it (JAX ``stop_gradient`` around it, ``:125-143``);
* ``INPUT_KEYS`` are the pretrained model's (a RecNet's
  ``('inp', 'kspace', 'mask')``), as JAX ``:108-110`` has them;
* the pretrained model runs in eval mode whatever the wrapper's mode
  (``train`` below), as the JAX wrapper calls it with ``train=False``
  (``:135-137``): a BN model there normalises with its running stats and
  leaves them unchanged.

Under a spatial mesh (``parallel/halo.py``) the per-example minimum and
maximum of ``_scale`` are the whole image's: the ranks' own extremes are
gathered over the spatial group (differentiably, for an unfrozen
pretrained model).
"""

import contextlib

import torch
from torch import nn

from csmri_refinement_tpu_torch.parallel import halo
from csmri_refinement_tpu_torch.utils import profiling

MODES = ('add', 'real-penalty-add')
INPUT_MODES = ('input', 'output', 'concat')


def _extreme(flat, reduce):
  """``reduce`` (amin or amax) over axis 1, over the whole image's rows
  under a spatial mesh."""
  value = reduce(flat, dim=1, keepdim=True)
  mesh = halo.current()
  if mesh is not None:
    value = reduce(halo.gather_rows(value[None], mesh, dim=0), dim=0)
  return value


def _scale(tensor):
  """Per-example/channel min-max scale to (−1, 1); returns (scaled, min,
  max-after-min)."""
  b, h, w, c = tensor.shape
  flat = tensor.reshape(b, h * w, c)
  minimum = _extreme(flat, torch.amin)
  flat = flat - minimum
  maximum = _extreme(flat, torch.amax)
  flat = flat / maximum * 2.0 - 1.0
  return flat.reshape(b, h, w, c), minimum, maximum


def _unscale(tensor, minimum, maximum):
  """(−1, 1) → the original range (may exceed it after the residual add)."""
  b, h, w, c = tensor.shape
  flat = (tensor.reshape(b, h * w, c) + 1.0) / 2.0
  return (flat * maximum + minimum).reshape(b, h, w, c)


class RefinementWrapper(nn.Module):
  """``forward(inp, *extra_inputs)``; the extra inputs (k-space and mask for
  a RecNet) go to the pretrained model."""

  def __init__(self, pretrained_model, learnable_model, mode='add',
               input_mode='input', freeze_pretrained_model=True):
    super().__init__()
    if mode not in MODES:
      raise ValueError('Unknown mode {}'.format(mode))
    if input_mode not in INPUT_MODES:
      raise ValueError('Unknown input mode {}'.format(input_mode))
    self.pretrained_model = pretrained_model
    self.learnable_model = learnable_model
    self.mode = mode
    self.input_mode = input_mode
    self.freeze_pretrained_model = freeze_pretrained_model
    if freeze_pretrained_model:
      pretrained_model.requires_grad_(False)
    if mode == 'real-penalty-add':
      self.scale = nn.Parameter(torch.zeros(1))

  @property
  def INPUT_KEYS(self):
    return getattr(self.pretrained_model, 'INPUT_KEYS', ('inp',))

  def init_weights(self, generator):
    self.pretrained_model.init_weights(generator)
    self.learnable_model.init_weights(generator)
    if self.mode == 'real-penalty-add':
      with torch.no_grad():
        self.scale.zero_()

  def train(self, mode=True):
    super().train(mode)
    self.pretrained_model.eval()
    return self

  def _learnable_input(self, inp, out_pretrained):
    if self.input_mode == 'input':
      return inp
    if self.input_mode == 'output':
      return out_pretrained
    return torch.cat([inp, out_pretrained], dim=-1)

  def forward(self, inp, *extra_inputs):
    with profiling.span('csmri.refinement'):
      if self.freeze_pretrained_model:
        inp = inp.detach()
      with torch.no_grad() if self.freeze_pretrained_model else \
          contextlib.nullcontext():
        out_pretrained = self.pretrained_model(inp, *extra_inputs)
      if isinstance(out_pretrained, dict):
        out_pretrained = out_pretrained['pred']

      learn_input = self._learnable_input(inp, out_pretrained)
      out_learnable = self.learnable_model(learn_input)
      if self.mode == 'add':
        return out_pretrained + out_learnable

      pretrained_real_scaled, minimum, maximum = _scale(
          out_pretrained[..., 0:1])
      out_learnable_scaled = self.scale * out_learnable
      out_real = _unscale(pretrained_real_scaled + out_learnable_scaled,
                          minimum, maximum)
      return {
          'pred': torch.cat([out_real, out_pretrained[..., 1:2]], dim=-1),
          'pretrained': out_pretrained,
          'prescaled_refinement': out_learnable,
          'scaled_refinement': out_learnable_scaled,
      }
