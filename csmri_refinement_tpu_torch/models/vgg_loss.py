"""VGG perceptual loss.

Port of ``csmri_refinement_tpu/models/vgg_loss.py``: packed-complex (..., 2)
images become magnitude images tripled to RGB (``ops/fft.complex_abs``:
gradient 0 at an exact zero, where JAX's is NaN), other images are taken in
(−1, 1) and mapped to (0, 1); the loss is the weighted sum over the chosen
VGG19 blocks of the L1 or MSE distance between the prediction's features and
the target's. The target branch runs under ``torch.no_grad()`` (JAX's
``stop_gradient``), the VGG19 is frozen, and the distances are taken in f32
whatever the VGG19's compute ``dtype`` (JAX ``:83-90``). With ``remat`` the
prediction branch's features are recomputed in the backward (JAX ``:77``);
the target branch stores nothing either way. Under a spatial mesh a block
whose rows the ranks hold unequally (below a pool that split a rank's
rows; its layout from ``VGG19.feature_rows``) is averaged as S times the
rank's share (``halo.mean``).
"""

import torch

from csmri_refinement_tpu_torch.models import remat as remat_lib
from csmri_refinement_tpu_torch.models.vgg import VGG19, load_vgg19_params
from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.parallel import halo

# (features a, b, their NCHW row layout) → the mean distance
_CRITERIA = {
    'MSE': lambda a, b, rows: halo.mean((a - b) ** 2, rows, 2),
    'L1': lambda a, b, rows: halo.mean(torch.abs(a - b), rows, 2),
}


def _complex_to_rgb(x):
  mag = fft.complex_abs(x)
  return torch.cat([mag, mag, mag], dim=-1)


def _to_vgg_input(x):
  if x.shape[-1] == 2:
    return _complex_to_rgb(x)
  return torch.clamp((x + 1.0) / 2.0, -1.0, 1.0)


class VGGLoss:
  """``loss(prediction, target)`` on NHWC images; the VGG19 lives on
  ``device`` (the card unless the caller asks for the CPU)."""

  def __init__(self, loss_name, blocks=-1, criterion='L1', weights=None,
               weights_path=None, conf_path=None, allow_random_init=False,
               seed=0, device='cuda', remat=False, dtype=None):
    if loss_name != 'VGG19':
      raise ValueError('Unknown VGG loss {}'.format(loss_name))
    if blocks == -1:
      blocks = [VGG19.LAST_FEATURE_MAP]
    elif not isinstance(blocks, list):
      blocks = [blocks]
    self.blocks = blocks
    self.vgg = load_vgg19_params(weights_path, conf_path, allow_random_init,
                                 seed, tuple(blocks), dtype).to(device)
    self.criterion = _CRITERIA[criterion]
    self.remat = remat
    if weights is not None and len(weights) != len(blocks):
      raise ValueError('need one VGG loss weight per block')
    self.weights = list(weights) if weights is not None else \
        [1.0] * len(blocks)

  def __call__(self, prediction, target):
    if prediction.shape[-1] == 2 and target.shape[-1] != 2:
      raise ValueError('complex prediction needs a complex target')
    pred_in = _to_vgg_input(prediction.float())
    pred_features = remat_lib.checkpoint(self.vgg, pred_in) if self.remat \
        else self.vgg(pred_in)
    with torch.no_grad():
      target_features = self.vgg(_to_vgg_input(target.float()))
    loss = 0.0
    # Features in ascending block order; the weights follow the blocks'
    # config order, which the JAX loss pairs with its sorted outputs too.
    for weight, pred_f, target_f, rows in zip(
        self.weights, pred_features, target_features,
        self.vgg.feature_rows(pred_in)):
      loss = loss + weight * self.criterion(pred_f.float(), target_f.float(),
                                            rows)
    return loss
