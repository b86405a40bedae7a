"""On-device batch preparation: the k-space forward model inside the step.

Port of ``RecBatchPreparer`` (``csmri_refinement_tpu/training/prep.py``)
for the ``varden`` and ``cartesian`` schemes, through the port's
``undersample_batch``. The host hands over clean ground-truth slices
``{'gt', 'index'}``; masks, undersampling and noise run on the device.

* train: masks (and noise) from the ``torch.Generator`` the caller passes,
  a new one every step;
* validation: each slice's mask is drawn from a generator seeded with
  ``VAL_MASK_SEED + slice index`` and kept, so a slice gets the same mask
  on every validation run whatever the batch order (the JAX package folds
  the index into a fixed key, ``prep.py:58-64``; the bits differ, the
  contract is the same).

Radial masks wait (ROADMAP Queue 1 item 1).
"""

import torch

from csmri_refinement_tpu_torch.ops import masks as mask_ops
from csmri_refinement_tpu_torch.ops import undersample as us_ops

VAL_MASK_SEED = 0


class RecBatchPreparer:
  """Builds {inp, kspace, mask, target} batches on ``device``."""

  def __init__(self, conf, device):
    cs = conf.get_attr('undersampling', default={})
    self.scheme = cs.get('sampling_scheme', 'varden')
    self.acc = cs.get('acceleration_factor', 8)
    self.variable = cs.get('variable_acceleration', False)
    self.noise = cs.get('noise', 0.0)
    if self.scheme not in ('varden', 'cartesian'):
      raise NotImplementedError(
          'sampling scheme {!r} is not ported yet'.format(self.scheme))
    self.device = torch.device(device)
    self._val_masks = {}

  def _gt(self, host_batch):
    return torch.as_tensor(host_batch['gt'], dtype=torch.float32).to(
        self.device)

  def prepare_train(self, generator, host_batch):
    return us_ops.undersample_batch(
        generator, self._gt(host_batch), sampling_scheme=self.scheme,
        acceleration_factor=self.acc, variable_acceleration=self.variable,
        noise=self.noise)

  def _val_mask(self, index, height, width):
    if index not in self._val_masks:
      gen = torch.Generator(device=self.device).manual_seed(
          VAL_MASK_SEED + index)
      self._val_masks[index] = mask_ops.make_masks(
          gen, 1, height, width, sampling_scheme=self.scheme,
          acceleration_factor=self.acc, device=self.device)[0]
    return self._val_masks[index]

  def prepare_val(self, host_batch):
    gt = self._gt(host_batch)
    _, height, width = gt.shape[:3]
    mask = torch.stack([self._val_mask(int(i), height, width)
                        for i in host_batch['index']])
    gen = torch.Generator(device=self.device).manual_seed(VAL_MASK_SEED)
    return us_ops.undersample_batch(gen, gt, noise=self.noise,
                                    fixed_mask=mask)


def get_batch_preparer(conf, device):
  application = conf.get_attr('application', default='reconstruction')
  if application in ('reconstruction', 'none'):
    return RecBatchPreparer(conf, device)
  raise NotImplementedError(
      'batch preparation for {!r} is not ported yet'.format(application))
