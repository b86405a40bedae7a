"""On-device batch preparation: the k-space forward model inside the step.

Port of ``RecBatchPreparer`` and ``SegBatchPreparer``
(``csmri_refinement_tpu/training/prep.py``). For reconstruction, the
``varden`` and ``cartesian`` schemes, through the port's
``undersample_batch``: the host hands over clean ground-truth slices
``{'gt', 'index'}`` (and ``'label'`` with ``include_labels``); masks,
undersampling and noise run on the device, and ``label`` and ``index``
ride along untouched (the segmentation score reads ``label``). For
segmentation the host has built ``inp`` and ``target`` already; they are
moved to the device.

* train: masks (and noise) from the ``torch.Generator`` the caller passes,
  a new one every step;
* validation: each slice's mask is drawn on the host from a CPU generator
  seeded with ``VAL_MASK_SEED + slice index``, moved to the device and
  kept, so a slice gets the same mask on every validation run whatever
  the batch order and the device (the JAX package folds the index into a
  fixed key, ``prep.py:58-64``; the bits differ, the contract is the
  same).

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

  def _passthrough(self, batch, host_batch):
    for key in ('label', 'index'):
      if key in host_batch:
        batch[key] = torch.as_tensor(host_batch[key]).to(self.device)
    return batch

  def prepare_train(self, generator, host_batch):
    return self._passthrough(us_ops.undersample_batch(
        generator, self._gt(host_batch), sampling_scheme=self.scheme,
        acceleration_factor=self.acc, variable_acceleration=self.variable,
        noise=self.noise), host_batch)

  def _val_mask(self, index, height, width):
    if index not in self._val_masks:
      gen = torch.Generator().manual_seed(VAL_MASK_SEED + index)
      self._val_masks[index] = mask_ops.make_masks(
          gen, 1, height, width, sampling_scheme=self.scheme,
          acceleration_factor=self.acc)[0].to(self.device)
    return self._val_masks[index]

  def prepare_val(self, host_batch):
    gt = self._gt(host_batch)
    _, height, width = gt.shape[:3]
    mask = torch.stack([self._val_mask(int(i), height, width)
                        for i in host_batch['index']])
    gen = torch.Generator(device=self.device).manual_seed(VAL_MASK_SEED)
    return self._passthrough(us_ops.undersample_batch(
        gen, gt, noise=self.noise, fixed_mask=mask), host_batch)


class SegBatchPreparer:
  """{inp, target} batches on ``device``, as the host built them."""

  def __init__(self, device):
    self.device = torch.device(device)

  def prepare_train(self, generator, host_batch):
    return {'inp': torch.as_tensor(host_batch['inp'],
                                   dtype=torch.float32).to(self.device),
            'target': torch.as_tensor(host_batch['target']).to(self.device)}

  def prepare_val(self, host_batch):
    return self.prepare_train(None, host_batch)


def get_batch_preparer(conf, device):
  application = conf.get_attr('application', default='reconstruction')
  if conf.get_attr('dataset_mode') == 'segmentation' or \
      application == 'segmentation':
    return SegBatchPreparer(device)
  if application in ('reconstruction', 'none'):
    return RecBatchPreparer(conf, device)
  raise NotImplementedError(
      'batch preparation for {!r} is not ported yet'.format(application))
