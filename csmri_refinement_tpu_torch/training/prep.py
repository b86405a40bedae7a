"""On-device batch preparation: the k-space forward model inside the step.

Port of ``RecBatchPreparer`` and ``SegBatchPreparer``
(``csmri_refinement_tpu/training/prep.py``). For reconstruction, through
the port's ``undersample_batch``: the host hands over clean ground-truth
slices ``{'gt', 'index'}`` (and ``'label'`` with ``include_labels``);
masks, undersampling and noise run on the device, and ``label`` and
``index`` ride along untouched (the segmentation score reads ``label``).
For segmentation the host has built ``inp`` and ``target`` already; they
are moved to the device.

``varden`` and ``cartesian`` masks:

* train: masks (and noise) from the ``torch.Generator`` the caller passes,
  a new one every step;
* validation: each slice's mask is drawn on the host from a CPU generator
  seeded with ``VAL_MASK_SEED + slice index``, moved to the device and
  kept, so a slice gets the same mask on every validation run whatever
  the batch order and the device (the JAX package folds the index into a
  fixed key, ``prep.py:58-64``; the bits differ, the contract is the
  same).

``radial`` masks (JAX ``prep.py:30-111``), whose spokes are drawn on the
host, so the preparer is not ``device_pure``:

* train: one seed drawn from the caller's generator seeds a
  ``RandomState`` for ``radial_masks_np`` (which honours
  ``variable_acceleration``, as JAX's ``get_mask_generator_np`` does); the
  batch is undersampled with that mask and no noise, as the JAX
  ``_fixed_fn`` passes none;
* validation: each slice's mask from ``RandomState(VAL_MASK_SEED +
  index)``, kept per index: the JAX package's masks, bit for bit.

Validation adds no noise, as the JAX package's ``_val_cartesian`` passes
none: ``undersampling.noise`` is training randomness only.

In a data-parallel run the runner sets ``shard = (d, D)`` and ``mesh``: a
train step's masks and noise (and a radial step's host masks) are drawn for
the global batch and the rank keeps its batch rows, as the JAX package
draws over its one global batch; validation masks go by slice index
anyway. Under a spatial mesh the forward model runs on the whole images of
the rank's batch rows, with the same draws as a one-process run, and the
batch is then cut (``parallel/mesh.py::split_image_rows``): ``inp``,
``target`` and ``label`` to the rank's image rows, ``kspace`` and ``mask``
to all rows of its column block, the layout the DC's column pass takes
(``ops/dc_kernel.py::dc_distributed``).
"""

import numpy as np
import torch

from csmri_refinement_tpu_torch.ops import masks as mask_ops
from csmri_refinement_tpu_torch.ops import undersample as us_ops
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib

VAL_MASK_SEED = 0


class RecBatchPreparer:
  """Builds {inp, kspace, mask, target} batches on ``device``."""

  def __init__(self, conf, device):
    cs = conf.get_attr('undersampling', default={})
    self.scheme = cs.get('sampling_scheme', 'varden')
    self.acc = cs.get('acceleration_factor', 8)
    self.variable = cs.get('variable_acceleration', False)
    self.noise = cs.get('noise', 0.0)
    if self.scheme not in ('varden', 'cartesian', 'radial'):
      raise ValueError('Unknown sampling scheme {}'.format(self.scheme))
    self.device = torch.device(device)
    self.shard = None
    self.mesh = None
    self._val_masks = {}

  @property
  def device_pure(self):
    """False for radial masks, drawn on the host in every train step (the
    runners then take one update per fetch, as JAX's do)."""
    return self.scheme != 'radial'

  def _gt(self, host_batch):
    return torch.as_tensor(host_batch['gt'], dtype=torch.float32).to(
        self.device)

  def _passthrough(self, batch, host_batch):
    for key in ('label', 'index'):
      if key in host_batch:
        batch[key] = torch.as_tensor(host_batch[key]).to(self.device)
    return mesh_lib.split_image_rows(batch, self.mesh)

  def prepare_train(self, generator, host_batch):
    gt = self._gt(host_batch)
    if self.scheme == 'radial':
      rng = np.random.RandomState(mask_ops.draw_seed(generator, self.device))
      mask = us_ops.shard_rows(lambda shape: mask_ops.radial_masks_np(
          shape, self.acc, rng, self.variable), tuple(gt.shape), self.shard)
      batch = us_ops.undersample_batch(None, gt, fixed_mask=mask)
    else:
      batch = us_ops.undersample_batch(
          generator, gt, sampling_scheme=self.scheme,
          acceleration_factor=self.acc,
          variable_acceleration=self.variable, noise=self.noise,
          shard=self.shard)
    return self._passthrough(batch, host_batch)

  def _val_mask(self, index, height, width):
    if index not in self._val_masks:
      if self.scheme == 'radial':
        mask = torch.from_numpy(mask_ops.radial_masks_np(
            (1, height, width), self.acc,
            np.random.RandomState(VAL_MASK_SEED + index))[0])
      else:
        gen = torch.Generator().manual_seed(VAL_MASK_SEED + index)
        mask = mask_ops.make_masks(
            gen, 1, height, width, sampling_scheme=self.scheme,
            acceleration_factor=self.acc)[0]
      self._val_masks[index] = mask.to(self.device, torch.float32)
    return self._val_masks[index]

  def prepare_val(self, host_batch):
    gt = self._gt(host_batch)
    _, height, width = gt.shape[:3]
    mask = torch.stack([self._val_mask(int(i), height, width)
                        for i in host_batch['index']])
    return self._passthrough(us_ops.undersample_batch(
        None, gt, fixed_mask=mask), host_batch)


class SegBatchPreparer:
  """{inp, target} batches on ``device``, as the host built them."""

  device_pure = True
  shard = None      # nothing is drawn: the rows are the host's
  mesh = None

  def __init__(self, device):
    self.device = torch.device(device)

  def prepare_train(self, generator, host_batch):
    return mesh_lib.split_image_rows(
        {'inp': torch.as_tensor(host_batch['inp'],
                                dtype=torch.float32).to(self.device),
         'target': torch.as_tensor(host_batch['target']).to(self.device)},
        self.mesh)

  def prepare_val(self, host_batch):
    return self.prepare_train(None, host_batch)


def get_batch_preparer(conf, device):
  application = conf.get_attr('application', default='reconstruction')
  if conf.get_attr('dataset_mode') == 'segmentation' or \
      application == 'segmentation':
    return SegBatchPreparer(device)
  if application in ('reconstruction', 'none'):
    return RecBatchPreparer(conf, device)
  raise ValueError('Unknown application {}'.format(application))
