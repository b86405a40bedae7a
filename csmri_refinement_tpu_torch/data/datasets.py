"""Datasets: ``SliceDataset`` and the ``Synthetic`` phantom builder.

Port of ``csmri_refinement_tpu/data/datasets.py`` (``SliceDataset``
``:56-135``, ``_make_phantoms``/``_build_synthetic`` ``:206-259``) for
reconstruction: items are ``{'gt': (H, W) float32 in (0, 1), 'index':
int32}``. The phantoms are numpy, drawn from the same ``RandomState`` seeds,
so they equal the JAX package's bit for bit. ScarSeg (needs the LGE data),
segmentation mode, labels, augmentation and the native batch path are not
ported yet (ROADMAP Queue 1 items 7 and 8).
"""

import logging

import numpy as np

from csmri_refinement_tpu_torch.data.transforms import RecHostTransform


class SliceDataset:
  """2D slices with the host-side reconstruction transform."""

  def __init__(self, images, image_size, downscale=1):
    self.images = images
    self.transform = RecHostTransform(image_size, downscale)

  def __len__(self):
    return len(self.images)

  def __getitem__(self, index):
    return {'gt': self.transform(self.images[index]),
            'index': np.int32(index)}


def _make_phantoms(num_images, size, seed, num_ellipses=6):
  """Deterministic smooth ellipse phantoms + 2-class labels (the JAX
  package's generator, line for line)."""
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
  images = np.zeros((num_images, size, size), np.float32)
  labels = np.zeros((num_images, size, size), np.int64)
  for i in range(num_images):
    img = np.zeros((size, size), np.float32)
    best_mask, best_val = None, -1.0
    for _ in range(num_ellipses):
      cx, cy = rng.uniform(0.2, 0.8, 2)
      ax, ay = rng.uniform(0.05, 0.3, 2)
      theta = rng.uniform(0, np.pi)
      amp = rng.uniform(0.2, 1.0)
      xr = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
      yr = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
      d = (xr / ax) ** 2 + (yr / ay) ** 2
      soft = np.clip(1.0 - d, 0.0, 1.0) ** 0.5
      img += amp * soft
      if amp > best_val:
        best_val, best_mask = amp, (d < 0.7)
    img = img / max(img.max(), 1e-6)
    images[i] = img
    labels[i][best_mask] = 1
  return images, labels


def _build_synthetic(conf, fold):
  for key in ('augmentation', 'include_labels', 'native_pipeline'):
    if conf.get_attr(key):
      raise NotImplementedError('{} is not ported yet'.format(key))
  if conf.get_attr('dataset_mode', default='reconstruction') != \
      'reconstruction':
    raise NotImplementedError('only reconstruction datasets are ported')
  synth = conf.get_attr('synthetic', default={})
  size = synth.get('image_size', 256)
  sizes = {'train': synth.get('num_train', 64),
           'val': synth.get('num_val', 16),
           'test': synth.get('num_test', 16)}
  fold_seed = {'train': 0, 'val': 1, 'test': 2}[fold] + 100 * conf.seed
  images, _ = _make_phantoms(sizes[fold], size, fold_seed)
  return SliceDataset(images, size,
                      downscale=conf.get_attr('downscale', default=1))


_DATASET_BUILDERS = {
    'Synthetic': _build_synthetic,
}


def load_dataset(conf, dataset_name, fold):
  """Dataset registry dispatch."""
  if fold not in ('train', 'val', 'test'):
    raise ValueError('Unknown fold {}'.format(fold))
  if dataset_name not in _DATASET_BUILDERS:
    raise NotImplementedError('dataset {} is not ported yet'.format(
        dataset_name))
  logging.debug('Loading dataset %s fold %s', dataset_name, fold)
  return _DATASET_BUILDERS[dataset_name](conf, fold)
