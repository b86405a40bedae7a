"""Datasets: ``SliceDataset``, ScarSeg (Analyze-format LGE volumes) and
the ``Synthetic`` phantoms.

Port of ``csmri_refinement_tpu/data/datasets.py`` (``SliceDataset``
``:56-135``, the ScarSeg split, loader and builder ``:32-204``,
``_make_phantoms``/``_build_synthetic`` ``:206-259``, the registry
``:263-279``). Items:

* reconstruction mode: ``{'gt': (H, W) float32 in (0, 1), 'index':
  int32}``, plus the un-augmented, downscaled ``'label'`` (H, W) int64 with
  ``include_labels`` (for the segmentation score);
* segmentation mode: ``{'inp': (H, W, 2) float32 ground truth as complex,
  'target': (H, W) int64, 'index': int32}``.

The phantoms and their labels are numpy, drawn from the same
``RandomState`` seeds, so they equal the JAX package's bit for bit.

ScarSeg reads ``<data_dir>/scar_segmentation/<case>/Analyze/LGE.{hdr,img}``
and ``<case>/ManualSegmentation/ROI_1_M_MSP_New2.{hdr,img}`` for the 36
cases of ``STATIC_SPLIT`` (or every ``c*`` case under ``random_split``),
the first ``NUM_SLICES`` slices of each, 512² (``IMAGE_SIZE``) cropped in
k-space to ``512 / downscale``. One deliberate difference: a slice's name
(``get_filename``) counts the slices its volume has, where the JAX package
counts ``NUM_SLICES`` per case whatever the volume holds, which names every
slice after the first case wrongly when a volume is shorter; and a volume
of one slice is read as one slice (the JAX loader fails on it).
``write_scarseg_phantoms`` writes such a tree from the phantoms (the LGE
data is not in the repository).

The training fold takes the config's ``augmentation`` (JAX ``:75-81``,
``:183``, ``:251``): the dataset owns one ``RandomState(seed)`` that its
transform draws from, item by item. With ``num_data_workers`` above 0 the
loader's threads share it, so the order of the draws is not fixed (as in
the JAX package). ``native_pipeline`` (JAX ``:86-108``) prepares whole
batches in the host library (``data/native.py``) when the items need no
k-space crop and carry no labels; unlike the JAX package, which then falls
back to the numpy path, a library that cannot be built raises.
"""

import glob
import logging
import os
import re

import numpy as np

from csmri_refinement_tpu_torch.data import native
from csmri_refinement_tpu_torch.data.analyze_io import (load_analyze,
                                                        save_analyze)
from csmri_refinement_tpu_torch.data.transforms import (RecHostTransform,
                                                        RecSegHostTransform)

IMAGE_SIZE = 512  # ScarSeg source resolution
NUM_SLICES = 52
DEFAULT_SPLIT_RATIO = [4, 1, 1]

_CASE_REGEXP = re.compile(r'(c\d+\_(pre|post))\_slice(\d+)')

# Patient-level static split for ratio [4, 1, 1] (the JAX package's
# ``STATIC_SPLIT``, dataset metadata).
STATIC_SPLIT = {
    'train': ['c03_pre', 'c43_pre', 'c47_post', 'c45_post', 'c24_post',
              'c13_pre', 'c49_post', 'c41_post', 'c46_pre', 'c26_pre',
              'c46_post', 'c38_post', 'c11_post', 'c20_post', 'c19_post',
              'c09_post', 'c26_post', 'c37_post', 'c44_post', 'c25_post',
              'c02_post', 'c25_pre', 'c28_post', 'c34_pre'],
    'val': ['c18_pre', 'c34_post', 'c54_pre', 'c17_post', 'c18_post',
            'c03_post'],
    'test': ['c43_post', 'c29_post', 'c44_pre', 'c13_post', 'c45_pre',
             'c48_post'],
}

IMAGE_PATH = os.path.join('Analyze', 'LGE.img')
LABEL_PATH = os.path.join('ManualSegmentation', 'ROI_1_M_MSP_New2.img')


class SliceDataset:
  """2D slices with the host-side reconstruction or segmentation
  transform."""

  def __init__(self, images, labels, image_size, mode='reconstruction',
               downscale=1, include_labels=False, image_ids=None,
               name='SliceDataset', augmentation=None, seed=0,
               native_pipeline=False):
    if mode not in ('reconstruction', 'segmentation'):
      raise ValueError('Unknown dataset mode {!r}'.format(mode))
    self.images = images
    self.labels = labels
    self.image_ids = image_ids
    self.name = name
    self.mode = mode
    self.downscale = downscale
    self.include_labels = include_labels and labels is not None
    self.seed = seed
    self.augmentation = augmentation
    rng = np.random.RandomState(seed)
    self.transform = \
        RecHostTransform(image_size, downscale, augmentation, rng) \
        if mode == 'reconstruction' else \
        RecSegHostTransform(image_size, downscale, augmentation, rng)

    # The native batch path: only where no k-space crop is needed and the
    # items carry no labels.
    self._native_slices = None
    size = image_size // downscale
    if (native_pipeline and mode == 'reconstruction' and
        not self.include_labels and images.shape[-2:] == (size, size)):
      native.library()      # raises if the library cannot be built
      self._native_slices = np.ascontiguousarray(images, np.float32)
      self._native_counter = 0

  def native_batch(self, indices):
    """A whole batch prepared by the host library, or None off that path.
    Batch n (from 1) is seeded ``seed * 1000003 + n``."""
    if self._native_slices is None:
      return None
    aug = self.augmentation or {}
    self._native_counter += 1
    gt = native.prepare_batch(
        self._native_slices, np.asarray(indices, np.int32),
        shift=aug.get('shift', 0) or 0,
        max_rotate=aug.get('rotate', 0) or 0,
        zoom_range=tuple(aug.get('scale', (1.0, 1.0))),
        seed=self.seed * 1000003 + self._native_counter)
    return {'gt': gt, 'index': np.asarray(indices, np.int32)}

  def __len__(self):
    return len(self.images)

  def __getitem__(self, index):
    image = self.images[index]
    if self.mode == 'reconstruction':
      item = {'gt': self.transform(image), 'index': np.int32(index)}
      if self.include_labels:
        label = self.labels[index][::self.downscale, ::self.downscale]
        item['label'] = np.round(label).astype(np.int64)
      return item
    gt, label = self.transform(image, self.labels[index])
    return {'inp': np.stack([gt, np.zeros_like(gt)], axis=-1),
            'target': label, 'index': np.int32(index)}

  def get_filename(self, index):
    return self.image_ids[index]

  @staticmethod
  def get_case_and_slice(name):
    """('c18_pre', '3') of 'c18_pre_slice3'."""
    m = _CASE_REGEXP.match(name)
    if m is None:
      raise ValueError('not a ScarSeg slice name: {!r}'.format(name))
    return m.group(1), m.group(3)


def _split_scarseg(data_dir, ratio, static_split=True):
  """(train, val, test) case directories under ``data_dir``."""
  if static_split:
    splits = [[os.path.join(data_dir, pid) for pid in STATIC_SPLIT[fold]]
              for fold in ('train', 'val', 'test')]
    for path in (p for split in splits for p in split):
      if not (os.path.isfile(os.path.join(path, IMAGE_PATH)) and
              os.path.isfile(os.path.join(path, LABEL_PATH))):
        raise FileNotFoundError(
            'Did not find image or label for {}'.format(path))
    return splits

  ratio = np.array(ratio, float) / sum(ratio)
  paths = [folder for folder in sorted(glob.glob(os.path.join(data_dir,
                                                               'c*')))
           if os.path.isfile(os.path.join(folder, IMAGE_PATH)) and
           os.path.isfile(os.path.join(folder, LABEL_PATH))]
  np.random.RandomState(seed=0).shuffle(paths)
  n_train, n_val, _ = (int(len(paths) * r) for r in ratio)
  return (paths[:n_train], paths[n_train:n_train + n_val],
          paths[n_train + n_val:])


def _load_scarseg_volumes(case_paths, nz=NUM_SLICES):
  """(images (N, H, W), labels (N, H, W), slice names) of the first ``nz``
  slices of each case, cases in order."""
  def volume(path):   # a one-slice volume comes back squeezed to (H, W)
    vol = load_analyze(path)
    return vol.reshape(vol.shape[:2] + (-1,))[..., :nz]

  images, labels, image_ids = [], [], []
  for path in case_paths:
    image = volume(os.path.join(path, IMAGE_PATH))
    label = volume(os.path.join(path, LABEL_PATH))
    images.append(image)
    labels.append(label)
    image_ids += ['{}_slice{}'.format(os.path.basename(path), sl)
                  for sl in range(image.shape[-1])]
  images = np.array(images)
  labels = np.array(labels)
  _, h, w, _ = images.shape
  images = images.transpose((0, 3, 1, 2)).reshape(-1, h, w)
  labels = labels.transpose((0, 3, 1, 2)).reshape(-1, h, w)
  return images, labels, image_ids


def _dataset_options(conf, fold):
  """The SliceDataset keywords that ``_build_scarseg`` and
  ``_build_synthetic`` take from the config; the augmentation only in the
  training fold."""
  return dict(
      mode=conf.get_attr('dataset_mode', default='reconstruction'),
      downscale=conf.get_attr('downscale', default=1),
      include_labels=conf.get_attr('include_labels', default=False),
      augmentation=conf.get_attr('augmentation') if fold == 'train' else None,
      seed=conf.seed,
      native_pipeline=conf.get_attr('native_pipeline', default=False))


def _build_scarseg(conf, data_dir, fold):
  data_path = os.path.join(data_dir, 'scar_segmentation')
  ratio = conf.get_attr('split_ratio', default=DEFAULT_SPLIT_RATIO)
  static = not conf.get_attr('random_split', default=False)
  fold_idx = ('train', 'val', 'test').index(fold)
  case_paths = _split_scarseg(data_path, ratio, static)[fold_idx]
  images, labels, image_ids = _load_scarseg_volumes(case_paths)
  return SliceDataset(images, labels, IMAGE_SIZE, image_ids=image_ids,
                      name='ScarSeg', **_dataset_options(conf, fold))


def write_scarseg_phantoms(data_dir, size=IMAGE_SIZE, num_slices=4, seed=0,
                           cases=None):
  """Write a ScarSeg-format tree of phantom volumes under
  ``<data_dir>/scar_segmentation``: for each case (default: the 36 of
  ``STATIC_SPLIT``) an LGE volume (size, size, num_slices) int16 of
  ``_make_phantoms`` scaled to the int16 range (datatype 4) and its label
  volume uint8 (datatype 2), case ``i`` seeded ``seed * 1000 + i``.
  Returns the number of bytes written."""
  if cases is None:
    cases = [c for fold in ('train', 'val', 'test')
             for c in STATIC_SPLIT[fold]]
  written = 0
  for i, case in enumerate(cases):
    images, labels = _make_phantoms(num_slices, size, seed * 1000 + i)
    volume = np.round(images.transpose(1, 2, 0) * 32767).astype(np.int16)
    label = labels.transpose(1, 2, 0).astype(np.uint8)
    for rel, vol in ((IMAGE_PATH, volume), (LABEL_PATH, label)):
      path = os.path.join(data_dir, 'scar_segmentation', case, rel)
      os.makedirs(os.path.dirname(path), exist_ok=True)
      save_analyze(path, vol)
      written += vol.nbytes
  return written


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


def _build_synthetic(conf, data_dir, fold):
  synth = conf.get_attr('synthetic', default={})
  size = synth.get('image_size', 256)
  sizes = {'train': synth.get('num_train', 64),
           'val': synth.get('num_val', 16),
           'test': synth.get('num_test', 16)}
  fold_seed = {'train': 0, 'val': 1, 'test': 2}[fold] + 100 * conf.seed
  images, labels = _make_phantoms(sizes[fold], size, fold_seed)
  return SliceDataset(
      images, labels, size,
      image_ids=['c00_pre_slice{:02d}'.format(i) for i in range(len(images))],
      name='Synthetic', **_dataset_options(conf, fold))


_DATASET_BUILDERS = {
    'ScarSeg': _build_scarseg,
    'Synthetic': _build_synthetic,
}


def is_dataset(dataset_name):
  return dataset_name in _DATASET_BUILDERS


def load_dataset(conf, data_dir, dataset_name, fold):
  """Dataset registry dispatch; ``data_dir`` holds ``scar_segmentation``
  (Synthetic reads nothing)."""
  if fold not in ('train', 'val', 'test'):
    raise ValueError('Unknown fold {}'.format(fold))
  if dataset_name not in _DATASET_BUILDERS:
    raise ValueError('Unknown dataset {}'.format(dataset_name))
  logging.debug('Loading dataset %s fold %s', dataset_name, fold)
  return _DATASET_BUILDERS[dataset_name](conf, data_dir, fold)
