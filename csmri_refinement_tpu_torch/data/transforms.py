"""Host-side per-item transforms feeding the device pipeline.

Port of ``csmri_refinement_tpu/data/transforms.py``:
``center_crop_in_kspace_np``, ``_apply_augmentation`` (``:43-62``),
``RecHostTransform`` (``:65-92``) and ``RecSegHostTransform``
(``:95-153``). The host emits clean ground-truth slices in (0, 1) (and,
for segmentation, their label maps), augmented in the training fold from
the transform's ``RandomState``; undersampling runs on the device in the
train/val step (``training/prep.py``). The draws and the arithmetic are
the JAX package's, so equal ``RandomState``s give equal items, bit for
bit.
"""

import numpy as np

from csmri_refinement_tpu_torch.data import augment


def center_crop_in_kspace_np(img, size):
  """|ifft2c(centre crop(fft2c(img)))| of a real (H, W) image."""
  if isinstance(size, int):
    size = (size, size)
  nx, ny = img.shape[:2]
  k = np.fft.fftshift(
      np.fft.fft2(np.fft.ifftshift(img, axes=(0, 1)), axes=(0, 1),
                  norm='ortho'), axes=(0, 1))
  cx, cy = nx // 2, ny // 2
  th, tw = size
  k_crop = k[cx - th // 2: cx - th // 2 + th,
             cy - tw // 2: cy - tw // 2 + tw]
  out = np.fft.fftshift(
      np.fft.ifft2(np.fft.ifftshift(k_crop, axes=(0, 1)), axes=(0, 1),
                   norm='ortho'), axes=(0, 1))
  return np.abs(out)


def _apply_augmentation(image, augmentation, rng):
  """One image's augmentation chain: elastic → translate → rotate → zoom."""
  alpha = augmentation.get('elastic_transform_alpha')
  sigma = augmentation.get('elastic_transform_sigma')
  if alpha is not None and sigma is not None:
    image = augment.elastic_transform(image, alpha, sigma, rng)

  shift = augmentation.get('shift')
  if shift is not None:
    image = augment.random_translate(image, shift, rng)

  rot = augmentation.get('rotate')
  if rot is not None:
    image = augment.random_rotate(image, (-rot, rot), rng)

  zoom_range = augmentation.get('scale')
  if zoom_range is not None:
    image = augment.random_zoom(image, zoom_range, rng)
  return image


def _crop_and_normalise(img2d, target_size):
  """The k-space crop to ``target_size`` (or the magnitude when the slice
  has that size already), divided by its peak."""
  if img2d.shape[0] != target_size or img2d.shape[1] != target_size:
    img2d = center_crop_in_kspace_np(img2d, target_size)
  else:
    img2d = np.abs(img2d)
  peak = np.max(np.abs(img2d))
  if peak > 0:
    img2d = img2d / peak
  return img2d


class RecHostTransform:
  """GT slice prep for reconstruction: augment → k-space crop → normalise."""

  def __init__(self, image_size, downscale=1, augmentation=None, rng=None):
    self.target_size = image_size // downscale
    self.augmentation = augmentation
    self.rng = rng if rng is not None else np.random

  def __call__(self, image):
    """image: (H, W) or (H, W, 1) raw slice → (size, size) float32 in (0,1)."""
    if image.ndim == 2:
      image = image[:, :, None]
    image = image.astype(np.float32)
    if self.augmentation is not None:
      image = _apply_augmentation(image, self.augmentation, self.rng)
    return _crop_and_normalise(image[..., 0],
                               self.target_size).astype(np.float32)


class RecSegHostTransform:
  """Joint image + label prep for segmentation.

  Augmentation moves image and label together: one translate of the two
  stacked, then ``random_rotate_pair`` and ``random_zoom_pair`` with spline
  orders (2, 0), so the label stays a label map. The label is subsampled by
  ``downscale`` and rounded to int64. The input options (JAX ``:147-150``,
  which no config sets): ``normalize`` takes the cropped image to zero
  mean and unit std, then ``scale_by_max`` divides by its maximum and clips
  to [0, 1].
  """

  def __init__(self, image_size, downscale=1, augmentation=None, rng=None,
               normalize=False, scale_by_max=False):
    self.target_size = image_size // downscale
    self.downscale = downscale
    self.augmentation = augmentation
    self.rng = rng if rng is not None else np.random
    self.normalize = normalize
    self.scale_by_max = scale_by_max

  def __call__(self, image, label):
    """image, label: (H, W) or (H, W, 1) → ((size, size) float32,
    (H / downscale, W / downscale) int64)."""
    if image.ndim == 2:
      image = image[:, :, None]
    if label.ndim == 2:
      label = label[:, :, None]
    image = image.astype(np.float32)
    label = label.astype(np.float32)

    if self.augmentation is not None:
      shift = self.augmentation.get('shift', 0)
      rot = self.augmentation.get('rotate', 0)
      zoom_range = self.augmentation.get('scale', (1, 1))
      if shift:
        merged = np.concatenate([image, label], axis=-1)
        merged = augment.random_translate(merged, shift, self.rng)
        image, label = merged[..., :1], merged[..., 1:]
      image, label = augment.random_rotate_pair(
          image, label, (-rot, rot), self.rng, orders=(2, 0))
      image, label = augment.random_zoom_pair(
          image, label, zoom_range, self.rng, orders=(2, 0))

    img2d = _crop_and_normalise(image[..., 0], self.target_size)
    if self.normalize:
      img2d = (img2d - img2d.mean()) / (img2d.std() + 1e-9)
    if self.scale_by_max:
      img2d = np.clip(img2d / (np.max(img2d) + 1e-9), 0, 1)
    label2d = label[::self.downscale, ::self.downscale, 0]
    return img2d.astype(np.float32), np.round(label2d).astype(np.int64)
