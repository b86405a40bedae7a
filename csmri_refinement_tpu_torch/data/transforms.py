"""Host-side per-item transforms feeding the device pipeline.

Port of ``RecHostTransform``, ``RecSegHostTransform`` and
``center_crop_in_kspace_np`` (``csmri_refinement_tpu/data/transforms.py``)
without augmentation: the host emits clean ground-truth slices in (0, 1)
(and, for segmentation, their label maps); undersampling runs on the device
in the train/val step (``training/prep.py``). Augmentation and the
segmentation input options ``normalize``/``scale_by_max``, which no dataset
of the JAX package sets, wait for the data-pipeline slice (ROADMAP Queue 1).
"""

import numpy as np


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


class RecHostTransform:
  """GT slice prep for reconstruction: k-space crop → normalise."""

  def __init__(self, image_size, downscale=1):
    self.target_size = image_size // downscale

  def __call__(self, image):
    """image: (H, W) or (H, W, 1) raw slice → (size, size) float32 in (0,1)."""
    img2d = image.astype(np.float32)
    if img2d.ndim == 3:
      img2d = img2d[..., 0]
    if img2d.shape[0] != self.target_size or \
       img2d.shape[1] != self.target_size:
      img2d = center_crop_in_kspace_np(img2d, self.target_size)
    else:
      img2d = np.abs(img2d)
    peak = np.max(np.abs(img2d))
    if peak > 0:
      img2d = img2d / peak
    return img2d.astype(np.float32)


class RecSegHostTransform:
  """Joint image + label prep for segmentation: the image as
  ``RecHostTransform`` makes it, the label subsampled by ``downscale`` and
  rounded to int64."""

  def __init__(self, image_size, downscale=1):
    self.image = RecHostTransform(image_size, downscale)
    self.downscale = downscale

  def __call__(self, image, label):
    """image, label: (H, W) or (H, W, 1) → ((size, size) float32,
    (H / downscale, W / downscale) int64)."""
    if label.ndim == 3:
      label = label[..., 0]
    label = label.astype(np.float32)[::self.downscale, ::self.downscale]
    return self.image(image), np.round(label).astype(np.int64)
