"""Offline per-slice statistics over saved result datasets.

Port of ``csmri_refinement_tpu/data/statistics.py:24-137`` without pandas:
each ``compute_*`` returns an ``OrderedDict`` keyed as the JAX package's
``pd.Series`` index (``'<case>_<slice:02d>'``, in the dataset's order).
PSNR and gaussian-weighted SSIM follow skimage's ``compare_psnr`` and
``compare_ssim(gaussian_weights=True, sigma=1.5,
use_sample_covariance=False)`` with ``data_range = target.max()``, in
float64 on the host.
"""

from collections import OrderedDict

import numpy as np
import torch
from scipy.ndimage import gaussian_filter
from scipy.stats import wilcoxon

from csmri_refinement_tpu_torch.data.io_mat import (CASE_KEY, LABEL_KEY,
                                                    PRED_KEY, SLICE_KEY,
                                                    TARGET_KEY,
                                                    TARGET_LABEL_KEY,
                                                    maybe_convert_to_magnitude)


def _get_index_key(data):
  if SLICE_KEY in data:
    return '{}_{:02d}'.format(data[CASE_KEY], int(data[SLICE_KEY]))
  return data[CASE_KEY]


def psnr(target, pred, data_range):
  mse = np.mean((target.astype(np.float64) - pred.astype(np.float64)) ** 2)
  return 10.0 * np.log10((data_range ** 2) / mse)


def complex_psnr(x, y, peak='normalized'):
  """PSNR of complex arrays: ``'normalized'`` takes a unit peak, ``'max'``
  the largest |x| (JAX ``:36-45``)."""
  x = np.asarray(x)
  y = np.asarray(y)
  mse = np.mean(np.abs(x - y) ** 2)
  if peak == 'max':
    return 10.0 * np.log10(np.max(np.abs(x)) ** 2 / mse)
  return 10.0 * np.log10(1.0 / mse)


def ssim_gaussian(target, pred, data_range, sigma=1.5, truncate=3.5):
  """skimage's SSIM with gaussian weights and population covariance, the
  border of (win - 1) // 2 cropped."""
  target = target.astype(np.float64)
  pred = pred.astype(np.float64)
  win = 2 * int(truncate * sigma + 0.5) + 1

  def filt(x):
    return gaussian_filter(x, sigma, truncate=truncate)

  ux = filt(target)
  uy = filt(pred)
  vx = filt(target * target) - ux * ux
  vy = filt(pred * pred) - uy * uy
  vxy = filt(target * pred) - ux * uy
  c1 = (0.01 * data_range) ** 2
  c2 = (0.03 * data_range) ** 2
  ssim_map = ((2 * ux * uy + c1) * (2 * vxy + c2)) / \
      ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
  pad = (win - 1) // 2
  cropped = ssim_map[pad:-pad, pad:-pad] if pad else ssim_map
  return cropped.mean()


def compute_psnr(dataset):
  values = OrderedDict()
  for data in dataset:
    pred = maybe_convert_to_magnitude(data[PRED_KEY])
    target = maybe_convert_to_magnitude(data[TARGET_KEY])
    values[_get_index_key(data)] = psnr(target, pred,
                                        data_range=target.max())
  return values


def compute_ssim(dataset):
  values = OrderedDict()
  for data in dataset:
    pred = maybe_convert_to_magnitude(data[PRED_KEY]).squeeze()
    target = maybe_convert_to_magnitude(data[TARGET_KEY]).squeeze()
    values[_get_index_key(data)] = ssim_gaussian(target, pred,
                                                 data_range=target.max())
  return values


def compute_seg_score(dataset, seg_score, device='cuda'):
  """The segmentation score of each saved reconstruction against its
  ground-truth label (``seg_score``: a ``SegmentationScore``, its network
  on ``device``); a slice it skips is left out."""
  values = OrderedDict()
  for data in dataset:
    pred = np.asarray(data[PRED_KEY], np.float32)
    if pred.ndim == 3 and pred.shape[0] == 2 and pred.shape[-1] != 2:
      pred = np.transpose(pred, (1, 2, 0))  # CHW records → HWC
    if pred.shape[-1] == 1:
      pred = np.concatenate([pred, np.zeros_like(pred)], axis=-1)
    target = np.asarray(data[TARGET_LABEL_KEY]).squeeze()
    value = seg_score(torch.from_numpy(pred[None]).to(device),
                      torch.from_numpy(target[None].astype(np.int64)))[0]
    if value is not None:
      values[_get_index_key(data)] = value
  return values


def dice(prediction, target, class_idx, absent_value):
  a = (np.asarray(prediction).squeeze() == class_idx)
  b = (np.asarray(target).squeeze() == class_idx)
  denom = np.sum(a) + np.sum(b)
  if denom == 0:
    return absent_value
  return 2.0 * np.sum(a * b) / denom


def compute_dice_scores(dataset, num_classes, absent_value=0.0):
  """[('dice_class_<c>', OrderedDict of each slice's dice)] per class."""
  values_per_class = [OrderedDict() for _ in range(num_classes)]
  for data in dataset:
    index_key = _get_index_key(data)
    for class_idx in range(num_classes):
      values_per_class[class_idx][index_key] = dice(
          data[LABEL_KEY], data[TARGET_LABEL_KEY], class_idx, absent_value)
  return [('dice_class_{}'.format(c), values)
          for c, values in enumerate(values_per_class)]


def compute_wilcoxon(values1, values2):
  """The Wilcoxon signed-rank test of two paired per-slice results (arrays,
  or the ``compute_*`` OrderedDicts; JAX ``:139-140``)."""
  as_array = lambda v: np.asarray(list(v.values()) if isinstance(v, dict)
                                  else v, np.float64)
  return wilcoxon(as_array(values1), as_array(values2))
