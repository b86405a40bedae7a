"""Tensor transforms on NHWC tensors.

Port of ``csmri_refinement_tpu/utils/tensor_transforms.py:15-83``: range
normalization and scaling, per-example min-max scaling and
standardization, complex magnitude, one-hot encoding, and a tensor-stats
debug printer. Tensors are NHWC as in the JAX package (the port's batches,
``inp``, ``kspace``, ``target`` and the models' outputs, are NHWC too); the
complex magnitude is ``ops/fft.py::complex_abs`` on a packed (..., 2)
tensor.
"""

import logging

import numpy as np
import torch

from csmri_refinement_tpu_torch.ops.fft import complex_abs


def normalize_range(tensor, source_range, clamp=True):
  """Scale from ``source_range`` to (0, 1); clamps to ``source_range`` as
  the JAX function does."""
  tensor = (tensor - source_range[0]) / (source_range[1] - source_range[0])
  if clamp:
    tensor = torch.clamp(tensor, source_range[0], source_range[1])
  return tensor


def scale_to_range(tensor, target_range, clamp=True):
  """Scale from (0, 1) to ``target_range``."""
  tensor = tensor * (target_range[1] - target_range[0]) + target_range[0]
  if clamp:
    tensor = torch.clamp(tensor, target_range[0], target_range[1])
  return tensor


def scale_batch_per_example(tensor):
  """Min-max scale each example and channel of (B, H, W, C) to (0, 1)."""
  b, h, w, c = tensor.shape
  flat = tensor.reshape(b, h * w, c)
  flat = flat - flat.amin(dim=1, keepdim=True)
  flat = flat / flat.amax(dim=1, keepdim=True)
  return torch.clamp(flat, 0.0, 1.0).reshape(b, h, w, c)


def normalize_batch_per_example(tensor, normalize_mean=True,
                                normalize_std=True):
  """Standardize each example and channel of (B, H, W, C) (population
  std, as ``jnp.std``)."""
  b, h, w, c = tensor.shape
  flat = tensor.reshape(b, h * w, c)
  if normalize_mean:
    flat = flat - flat.mean(dim=1, keepdim=True)
  if normalize_std:
    flat = flat / flat.std(dim=1, keepdim=True, correction=0)
  return flat.reshape(b, h, w, c)


def magnitude_image(tensor):
  """(B, H, W, 2) → (B, H, W, 1): the magnitude, min-max scaled per
  image to (0, 1)."""
  return scale_batch_per_example(complex_abs(tensor))


def convert_to_one_hot(tensor, num_classes=None):
  """Dense labels → float one-hot with a trailing class axis."""
  if num_classes is None:
    num_classes = int(tensor.max()) + 1
  return torch.nn.functional.one_hot(tensor.long(), num_classes).float()


def print_tensor_stats(t, prefix='', debug=False):
  """Log min, max, mean, std and median of a tensor."""
  t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
      np.asarray(t)
  s = ('{}: Min: {:.9f}, Max: {:.9f}, Avg: {:.9f}, Std: {:.9f}, '
       'Median: {:.9f}').format(prefix, float(t.min()), float(t.max()),
                                float(t.mean()), float(t.std()),
                                float(np.median(t)))
  (logging.debug if debug else logging.info)(s)
