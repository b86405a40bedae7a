"""Dice metrics over dense class maps.

Port of ``csmri_refinement_tpu/metrics/segmentation_metrics.py`` on
tensors (which may stay on the device): the counts are taken where the
maps lie and fetched once, and the score is formed from them in float64
as the JAX package forms it in numpy. A class missing from both prediction
and target counts as ``absent_value`` (0.0 by ACDC convention; the
segmentation score uses 1.0).
"""

import torch


def dice_counts(prediction, target, class_idx):
  """(|pred ∧ target|, |pred| + |target|) of ``class_idx`` per leading
  index: (N, 2) int64 for maps of shape (N, ...)."""
  pred = (prediction == class_idx).flatten(1)
  targ = (target == class_idx).flatten(1)
  return torch.stack([(pred & targ).sum(1), pred.sum(1) + targ.sum(1)], 1)


def dice_from_counts(intersection, denominator, absent_value=0.0):
  if denominator == 0:
    return float(absent_value)
  return 2.0 * intersection / denominator


def compute_dice(prediction, target, class_idx, absent_value=0.0):
  """Dice score of one class between dense segmentation maps."""
  counts = dice_counts(prediction.reshape(1, -1), target.reshape(1, -1),
                       class_idx)
  return dice_from_counts(*counts[0].tolist(), absent_value)


def compute_average_dice(prediction, target, num_classes, excluded_class=-1,
                         absent_value=0.0):
  """Average dice over classes, optionally excluding one (background)."""
  classes = [c for c in range(num_classes) if c != excluded_class]
  counts = torch.cat([dice_counts(prediction.reshape(1, -1),
                                  target.reshape(1, -1), c)
                      for c in classes]).tolist()
  return sum(dice_from_counts(i, d, absent_value)
             for i, d in counts) / len(classes)
