"""Discriminator accuracy metrics.

Port of ``csmri_refinement_tpu/metrics/scalar_metrics.py`` (tensors are
fetched to host numpy): probability maps are spatially averaged per example,
thresholded at 0.5, and compared against the fake(0)/real(1) labels.
"""

import numpy as np
import torch


def _host(x):
  if torch.is_tensor(x):
    return x.detach().float().cpu().numpy()
  return np.asarray(x)


def binary_accuracy(prediction, target):
  """Accuracy of probabilities against 0/1 targets
  (reference scalar_metrics.py:10-23)."""
  pred = _host(prediction)
  targ = _host(target)
  predicted_classes = pred > 0.5
  return float(np.mean(predicted_classes == targ.astype(bool)))


def disc_accuracy(prob_fake, prob_real, fake_accuracy=True,
                  real_accuracy=False):
  """Discriminator accuracy over fake/real prob maps
  (reference scalar_metrics.py:26-50)."""
  probs = []
  targets = []
  if fake_accuracy:
    p = _host(prob_fake)
    p = p.reshape(p.shape[0], -1).mean(axis=1)
    probs.append(p)
    targets.append(np.zeros_like(p))
  if real_accuracy:
    p = _host(prob_real)
    p = p.reshape(p.shape[0], -1).mean(axis=1)
    probs.append(p)
    targets.append(np.ones_like(p))
  if not probs:
    raise ValueError('fake_accuracy and real_accuracy can not both be false')
  return binary_accuracy(np.concatenate(probs), np.concatenate(targets))
