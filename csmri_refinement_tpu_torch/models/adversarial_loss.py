"""Adversarial losses: GAN (BCE), LSGAN, WGAN and feature matching.

Port of ``csmri_refinement_tpu/models/adversarial_loss.py``: each loss
takes the discriminator's outputs ``{prob, logits[, features]}`` on fakes
and reals. ``loss_type`` 'gen' is the generator's objective, 'disc' the
discriminator's (with label smoothing of the real label). The real
features of feature matching are detached; under a spatial mesh a feature
map whose rows the ranks hold unequally (its layout in the
discriminator's ``feature_rows``) is averaged as S times the rank's share
(``halo.mean``).
"""

import torch

from csmri_refinement_tpu_torch.parallel import halo

_EPS = 1e-7


def _bce(probs, labels):
  probs = torch.clamp(probs, _EPS, 1.0 - _EPS)
  return -torch.mean(labels * torch.log(probs) +
                     (1.0 - labels) * torch.log(1.0 - probs))


def _check_type(loss_type):
  if loss_type not in ('gen', 'disc'):
    raise ValueError('loss_type must be gen or disc, got {}'.format(
        loss_type))


class GANLoss:
  """Non-saturating BCE on probabilities."""

  def __init__(self, loss_type, disc_label_smoothing=0.0):
    _check_type(loss_type)
    if not 0.0 <= disc_label_smoothing < 1.0:
      raise ValueError('label smoothing must lie in [0, 1)')
    self.loss_type = loss_type
    self.disc_real_label = 1.0 - disc_label_smoothing

  def __call__(self, out_disc_fake, out_disc_real):
    fake = out_disc_fake['prob']
    if self.loss_type == 'gen':
      return _bce(fake, torch.ones_like(fake))
    real = out_disc_real['prob']
    return _bce(fake, torch.zeros_like(fake)) + \
        _bce(real, torch.full_like(real, self.disc_real_label))


class LeastSquaresLoss:
  """LSGAN: MSE on logits."""

  def __init__(self, loss_type, disc_label_smoothing=0.0):
    _check_type(loss_type)
    self.loss_type = loss_type
    self.disc_real_label = 1.0 - disc_label_smoothing

  def __call__(self, out_disc_fake, out_disc_real):
    if self.loss_type == 'gen':
      return torch.mean((out_disc_fake['logits'] - 1.0) ** 2)
    return torch.mean(out_disc_fake['logits'] ** 2) + torch.mean(
        (out_disc_real['logits'] - self.disc_real_label) ** 2)


class WGANLoss:
  """Wasserstein loss on logits."""

  def __init__(self, loss_type):
    _check_type(loss_type)
    self.loss_type = loss_type

  def __call__(self, out_disc_fake, out_disc_real):
    if self.loss_type == 'gen':
      return -torch.mean(out_disc_fake['logits'])
    return torch.mean(out_disc_fake['logits']) - \
        torch.mean(out_disc_real['logits'])


class FeatureMatchingLoss:
  """Mean distance between the fakes' and the (detached) reals'
  discriminator features; negated for the discriminator."""

  # (features a, b, their NHWC row layout or None) → the mean distance
  DISTANCES = {
      'MSE': lambda a, b, rows: halo.mean((a - b) ** 2, rows, 1),
      'L1': lambda a, b, rows: halo.mean(torch.abs(a - b), rows, 1),
  }

  def __init__(self, loss_type, distance_fn='L1'):
    _check_type(loss_type)
    if distance_fn not in self.DISTANCES:
      raise ValueError('Unknown distance function {}'.format(distance_fn))
    self.loss_type = loss_type
    self.distance_fn = self.DISTANCES[distance_fn]

  def __call__(self, out_disc_fake, out_disc_real):
    features_fake = out_disc_fake['features']
    layouts = out_disc_fake.get('feature_rows', [None] * len(features_fake))
    loss = 0.0
    for f_fake, f_real, rows in zip(features_fake, out_disc_real['features'],
                                    layouts):
      loss = loss + self.distance_fn(f_fake, f_real.detach(), rows)
    loss = loss / len(features_fake)
    return -loss if self.loss_type == 'disc' else loss


def get_adversarial_loss(conf, loss_name, loss_type):
  """The adversarial loss a config names."""
  smoothing = conf.get_attr('discriminator_label_smoothing', default=0.0)
  upper = loss_name.upper()
  if upper == 'GAN':
    return GANLoss(loss_type, smoothing)
  if upper == 'LSGAN':
    return LeastSquaresLoss(loss_type, smoothing)
  if upper == 'WGAN':
    return WGANLoss(loss_type)
  if loss_name in ('FeatureMatching', 'feature-matching'):
    return FeatureMatchingLoss(loss_type, conf.get_attr(
        'feature_matching_loss_distance_function', default='L1'))
  raise ValueError('Unknown loss {}'.format(loss_name))
