"""The discriminator's input.

Port of ``csmri_refinement_tpu/training/adversarial_training.py``: maps a
prediction (or the target) to the discriminator's input with the methods
``simple`` and ``simple-magnitude`` (packed complex → magnitude,
``ops/fft.complex_abs``: gradient 0 at an exact zero) and optional
per-example mean/std normalisation. A detached input goes through the image
pool when it is a fake (or any input with ``image_pool_label_swapping``).
The reference's conditional-input and background-stripping keys change no
input of these methods and are refused.
"""

import torch

from csmri_refinement_tpu_torch.ops import fft

DEFAULT_INPUT_METHOD = 'simple'
UNSUPPORTED_KEYS = ('conditional_input_source',
                    'conditional_input_generator_key', 'strip_bg_class',
                    'scale_input_zero_one')


def _normalize_per_example(x):
  """Zero mean, unit (population) std per example and channel."""
  b, h, w, c = x.shape
  flat = x.reshape(b, h * w, c)
  flat = flat - flat.mean(dim=1, keepdim=True)
  flat = flat / (flat.std(dim=1, keepdim=True, correction=0) + 1e-12)
  return flat.reshape(b, h, w, c)


class DiscriminatorInputFn:
  """``fn(prediction_or_target, is_real_input, detach, pool=None,
  generator=None)`` → the discriminator's input."""

  def __init__(self, method, normalize=False, use_pool=False,
               pool_sample_prob=0.5, pool_label_swapping=False):
    if method not in ('simple', 'simple-magnitude'):
      raise ValueError('Unknown discriminator input method {}'.format(method))
    self.method = method
    self.normalize = normalize
    self.use_pool = use_pool
    self.pool_sample_prob = pool_sample_prob
    self.pool_label_swapping = pool_label_swapping

  def build(self, prediction_or_target):
    prediction = prediction_or_target['pred'] \
        if isinstance(prediction_or_target, dict) else prediction_or_target
    if self.method == 'simple-magnitude':
      prediction = fft.complex_abs(prediction)
    if self.normalize:
      prediction = _normalize_per_example(prediction)
    return prediction

  def __call__(self, prediction_or_target, is_real_input, detach, pool=None,
               generator=None):
    disc_input = self.build(prediction_or_target)
    if detach:
      disc_input = disc_input.detach()
      if self.use_pool and pool is not None and \
          (not is_real_input or self.pool_label_swapping):
        disc_input = pool.query(disc_input, generator, self.pool_sample_prob)
    return disc_input


def get_discriminator_input_fn(disc_conf, no_pool=False):
  """From a discriminator section (a dict)."""
  unsupported = [k for k in UNSUPPORTED_KEYS if k in disc_conf]
  if unsupported:
    raise NotImplementedError(
        'discriminator_model keys {} are not supported'.format(unsupported))
  return DiscriminatorInputFn(
      method=disc_conf.get('input_method', DEFAULT_INPUT_METHOD),
      normalize=disc_conf.get('normalize_input', False),
      use_pool=disc_conf.get('use_image_pool', False) and not no_pool,
      pool_sample_prob=disc_conf.get('image_pool_sample_prob', 0.5),
      pool_label_swapping=disc_conf.get('image_pool_label_swapping', False))
