"""The discriminator's input.

Port of ``csmri_refinement_tpu/training/adversarial_training.py``: maps a
prediction (or the target) to the discriminator's input with the methods
``simple`` and ``simple-magnitude`` (packed complex → magnitude,
``ops/fft.complex_abs``: gradient 0 at an exact zero) and optional
per-example mean/std normalisation. A detached input goes through the image
pool when it is a fake (or any input with ``image_pool_label_swapping``);
in a data-parallel run the pool sees the global batch (the rank's rows
gathered in rank order, queried, the rank's rows kept). Under a spatial
mesh each rank's pool stores its image rows of the global batch's images,
with the decisions every rank draws alike; the per-example normalisation
takes the whole image's statistics (sums over the spatial group, the
count of its elements among them).

``strip_bg_class`` drops channel 0 (the background class) of the
prediction first. The conditional-input keys are taken as the JAX package
takes them (``:58-125``): ``conditional_input_source`` must be ``'input'``
or ``'generator'``, and it, ``conditional_input_generator_key`` and
``scale_input_zero_one`` change no input of the two methods, which do not
consume the conditional input (JAX computes it and drops it, ``:89``).
"""

import torch

from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.parallel import halo
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib

DEFAULT_INPUT_METHOD = 'simple'


def _normalize_per_example(x):
  """Zero mean, unit (population) std per example and channel."""
  b, h, w, c = x.shape
  flat = x.reshape(b, h * w, c)
  mesh = halo.current()
  if mesh is None:
    flat = flat - flat.mean(dim=1, keepdim=True)
    std = flat.std(dim=1, keepdim=True, correction=0)
  else:
    count = flat.new_full((b, 1, c), h * w)
    stats = halo.sum_rows(torch.cat([flat.sum(1, keepdim=True), count], 1),
                          mesh)
    n = stats[:, 1:]
    flat = flat - stats[:, :1] / n
    std = torch.sqrt(halo.sum_rows((flat * flat).sum(1, keepdim=True),
                                   mesh) / n)
  flat = flat / (std + 1e-12)
  return flat.reshape(b, h, w, c)


class DiscriminatorInputFn:
  """``fn(prediction_or_target, is_real_input, detach, pool=None,
  generator=None, mesh=None)`` → the discriminator's input."""

  def __init__(self, method, normalize=False, use_pool=False,
               pool_sample_prob=0.5, pool_label_swapping=False,
               strip_bg_class=False, cond_input_source='input',
               cond_input_gen_key=None, scale_input_to_zero_one=False):
    if method not in ('simple', 'simple-magnitude'):
      raise ValueError('Unknown discriminator input method {}'.format(method))
    if cond_input_source not in ('input', 'generator'):
      raise ValueError('Unknown conditional input source {!r}'.format(
          cond_input_source))
    self.method = method
    self.strip_bg_class = strip_bg_class
    self.cond_input_source = cond_input_source
    self.cond_input_gen_key = cond_input_gen_key
    self.scale_input_to_zero_one = scale_input_to_zero_one
    self.normalize = normalize
    self.use_pool = use_pool
    self.pool_sample_prob = pool_sample_prob
    self.pool_label_swapping = pool_label_swapping

  def build(self, prediction_or_target):
    prediction = prediction_or_target['pred'] \
        if isinstance(prediction_or_target, dict) else prediction_or_target
    if self.strip_bg_class:
      prediction = prediction[..., 1:]
    if self.method == 'simple-magnitude':
      prediction = fft.complex_abs(prediction)
    if self.normalize:
      prediction = _normalize_per_example(prediction)
    return prediction

  def __call__(self, prediction_or_target, is_real_input, detach, pool=None,
               generator=None, mesh=None):
    disc_input = self.build(prediction_or_target)
    if detach:
      disc_input = disc_input.detach()
      if self.use_pool and pool is not None and \
          (not is_real_input or self.pool_label_swapping):
        queried = pool.query(
            mesh_lib.gather_to_replicated(disc_input, mesh, rows=False),
            generator, self.pool_sample_prob)
        disc_input = mesh_lib.shard_batch(queried, mesh, rows=False)
    return disc_input


def get_discriminator_input_fn(disc_conf, no_pool=False):
  """From a discriminator section (a dict)."""
  return DiscriminatorInputFn(
      method=disc_conf.get('input_method', DEFAULT_INPUT_METHOD),
      normalize=disc_conf.get('normalize_input', False),
      use_pool=disc_conf.get('use_image_pool', False) and not no_pool,
      pool_sample_prob=disc_conf.get('image_pool_sample_prob', 0.5),
      pool_label_swapping=disc_conf.get('image_pool_label_swapping', False),
      strip_bg_class=disc_conf.get('strip_bg_class', False),
      cond_input_source=disc_conf.get('conditional_input_source', 'input'),
      cond_input_gen_key=disc_conf.get('conditional_input_generator_key'),
      scale_input_to_zero_one=disc_conf.get('scale_input_zero_one', False))
