"""Model registry: ``construct_model(section)``.

Port of ``csmri_refinement_tpu/models/__init__.py`` for ``RecNet``,
``UNET``, ``RefinementWrapper`` and ``CNNDiscriminator``. ``section`` is a
model section of a JSON config as a plain dict (e.g. ``generator_model`` of
``configs/2-refinement.json``), read unchanged. A section's
``pretrained_weights`` is not a constructor argument: the runners load it
after the seeded init (``training/model_setup.apply_pretrained_weights``),
as the JAX runners do. A discriminator section also carries the runner's
discriminator-input keys (``input_method``, ``use_image_pool``, ...); the
model takes the keys it knows, as the JAX ``to_param_dict`` does. An
``undersampling`` section
threaded in by a runner (JAX ``training/runner.py:49-53``) gives a RecNet
its ``dc_lines_acc``, as the JAX ``models/recnet.py:50-57`` does; other
models ignore it. A UNET section's ``fused_inference`` and
``quantize_inference`` (``docs/CONFIG.md``) pass through to ``UNET``. Any
other key the ported model does not take raises ``TypeError``.
"""

import torch

MODEL_NAMES = ('RecNet', 'UNET', 'RefinementWrapper', 'CNNDiscriminator')


def torch_dtype(value):
  """A config's dtype name ('float32', 'bfloat16'), or a torch dtype, or
  None, as a torch dtype or None."""
  if value is None or isinstance(value, torch.dtype):
    return value
  return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[value]


def construct_model(section, dtype=None):
  """Build the model a config section names (weights uninitialised: call
  ``init_weights(generator)`` or load them)."""
  from csmri_refinement_tpu_torch.models import recnet
  from csmri_refinement_tpu_torch.models import refinement_wrapper
  from csmri_refinement_tpu_torch.models import unet
  from csmri_refinement_tpu_torch.models import weight_inits
  from csmri_refinement_tpu_torch.ops import dc

  params = dict(section)
  name = params.pop('name')
  if name not in MODEL_NAMES:
    raise ValueError('Unknown model {}'.format(name))
  params.pop('pretrained_weights', None)
  undersampling = params.pop('undersampling', None)
  dtype = torch_dtype(params.pop('dtype', dtype))
  if name == 'RefinementWrapper':
    pretrained = construct_model(params.pop('pretrained_model'), dtype)
    learnable = construct_model(params.pop('learnable_model'), dtype)
    return refinement_wrapper.RefinementWrapper(pretrained, learnable,
                                                **params)
  weight_init = weight_inits.normalize_user_init(
      params.pop('weight_init', None))
  if name == 'CNNDiscriminator':
    from csmri_refinement_tpu_torch.models import discriminators
    return discriminators.CNNDiscriminator(
        weight_init=weight_init, dtype=dtype,
        **{k: v for k, v in params.items()
           if k in discriminators.PARAMS})
  if name == 'RecNet':
    if 'dc_lines_acc' not in params:
      acc = dc.lines_acc_from_undersampling(undersampling)
      if acc:
        params['dc_lines_acc'] = acc
    return recnet.RecNet(weight_init=weight_init, dtype=dtype, **params)
  return unet.UNET(weight_init=weight_init, dtype=dtype, **params)


def get_input_keys(model):
  """Batch keys the model's ``forward`` takes, in order."""
  return getattr(model, 'INPUT_KEYS', ('inp',))
