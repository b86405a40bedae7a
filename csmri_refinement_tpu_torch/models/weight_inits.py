"""Weight initialisers of the flagship models, on ``torch.Generator``s.

Port of ``csmri_refinement_tpu/models/weight_inits.py``: init specs are
``(name, *args)`` tuples, resolved with the same precedence (framework
defaults ← model defaults ← user config), and applied in place to OIHW conv
weights, (out, in) linear weights and 1-D parameters.

Specs: ``'zero'``, ``('constant', c)``, ``('normal', mean, std)``,
``('uniform', a, b)``, ``('xavier', gain)`` (uniform) and
``('xavier_normal', gain)``, ``('he_normal', a)`` and ``('he_uniform', a)``
(a: the rectifier's negative slope), ``('orthogonal',
gain_or_nonlinearity)`` and ``'torch_default'``. Fans follow torch's (and
the JAX package's) convention: fan_in = Cin·k·k, fan_out = Cout·k·k. The
normal laws are untruncated, as the JAX package's ``variance_scaling(...,
'normal')``.

``'torch_default'`` keeps flax's default, as the JAX package's
``kernel_and_bias`` does (its ``weight_inits.py:126-137``): a weight (conv,
transposed conv, linear) takes ``lecun_normal``, a normal truncated at ±2
standard deviations and rescaled to std √(1/fan_in), drawn by the inverse
CDF of a uniform draw; a bias takes zero. The JAX package hands the spec
of its other slots (the BN scale, the discriminator's final bias) to flax
as it is, where ``'torch_default'`` resolves to None and flax fails on it:
``direct_spec`` raises there.
"""

import math

import torch

DEFAULT_INITS = {
    'conv_weight': ('he_normal', 0.0),
    'conv_bias': ('constant', 0.0),
    'conv_transposed_weight': ('he_normal', 0.0),
    'conv_transposed_bias': ('constant', 0.0),
    'batchnorm_weight': ('constant', 1.0),
    'batchnorm_bias': ('constant', 0.0),
    'linear_weight': ('xavier_normal', 'linear'),
    'linear_bias': ('constant', 0.0),
}


def calculate_gain(nonlinearity, param=None):
  """torch.nn.init.calculate_gain for the names the configs use."""
  if nonlinearity == 'linear':
    return 1.0
  if nonlinearity == 'relu':
    return math.sqrt(2.0)
  if nonlinearity == 'leaky_relu':
    slope = 0.01 if param is None else param
    return math.sqrt(2.0 / (1 + slope ** 2))
  if nonlinearity == 'tanh':
    return 5.0 / 3
  raise ValueError('Unknown nonlinearity {}'.format(nonlinearity))


def _fans(shape):
  receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
  fan_in = shape[1] * receptive if len(shape) > 1 else shape[0]
  return fan_in, shape[0] * receptive


def _gain(spec):
  gain = spec[1] if len(spec) > 1 else 1.0
  if isinstance(gain, str):
    gain = calculate_gain(gain, spec[2] if len(spec) > 2 else None)
  return gain


def _orthogonal(shape, gain, generator):
  """flax ``orthogonal(column_axis=-1)`` on the flax view of a torch
  weight (HWIO for OIHW, (in, out) for a linear (out, in)): the
  (k·k·Cin, Cout) matrix has orthonormal columns (or rows, when it is
  wide), times ``gain``."""
  if len(shape) not in (2, 4):
    raise NotImplementedError('orthogonal init takes conv and linear '
                              'weights')
  cout, cin, kernel = shape[0], shape[1], tuple(shape[2:])
  rows = cin * math.prod(kernel)
  mshape = (cout, rows) if rows < cout else (rows, cout)
  a = torch.randn(mshape, generator=generator, dtype=torch.float64)
  q, r = torch.linalg.qr(a)
  q = q * torch.sign(torch.diagonal(r))
  if rows < cout:
    q = q.T
  flax_view = (q * gain).reshape(kernel + (cin, cout))
  return flax_view.permute(3, 2, 0, 1) if kernel else flax_view.T


# flax's truncated_normal: the std of a standard normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def _truncated_normal(shape, std, generator):
  """``std`` times a standard normal truncated to [-2, 2] (f64): the
  inverse CDF of a uniform draw between the bounds' CDFs."""
  lo, hi = torch.special.ndtr(torch.tensor([-2.0, 2.0], dtype=torch.float64))
  u = torch.rand(shape, generator=generator, dtype=torch.float64)
  return std * torch.special.ndtri(lo + (hi - lo) * u)


def direct_spec(spec, slot):
  """``spec`` of a slot whose initializer the JAX package passes to flax
  unresolved; ``'torch_default'`` fails there (flax calls None), so here it
  raises, naming ``slot``."""
  name = spec[0] if isinstance(spec, (tuple, list)) else spec
  if name == 'torch_default':
    raise ValueError("weight init 'torch_default' has no law for {}: the "
                     'JAX package passes None to flax there, which fails'
                     .format(slot))
  return spec


def init_(tensor, spec, generator):
  """Fill ``tensor`` in place from an init spec, drawing from
  ``generator``."""
  spec = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
  name = spec[0]
  shape = tuple(tensor.shape)
  def normal(std, mean=0.0):
    return tensor.copy_(mean + std * torch.randn(
        shape, generator=generator, dtype=torch.float64))

  def uniform(limit):
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return tensor.copy_((2 * u - 1) * limit)

  with torch.no_grad():
    if name == 'zero':
      return tensor.zero_()
    if name == 'constant':
      return tensor.fill_(spec[1])
    if name == 'normal':
      return normal(spec[2], spec[1])
    if name == 'uniform':
      u = torch.rand(shape, generator=generator, dtype=torch.float64)
      return tensor.copy_(spec[1] + (spec[2] - spec[1]) * u)
    if name in ('xavier', 'xavier_normal'):
      fan_in, fan_out = _fans(shape)
      std = _gain(spec) * math.sqrt(2.0 / (fan_in + fan_out))
      return normal(std) if name == 'xavier_normal' else \
          uniform(std * math.sqrt(3.0))
    if name in ('he_normal', 'he_uniform'):
      a = spec[1] if len(spec) > 1 else 0.0
      std = math.sqrt(2.0 / (1 + a ** 2)) / math.sqrt(_fans(shape)[0])
      return normal(std) if name == 'he_normal' else \
          uniform(std * math.sqrt(3.0))
    if name == 'orthogonal':
      return tensor.copy_(_orthogonal(shape, _gain(spec), generator))
    if name == 'torch_default':     # flax's lecun_normal weight, zero bias
      if len(shape) < 2:
        return tensor.zero_()
      std = math.sqrt(1.0 / _fans(shape)[0]) / _TRUNCATED_STD
      return tensor.copy_(_truncated_normal(shape, std, generator))
  raise ValueError('Unknown weight init {}'.format(name))


def resolve_inits(model_defaults=None, user_overrides=None):
  """Merge framework defaults ← model defaults ← user config."""
  params = dict(DEFAULT_INITS)
  params.update(model_defaults or {})
  params.update(user_overrides or {})
  return params


def normalize_user_init(user_weight_init):
  """Accept JSON-config init lists (e.g. ["orthogonal", "relu"]) as
  tuples."""
  return {key: tuple(spec) if isinstance(spec, list) else spec
          for key, spec in (user_weight_init or {}).items()}
