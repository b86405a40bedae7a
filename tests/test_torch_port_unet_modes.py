"""The U-Net's last ported options against the JAX package, on the
CPU: the ``bilinear`` and ``nn-biresize-conv`` up-sampling modes,
``use_refinement``, ``encoder_features`` and the ``torch_default`` weight
init.

The same seeded numpy inputs and flax variables (built from
``jax.eval_shape``, carried across by ``utils/jax_weights.py``) go through
the jitted JAX modules and the port's. Bars, with their reasons:

* ``_bilinear_up2`` against ``jax.image.resize(..., 'bilinear')``, forward
  and VJP, within 1e-6: the same two-tap weights (0.75, 0.25), summed in
  another order (~1 ulp);
* narrow U-Nets (encoders [8, 16, 32], decoders [16, 8]; k3 and k4; zero
  and reflection padding; ``decoder_act_upsampling_only`` on and off) in
  both modes: the eval forward within 5e-4 (the JAX suite's U-Net bar,
  ``tests/test_conv_pallas.py:130``); the train-mode forward and every
  parameter's gradient of a seeded scalar of it within 1e-3 of that
  tensor's max |ref| (BN over the batch and the backward add rounding);
* one ``quantize_inference`` U-Net in ``bilinear`` at
  ``tests/test_torch_port_quant.py``'s bar (2e-2 of max |ref|, nearer the
  JAX int8 output than the float one);
* ``use_refinement`` with ``encoder_features`` [0, -1]: JAX's dict keys,
  ``pred`` and each feature within 5e-4;
* ``torch_default``: the port's draw against a flax ``lecun_normal`` sample
  of a 256×256×3×3 kernel (std within 3%, no |w| above the truncation
  2/0.8796·√(1/fan_in)), every weight slot of a U-Net within that bound
  with zero biases, as JAX's init; in the slots the JAX package hands to
  flax unresolved, the port raises ``ValueError`` where JAX fails and
  builds where JAX does.
"""

import copy
import functools
import os
import sys
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.models import discriminators as jdisc
from csmri_refinement_tpu.models import unet as junet
from csmri_refinement_tpu.models import weight_inits as jinits
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import unet as tunet
from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.ops import quantize as tquant
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_quant as quant_tests  # noqa: E402

torch.set_num_threads(1)

UP_ATOL = 1e-6
UNET_ATOL = 5e-4
TRAIN_REL = 1e-3
SIZE, BATCH = 18, 2      # 18 → 9 → 4: the decoders pad 8 rows to 9
NARROW = dict(num_inputs=2, num_outputs=2, num_layers_per_scale=2,
              encode_filters=[8, 16, 32], decode_filters=[16, 8],
              output_activation='none')
# mode, k, padding, decoder_act_upsampling_only: each value of each
# option in both modes
MODE_CASES = {
    'bilinear k3 zero': ('bilinear', 3, 'zero', False),
    'bilinear k4 reflection act': ('bilinear', 4, 'reflection', True),
    'nn-biresize-conv k3 reflection act': ('nn-biresize-conv', 3,
                                           'reflection', True),
    'nn-biresize-conv k4 zero': ('nn-biresize-conv', 4, 'zero', False),
}
TRUNCATION = 2.0 / 0.87962566103423978     # |w| · √fan_in at most


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
  return torch.from_numpy(np.array(a))


def _random_variables(init, *args, seed=0):
  """A flax variable tree of ``init``'s shapes (traced, not compiled) with
  seeded values: kernels at a 1/fan_in variance, biases, BN scales and
  running statistics off their inits."""
  rng = np.random.RandomState(seed)

  def fill(path, leaf):
    name, shape = path[-1].key, leaf.shape
    if name == 'kernel':
      value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ('scale', 'var'):
      value = rng.uniform(0.5, 1.5, shape)
    else:
      value = 0.2 * rng.randn(*shape)
    return jnp.asarray(value, jnp.float32)
  shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
  return jax.tree_util.tree_map_with_path(fill, shapes)


def _rel(got, want):
  want = np.asarray(want, np.float64)
  return np.abs(np.asarray(got, np.float64) - want).max() / \
      (np.abs(want).max() or 1.0)


# -- the bilinear up-sample ---------------------------------------------------


@pytest.mark.parametrize('shape', [(2, 4, 6, 3), (2, 5, 7, 3), (1, 1, 3, 2)],
                         ids=['even', 'odd', 'one_row'])
def test_bilinear_up2_matches_jax_image_resize(shape):
  """Forward and VJP of the stencil against ``jax.image.resize``, borders
  included; the port's never calls ``F.interpolate``."""
  rng = np.random.RandomState(sum(shape))
  x = rng.randn(*shape).astype(np.float32)
  b, h, w, c = shape
  cot = rng.randn(b, 2 * h, 2 * w, c).astype(np.float32)
  want, vjp = jax.vjp(junet._bilinear_up2, jnp.asarray(x))
  want_grad, = vjp(jnp.asarray(cot))
  xt = _t(x).requires_grad_()
  with mock.patch.object(torch.nn.functional, 'interpolate') as interpolate:
    got = tunet._bilinear_up2(xt)
  interpolate.assert_not_called()
  got.backward(_t(cot))
  assert got.shape == want.shape == (b, 2 * h, 2 * w, c)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=UP_ATOL)
  np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                             atol=UP_ATOL)


# -- U-Nets in the two modes --------------------------------------------------


def _section(case, **extra):
  mode, k, padding, act_only = MODE_CASES[case]
  return dict(NARROW, upsampling_mode=mode, kernel_size=k, padding=padding,
              decoder_act_upsampling_only=act_only, **extra)


@functools.lru_cache(maxsize=None)
def _mode_case(case):
  """(port, variables, input, cotangent, JAX eval output, JAX train output,
  JAX parameter gradients of sum(train output · cotangent))."""
  section = _section(case)
  rng = np.random.RandomState(len(case))
  x = rng.randn(BATCH, SIZE, SIZE, 2).astype(np.float32)
  cot = rng.randn(BATCH, SIZE, SIZE, 2).astype(np.float32)
  jmodel = junet.UNET(**section)
  variables = _random_variables(jmodel.init, x, seed=len(case) + 1)

  def run(v, x, cot):
    def train_loss(params):
      out, _ = jmodel.apply({'params': params,
                             'batch_stats': v['batch_stats']}, x,
                            train=True, mutable=['batch_stats'])
      return jnp.sum(out * cot), out
    grads, train_out = jax.grad(train_loss, has_aux=True)(v['params'])
    return jmodel.apply(v, x, train=False), train_out, grads
  want = jax.jit(run)(variables, jnp.asarray(x), jnp.asarray(cot))
  port = construct_model(dict(section, name='UNET'))
  load_flax_variables(port, _np(variables))
  return (port, _np(variables), x, cot) + tuple(_np(w) for w in want)


@pytest.mark.parametrize('case', sorted(MODE_CASES))
def test_unet_mode_eval_matches_jax(case):
  port, _, x, _, want, _, _ = _mode_case(case)
  with torch.no_grad():
    got = copy.deepcopy(port).eval()(_t(x))
  assert got.shape == want.shape == (BATCH, SIZE, SIZE, 2)
  np.testing.assert_allclose(got.numpy(), want, atol=UNET_ATOL)


@pytest.mark.parametrize('case', sorted(MODE_CASES))
def test_unet_mode_train_and_gradients_match_jax(case):
  port, variables, x, cot, _, want, grads = _mode_case(case)
  port = copy.deepcopy(port).train()
  got = port(_t(x))
  assert _rel(got.detach().numpy(), want) <= TRAIN_REL
  (got * _t(cot)).sum().backward()
  # the JAX gradients in the port's layout, through the weight bridge
  ref = copy.deepcopy(port)
  load_flax_variables(ref, {'params': grads,
                            'batch_stats': variables['batch_stats']})
  want_grads = dict(ref.named_parameters())
  names = [n for n, _ in port.named_parameters()]
  assert names and sorted(names) == sorted(want_grads)
  for name, p in port.named_parameters():
    assert _rel(p.grad.numpy(), want_grads[name].detach().numpy()) <= \
        TRAIN_REL, name


def test_unet_bilinear_int8_matches_jax():
  """The int8 serving mode with bilinear decoders, held as
  ``tests/test_torch_port_quant.py::test_unet_int8_matches_jax`` holds
  nn-resize-conv."""
  kw = dict(quant_tests.UNET_INT8_CASES['jax_suite'],
            upsampling_mode='bilinear')
  x = np.random.RandomState(4).randn(2, 64, 64, 2).astype(np.float32)
  variables, want, jax_inputs = quant_tests.jax_unet_int8(kw, 0, x)
  port = tunet.UNET(quantize_inference=True, **kw)
  load_flax_variables(port, _np(variables))
  port.eval()
  tquant.reset_trace_log()
  got, own_inputs = quant_tests.port_unet_int8(port, x)
  with torch.no_grad():
    ref = tunet.UNET(**kw)
    ref.load_state_dict(port.state_dict())
    f32 = ref.eval()(_t(x)).numpy()
  assert any(q > 0 for _, q in tquant._TRACE_LOG)
  scale = np.abs(want).max()
  err = np.abs(got - want).max()
  assert err <= 2e-2 * scale
  assert err < np.abs(got - f32).max()
  assert len(own_inputs) == len(jax_inputs) > 0
  pinned, _ = quant_tests.port_unet_int8(port, x, jax_inputs)
  assert np.abs(pinned - want).max() <= 1e-5 * scale


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_refinement_and_encoder_features_match_jax(train):
  """``use_refinement`` adds the input; ``encoder_features`` [0, -1]
  returns the first scale's pre-pool features and the last encoder's
  output beside ``pred``."""
  section = dict(NARROW, upsampling_mode='nn-biresize-conv',
                 use_refinement=True, encoder_features=[0, -1])
  x = np.random.RandomState(8).randn(BATCH, 16, 16, 2).astype(np.float32)
  jmodel = junet.UNET(**section)
  variables = _random_variables(jmodel.init, x, seed=9)
  want = jax.jit(lambda v, x: jmodel.apply(v, x, train=train,
                                           mutable=['batch_stats'])[0])(
                                               variables, jnp.asarray(x))
  port = construct_model(dict(section, name='UNET'))
  load_flax_variables(port, _np(variables))
  with torch.no_grad():
    got = port.train(train)(_t(x))
  assert isinstance(got, dict) and sorted(got) == sorted(want)
  np.testing.assert_allclose(got['pred'].numpy(), np.asarray(want['pred']),
                             atol=UNET_ATOL)
  assert len(got['features']) == len(want['features']) == 2
  shapes = [(BATCH, 16, 16, 8), (BATCH, 4, 4, 32)]
  for g, w, shape in zip(got['features'], want['features'], shapes):
    assert g.shape == w.shape == shape
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=UNET_ATOL)
  plain = construct_model(dict(section, name='UNET', use_refinement=False,
                               encoder_features=None))
  plain.load_state_dict(port.state_dict())
  with torch.no_grad():
    base = plain.train(train)(_t(x))
  np.testing.assert_allclose(got['pred'].numpy(), (base + _t(x)).numpy(),
                             atol=1e-6)


# -- torch_default ------------------------------------------------------------


def test_torch_default_law_matches_flax_lecun_normal():
  """A 256×256×3×3 conv weight: the port's truncated draw against flax's
  ``lecun_normal`` sample, with zero for a bias."""
  weight = torch.empty(256, 256, 3, 3)
  weight_inits.init_(weight, 'torch_default', torch.Generator().manual_seed(0))
  want = np.asarray(fnn.initializers.lecun_normal()(
      jax.random.PRNGKey(0), (3, 3, 256, 256)))
  std = np.sqrt(1.0 / (256 * 9))
  got = weight.numpy()
  assert abs(got.std() / want.std() - 1) < 0.03
  assert abs(got.std() / std - 1) < 0.03
  assert abs(got.mean()) < 0.01 * std
  for sample in (got, want):
    assert np.abs(sample).max() <= TRUNCATION * std * (1 + 1e-6)
    # the law reaches its bound: the truncation is at ±2 of its normal
    assert np.abs(sample).max() > 0.98 * TRUNCATION * std
  bias = torch.ones(256)
  weight_inits.init_(bias, ('torch_default',), None)
  assert not bias.any()


@pytest.mark.parametrize('mode', ['nn-biresize-conv', 'transposed'])
def test_torch_default_weights_of_a_unet(mode):
  """Every conv, transposed-conv and head weight drawn within the
  truncation of its flax kernel's fan_in, every bias zero: the slots the
  JAX package fills through ``kernel_and_bias``."""
  section = dict(NARROW, name='UNET', upsampling_mode=mode, use_bn=False,
                 transposed_kernel_size=3,
                 weight_init={'conv_weight': 'torch_default',
                              'conv_bias': 'torch_default',
                              'conv_transposed_weight': 'torch_default'})
  port = construct_model(section)
  port.init_weights(torch.Generator().manual_seed(0))
  layers = 0
  for name, module in port.named_modules():
    if isinstance(module, torch.nn.ConvTranspose2d):    # (Cin, Cout, k, k)
      fan_in = module.weight.shape[0] * module.weight.shape[2] ** 2
    elif isinstance(module, torch.nn.Conv2d):
      fan_in = int(np.prod(module.weight.shape[1:]))
    else:
      continue
    layers += 1
    w = module.weight.detach().numpy()
    assert np.abs(w).max() <= TRUNCATION / np.sqrt(fan_in) * (1 + 1e-6), name
    assert w.std() > 0.5 / np.sqrt(fan_in), name
    assert module.bias is None or not module.bias.any(), name
  assert layers == 3 * 2 + 2 * (2 + 1) + 1


DIRECT_CASES = {
    # the BN scale of a U-Net's (decoder) BatchNorm: JAX fails
    'unet_batchnorm_weight': ('unet', {'batchnorm_weight': 'torch_default'},
                              True),
    # no BatchNorm: the slot is never read, in either package
    'unet_without_bn': ('unet_no_bn', {'batchnorm_weight': 'torch_default'},
                        False),
    'discriminator_batchnorm_weight': (
        'disc', {'batchnorm_weight': 'torch_default'}, True),
    'discriminator_final_layer_bias': (
        'disc_fc', {'final_layer_bias': 'torch_default'}, True),
}


@pytest.mark.parametrize('case', sorted(DIRECT_CASES))
def test_torch_default_in_direct_slots_as_jax(case):
  kind, weight_init, fails = DIRECT_CASES[case]
  x = np.zeros((1, 16, 16, 2), np.float32)
  if kind.startswith('unet'):
    section = dict(NARROW, upsampling_mode='bilinear',
                   use_bn=kind == 'unet', weight_init=weight_init)
    jmodel = junet.UNET(**dict(section, weight_init=jinits.normalize_user_init(
        weight_init)))
    section['name'] = 'UNET'
  else:
    section = dict(num_inputs=2, num_filters_per_layer=[8, 16],
                   strides=[2, 2], kernel_sizes=4, use_norm_layers=True,
                   norm_layer='batch', weight_init=weight_init)
    if kind == 'disc_fc':
      section.update(fc_layers=[4, 1])
    jmodel = jdisc.CNNDiscriminator(**dict(
        section, weight_init=jinits.normalize_user_init(weight_init)))
    section.update(name='CNNDiscriminator', spatial_shape=[16, 16],
                   input_method='simple')
  port = construct_model(section)
  # traced, not run: flax calls each initializer while tracing
  init = functools.partial(jax.eval_shape, functools.partial(
      jmodel.init, train=False), jax.random.PRNGKey(0), x)
  if fails:
    with pytest.raises(TypeError, match='not callable'):
      init()
    slot = next(iter(weight_init))
    with pytest.raises(ValueError, match=slot):
      port.init_weights(torch.Generator().manual_seed(0))
  else:
    init()
    port.init_weights(torch.Generator().manual_seed(0))
