"""The GAN slice's models in the port against the JAX package, on the CPU.

Each JAX module is initialised by flax (jitted), its variables bridged into
the port's module (``utils/jax_weights.load_flax_variables``), and both run
the same seeded numpy inputs. Tolerances: 2e-4 for the subpixel up-conv
(the JAX suite's conv bar, tests/test_conv_pallas.py:75), 1e-5 relative
for the discriminator, VGG19 and the losses (f32 in both, summation order
only), exact for padding and for the port's own explicit up-conv path
(f64).
"""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from csmri_refinement_tpu.models import adversarial_loss as jadv
from csmri_refinement_tpu.models import discriminators as jdisc
from csmri_refinement_tpu.models import layers as jlayers
from csmri_refinement_tpu.models import unet as junet
from csmri_refinement_tpu.models import vgg as jvgg
from csmri_refinement_tpu.models import vgg_loss as jvgg_loss
from csmri_refinement_tpu.models import weight_inits as jinits
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch.models import adversarial_loss as tadv
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import layers as tlayers
from csmri_refinement_tpu_torch.models import unet as tunet
from csmri_refinement_tpu_torch.models import vgg as tvgg
from csmri_refinement_tpu_torch.models import vgg_loss as tvgg_loss
from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

REL = 1e-5
SUBPIXEL_ATOL = 2e-4


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
  return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL, msg=''):
  want = np.asarray(want)
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * max(np.abs(want).max(), 1e-30),
                             err_msg=msg)


# -- SubpixelNNResizeConv ----------------------------------------------------

@pytest.mark.parametrize('pad', ['zero', 'replication', 'reflection'])
@pytest.mark.parametrize('hw', [(6, 6), (7, 9)])
def test_subpixel_up_conv_matches_jax(pad, hw):
  rng = np.random.RandomState(len(pad) * 100 + hw[0] * 10 + hw[1])
  x = rng.randn(2, hw[0], hw[1], 5).astype(np.float32)
  model = junet.SubpixelNNResizeConv(6, 4, True, pad,
                                     bias_init=jax.nn.initializers.normal(1.))
  variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
  want = jax.jit(model.apply)(variables, jnp.asarray(x))
  port = tunet.SubpixelNNResizeConv(5, 6, True, pad)
  load_flax_variables(port, _np(variables))
  with torch.no_grad():
    got = port(_t(x).permute(0, 3, 1, 2))
  assert tuple(got.shape) == (2, 2 * hw[0], 2 * hw[1], 6)
  np.testing.assert_allclose(got.numpy(), np.asarray(want),
                             atol=SUBPIXEL_ATOL)


@pytest.mark.parametrize('pad', ['zero', 'replication', 'reflection'])
@pytest.mark.parametrize('hw', [(4, 4), (5, 8), (9, 7)])
def test_subpixel_up_conv_equals_explicit_path(pad, hw):
  """nearest-up2 → SAME pad of the upsampled image → k4 conv, in f64: the
  subpixel form is the same function (odd and even sides)."""
  gen = torch.Generator().manual_seed(hw[0] * 10 + hw[1])
  x = torch.randn(2, 3, hw[0], hw[1], generator=gen, dtype=torch.float64)
  port = tunet.SubpixelNNResizeConv(3, 4, True, pad).double()
  with torch.no_grad():
    port.weight.copy_(torch.randn(port.weight.shape, generator=gen))
    port.bias.copy_(torch.randn(4, generator=gen))
    got = port(x)
    want = tlayers.same_conv(F.interpolate(x, scale_factor=2,
                                           mode='nearest'),
                             port.weight, port.bias, pad)
  np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                             atol=1e-12)


def test_decode_unit_takes_subpixel_path_for_k4_only():
  k4 = tunet.ConvDecodeUnit(4, 4, 4, 0.1, True, kernel_size=4,
                            mode='nn-resize-conv', padding='reflection')
  k3 = tunet.ConvDecodeUnit(4, 4, 4, 0.1, True, kernel_size=3,
                            mode='nn-resize-conv', padding='reflection')
  assert isinstance(k4.up_conv, tunet.SubpixelNNResizeConv)
  assert type(k3.up_conv) is torch.nn.Conv2d


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize('pad', ['zero', 'replication', 'reflection'])
@pytest.mark.parametrize('k', [3, 4])
def test_same_pad_stride2_matches_jax(k, pad):
  x = np.random.RandomState(k).randn(1, 7, 8, 2).astype(np.float32)
  want = np.asarray(jlayers.same_pad(jnp.asarray(x), k, 2, pad))
  got = tlayers.same_pad(_t(x).permute(0, 3, 1, 2), k, pad, stride=2)
  np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
  assert tlayers.pad_sizes(k, stride=2) == jlayers.pad_sizes(k, 2)
  assert tlayers.pad_sizes(4, stride=2) == (1, 1)
  assert tlayers.pad_sizes(3, stride=2) == (0, 1)


def test_leaky_relu_gradient_at_zero_matches_jax():
  """JAX's leaky_relu is where(x >= 0, ...): gradient 1 at 0, which the
  port keeps (torch's F.leaky_relu takes the slope there)."""
  x = np.array([-1.0, 0.0, 2.0], np.float32)
  want = jax.grad(lambda v: jnp.sum(
      jax.nn.leaky_relu(v, 0.2) * jnp.arange(1.0, 4.0)))(jnp.asarray(x))
  xt = _t(x).requires_grad_(True)
  (tlayers.leaky_relu(xt, 0.2) * torch.arange(1.0, 4.0)).sum().backward()
  np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
  np.testing.assert_array_equal(
      tlayers.leaky_relu(_t(x), 0.2).numpy(),
      np.asarray(jax.nn.leaky_relu(jnp.asarray(x), 0.2)))


def test_complex_abs_matches_jax_with_a_finite_gradient_at_zero():
  """The magnitude the VGG loss and the discriminator's input take: JAX's
  values, and gradient 0 at an exact 0 + 0i where JAX's sqrt(re² + im²)
  gives NaN (the DC kernel's output holds such zeros on the card)."""
  from csmri_refinement_tpu.ops import fft as jfft
  from csmri_refinement_tpu_torch.ops import fft as tfft
  x = np.random.RandomState(0).randn(2, 4, 4, 2).astype(np.float32)
  x[0, 0, 0] = 0.0
  want = np.asarray(jfft.complex_abs(jnp.asarray(x)))
  jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jfft.complex_abs(v)))(
      jnp.asarray(x)))
  xt = _t(x).requires_grad_(True)
  got = tfft.complex_abs(xt)
  got.sum().backward()
  _close(got.detach().numpy(), want, rel=1e-6)
  assert np.isnan(jgrad[0, 0, 0]).all()
  np.testing.assert_array_equal(xt.grad[0, 0, 0].numpy(), [0.0, 0.0])
  mask = np.ones_like(x, bool)
  mask[0, 0, 0] = False
  _close(xt.grad.numpy()[mask], jgrad[mask], rel=1e-6)


@pytest.mark.parametrize('name', ['relu', 'lrelu', 'tanh', 'softmax'])
def test_get_activation_matches_jax(name):
  x = np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32)
  want = jlayers.get_activation(name, 0.2)(jnp.asarray(x))
  if name == 'softmax':   # JAX's channel axis is last, the port's is 1
    got = tlayers.get_activation(name, 0.2)(_t(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1)
  else:
    got = tlayers.get_activation(name, 0.2)(_t(x))
  _close(got.numpy(), want)
  assert isinstance(tlayers.get_activation('prelu', 0.2, 5), tlayers.PReLU)


@pytest.mark.parametrize('kw', [
    dict(method='simple'),
    dict(method='simple-magnitude'),
    dict(method='simple-magnitude', normalize=True),
    dict(method='simple', normalize=True),
])
def test_discriminator_input_matches_jax(kw):
  from csmri_refinement_tpu.training import adversarial_training as jat
  from csmri_refinement_tpu_torch.training import adversarial_training as tat
  rng = np.random.RandomState(4)
  pred = rng.randn(2, 6, 6, 2).astype(np.float32)
  inp = rng.randn(2, 6, 6, 2).astype(np.float32)
  want = jat.DiscriminatorInputFn(**kw)._build({'pred': jnp.asarray(pred)},
                                               jnp.asarray(inp), None)
  got = tat.DiscriminatorInputFn(**kw).build({'pred': _t(pred)})
  _close(got.numpy(), want)


@pytest.mark.parametrize('key', ['conditional_input_source',
                                 'conditional_input_generator_key',
                                 'strip_bg_class', 'scale_input_zero_one'])
def test_discriminator_input_refuses_unsupported_keys(key):
  """The discriminator-input keys are taken as the JAX factory takes them
  (``get_discriminator_input_fn``), and a conditional input source that
  is neither 'input' nor 'generator' is refused, as JAX asserts."""
  from csmri_refinement_tpu.training import adversarial_training as jat
  from csmri_refinement_tpu_torch.training import adversarial_training as tat
  value = {'conditional_input_source': 'generator',
           'conditional_input_generator_key': 'pred',
           'strip_bg_class': True, 'scale_input_zero_one': True}[key]
  disc_conf = {'input_method': 'simple', key: value}
  if key == 'conditional_input_source':    # JAX reads out_gen[its key]
    disc_conf['conditional_input_generator_key'] = 'pred'
  pred = np.random.RandomState(5).randn(2, 6, 6, 3).astype(np.float32)
  jfn = jat.get_discriminator_input_fn(
      None, JConfiguration.from_dict(disc_conf))
  want = jfn._build({'pred': jnp.asarray(pred)}, jnp.asarray(pred),
                    {'pred': jnp.asarray(pred)})
  got = tat.get_discriminator_input_fn(disc_conf).build({'pred': _t(pred)})
  _close(got.numpy(), want)
  with pytest.raises(ValueError, match='conditional input source'):
    tat.get_discriminator_input_fn({'conditional_input_source': 'labels'})


@pytest.mark.parametrize('method', ['simple', 'simple-magnitude'])
@pytest.mark.parametrize('strip', [False, True], ids=['keep_bg', 'strip_bg'])
@pytest.mark.parametrize('source', ['input', 'generator'])
def test_discriminator_input_keys_match_jax_build(method, strip, source):
  """``strip_bg_class`` and the conditional-input keys against JAX's
  ``_build`` on both input methods (a packed complex prediction, with a
  background channel in front where it is stripped)."""
  from csmri_refinement_tpu.training import adversarial_training as jat
  from csmri_refinement_tpu_torch.training import adversarial_training as tat
  rng = np.random.RandomState(6)
  pred = rng.randn(2, 6, 6, 3 if strip else 2).astype(np.float32)
  inp = rng.randn(2, 6, 6, 2).astype(np.float32)
  kw = dict(method=method, normalize=True, strip_bg_class=strip,
            cond_input_source=source, scale_input_to_zero_one=True,
            cond_input_gen_key='pred' if source == 'generator' else None)
  want = jat.DiscriminatorInputFn(**kw)._build(
      {'pred': jnp.asarray(pred)}, jnp.asarray(inp),
      {'pred': jnp.asarray(pred)})
  got = tat.DiscriminatorInputFn(**kw).build({'pred': _t(pred)})
  assert got.shape == want.shape
  _close(got.numpy(), want)


def test_channel_dropout_drops_whole_channels():
  x = torch.ones(4, 64, 3, 5)
  gen = torch.Generator().manual_seed(0)
  y = tlayers.channel_dropout(x, 0.25, True, gen)
  per_channel = y.reshape(4, 64, -1)
  assert torch.all(per_channel.amax(-1) == per_channel.amin(-1))
  values = set(per_channel[..., 0].flatten().tolist())
  assert values == {0.0, float(np.float32(1.0) / np.float32(0.75))}
  dropped = (per_channel[..., 0] == 0).float().mean().item()
  assert abs(dropped - 0.25) < 0.07     # 256 draws: 2.7 standard errors
  assert torch.equal(tlayers.channel_dropout(x, 0.25, False, gen), x)
  again = tlayers.channel_dropout(x, 0.25, True,
                                  torch.Generator().manual_seed(0))
  assert torch.equal(again, y)


@pytest.mark.parametrize('affine', [False, True])
def test_instance_norm_and_prelu_match_jax(affine):
  x = np.random.RandomState(3).randn(2, 5, 6, 3).astype(np.float32)
  model = jlayers.InstanceNorm(affine=affine)
  variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
  if affine:
    variables = {'params': {'scale': jnp.asarray([0.5, 1.5, 2.0]),
                            'bias': jnp.asarray([0.1, -0.2, 0.3])}}
  want = model.apply(variables, jnp.asarray(x))
  port = tlayers.InstanceNorm(3, affine)
  load_flax_variables(port, _np(variables))
  got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  _close(got.detach().numpy(), want)
  prelu = jlayers.PReLU(init_slope=0.3)
  pvars = prelu.init(jax.random.PRNGKey(0), jnp.asarray(x))
  tprelu = tlayers.PReLU(3, 0.3)
  load_flax_variables(tprelu, _np(pvars))
  np.testing.assert_array_equal(
      tprelu(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach()
      .numpy(), np.asarray(prelu.apply(pvars, jnp.asarray(x))))


@pytest.mark.parametrize('name,spec', [
    ('zero', ('zero',)),
    ('normal', ('normal', 0.5, 0.1)),
    ('xavier_normal', ('xavier_normal', 'relu')),
    ('he_uniform', ('he_uniform', 0.2)),
])
@pytest.mark.parametrize('shape', [(64, 48, 3, 3), (512, 300)])
def test_new_initializers_statistics(name, spec, shape):
  """Mean and std of each new initializer against its formula and against
  the JAX initializer on the flax layout, within 3% (≥ 27k draws)."""
  gen = torch.Generator().manual_seed(0)
  w = weight_inits.init_(torch.empty(shape), spec, gen)
  flax_shape = shape[2:] + (shape[1], shape[0])
  j = np.asarray(jinits.get_initializer(spec)(jax.random.PRNGKey(0),
                                              flax_shape))
  if name == 'zero':
    assert torch.count_nonzero(w) == 0 and not j.any()
    return
  fan_in = shape[1] * math.prod(shape[2:])
  fan_out = shape[0] * math.prod(shape[2:])
  mean, std = {
      'normal': (0.5, 0.1),
      'xavier_normal': (0.0, math.sqrt(2.0) * math.sqrt(
          2.0 / (fan_in + fan_out))),
      'he_uniform': (0.0, math.sqrt(2.0 / (1 + 0.2 ** 2) / fan_in)),
  }[name]
  for sample in (w.numpy(), j):
    assert abs(sample.mean() - mean) < 0.03 * std
    assert abs(sample.std() - std) < 0.03 * std
  if name == 'he_uniform':
    assert w.abs().max().item() <= std * math.sqrt(3.0)


# -- CNNDiscriminator --------------------------------------------------------

DISC_CASES = {
    'batch-not-first-patchgan': dict(
        num_filters_per_layer=[8, 16, 16], strides=[2, 2, 1], kernel_sizes=4,
        final_conv_kernel_size=4, padding='reflection', act_fn='lrelu',
        use_norm_layers='not-first', norm_layer='batch'),
    'instance-prelu-fc': dict(
        num_filters_per_layer=[8, 8], strides=[2, 2], kernel_sizes=[3, 4],
        fc_layers=[12, 1], act_fn='prelu', use_norm_layers=True,
        norm_layer='instance', padding='zero'),
    'instance-affine-avgpool': dict(
        num_filters_per_layer=[8, 16], strides=[2, 1], kernel_sizes=3,
        final_conv_kernel_size=3, final_average_pooling=True,
        act_fn='relu', use_norm_layers=True, norm_layer='instance-affine',
        padding='replication',
        weight_init={'final_layer_bias': ['constant', 0.5]}),
}


def _disc_pair(case):
  kw = dict(DISC_CASES[case], num_inputs=2, compute_features=True)
  jmodel = jdisc.CNNDiscriminator(
      weight_init=jinits.normalize_user_init(kw.pop('weight_init', {})),
      **{k: v for k, v in kw.items()})
  x = np.random.RandomState(7).randn(3, 16, 16, 2).astype(np.float32)
  variables = jax.jit(functools.partial(jmodel.init, train=False))(
      jax.random.PRNGKey(1), jnp.asarray(x))
  section = dict(DISC_CASES[case], name='CNNDiscriminator', num_inputs=2,
                 compute_features=True, spatial_shape=[16, 16],
                 input_method='simple', use_image_pool=True)
  port = construct_model(section)
  load_flax_variables(port, _np(variables))
  return jmodel, variables, port, x


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', sorted(DISC_CASES))
def test_discriminator_matches_jax(case, train):
  """Outputs, features, the parameters' gradients of a scalar of them and
  (train mode) the updated BN statistics."""
  jmodel, variables, port, x = _disc_pair(case)

  def scalar(out, np_mod):
    feats = sum(np_mod.mean(f * f) for f in out['features'])
    return np_mod.mean(out['logits'] * 1.3) + np_mod.mean(out['prob']) + \
        feats

  def jloss(params):
    out = jmodel.apply(dict(variables, params=params), jnp.asarray(x),
                       train=train, mutable=['batch_stats'] if train else
                       False)
    out, state = out if train else (out, {})
    return scalar(out, jnp), (out, state)

  (_, (want, jstate)), jgrads = jax.jit(jax.value_and_grad(
      jloss, has_aux=True))(variables['params'])
  port.train(train)
  got = port(_t(x))
  loss = scalar(got, torch)
  grads = torch.autograd.grad(loss, list(port.parameters()))
  _close(got['logits'].detach().numpy(), want['logits'], msg='logits')
  _close(got['prob'].detach().numpy(), want['prob'], msg='prob')
  assert len(got['features']) == len(want['features'])
  for g, w in zip(got['features'], want['features']):
    _close(g.detach().numpy(), w, msg='features')
  twin = copy.deepcopy(port)
  load_flax_variables(twin, _np(dict(variables, params=jgrads)))
  want_grads = {k: v.detach().numpy() for k, v in twin.named_parameters()}
  # One scale for every tensor: a conv bias before an instance norm has a
  # gradient of exactly 0, which each side rounds to ~1e-8.
  scale = max(np.abs(v).max() for v in want_grads.values())
  for (name, _), g in zip(port.named_parameters(), grads):
    np.testing.assert_allclose(g.numpy(), want_grads[name], rtol=0,
                               atol=1e-4 * scale, err_msg=name)
  if train and 'batch_stats' in jstate:
    load_flax_variables(twin, _np(dict(variables, **jstate)))
    for name, buf in port.named_buffers():
      if 'running' in name:
        _close(buf.numpy(), dict(twin.named_buffers())[name].numpy(),
               msg=name)


def test_discriminator_fc_head_needs_spatial_shape():
  with pytest.raises(ValueError, match='spatial_shape'):
    construct_model(dict(DISC_CASES['instance-prelu-fc'],
                         name='CNNDiscriminator', num_inputs=2))


# -- VGG19 and the perceptual loss ------------------------------------------

@pytest.fixture(scope='module')
def vgg_pair():
  model = jvgg.VGG19(output_blocks=(1, 4))
  x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
  variables = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.asarray(x))
  port = tvgg.VGG19((1, 4))
  load_flax_variables(port, _np(variables))
  return model, variables, port, x


def test_vgg19_blocks_match_jax(vgg_pair):
  model, variables, port, x = vgg_pair
  want = jax.jit(model.apply)(variables, jnp.asarray(x))
  with torch.no_grad():
    got = port(_t(x))
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    assert tuple(g.permute(0, 2, 3, 1).shape) == w.shape
    _close(g.permute(0, 2, 3, 1).numpy(), w)


@pytest.mark.parametrize('channels', [2, 1])
def test_vgg_loss_value_and_gradient_match_jax(vgg_pair, channels):
  """Complex (magnitude RGB) and natural ((−1, 1) → (0, 1)) images; the
  gradient with respect to the prediction only."""
  _, variables, _, _ = vgg_pair
  # The JAX loss's own __call__, on the fixture's VGG19 (its constructor
  # would initialise a second VGG19 eagerly).
  jloss = jvgg_loss.VGGLoss.__new__(jvgg_loss.VGGLoss)
  jloss.__dict__.update(
      blocks=[4, 1], vgg=jvgg.VGG19(output_blocks=(4, 1)),
      vgg_params=variables['params'], criterion=jvgg_loss._CRITERIONS['MSE'],
      remat=False, weights=[1.0, 0.5])
  tloss = tvgg_loss.VGGLoss('VGG19', blocks=[4, 1], criterion='MSE',
                            weights=[1.0, 0.5], allow_random_init=True,
                            device='cpu')
  load_flax_variables(tloss.vgg, _np(variables))
  rng = np.random.RandomState(channels)
  pred = rng.randn(2, 32, 32, channels).astype(np.float32) * 0.5
  target = rng.randn(2, 32, 32, channels).astype(np.float32) * 0.5
  want, want_grad = jax.jit(jax.value_and_grad(
      lambda p: jloss(p, jnp.asarray(target))))(jnp.asarray(pred))
  p = _t(pred).requires_grad_(True)
  got = tloss(p, _t(target))
  got.backward()
  assert abs(got.item() - float(want)) <= REL * abs(float(want))
  _close(p.grad.numpy(), want_grad, rel=1e-4)


def test_vgg_weights_file_is_validated(tmp_path):
  shapes = tvgg.expected_vgg19_artifact()
  rng = np.random.RandomState(0)
  raw = {k: rng.randn(*s).astype(np.float32) * 0.01
         for k, s in shapes.items()}
  raw['__sha256__'] = np.asarray(tvgg.vgg19_content_hash(raw))
  assert raw['__sha256__'].item() == jvgg.vgg19_content_hash(raw)
  path = tmp_path / 'vgg19.npz'
  np.savez(path, **raw)
  model = tvgg.load_vgg19_params('vgg19.npz', str(tmp_path / 'conf.json'))
  np.testing.assert_array_equal(model.conv_15.weight.numpy(),
                                raw['features.34.weight'])
  assert not any(p.requires_grad for p in model.parameters())
  raw['features.0.bias'] = raw['features.0.bias'] + 1
  np.savez(path, **raw)
  with pytest.raises(ValueError, match='content hash'):
    tvgg.load_vgg19_params(str(path))
  del raw['features.2.weight']
  np.savez(path, **raw)
  with pytest.raises(ValueError, match='missing features.2.weight'):
    tvgg.load_vgg19_params(str(path))
  with pytest.raises(ValueError, match='vgg_random_init'):
    tvgg.load_vgg19_params(None)


# -- adversarial losses ------------------------------------------------------

def _disc_outputs(seed):
  rng = np.random.RandomState(seed)
  logits = rng.randn(3, 5, 5, 1).astype(np.float32) * 2
  out = {'logits': logits, 'prob': 1 / (1 + np.exp(-logits)),
         'features': [rng.randn(3, 8, 8, 4).astype(np.float32),
                      rng.randn(3, 4, 4, 8).astype(np.float32)]}
  out['prob'][0, 0, 0, 0] = 1.0     # clipped at 1 - eps
  return out


@pytest.mark.parametrize('loss_type', ['gen', 'disc'])
@pytest.mark.parametrize('name', ['gan', 'LSGAN', 'wgan', 'FeatureMatching'])
def test_adversarial_losses_match_jax(name, loss_type):
  conf_d = {'discriminator_label_smoothing': 0.1,
            'feature_matching_loss_distance_function': 'MSE'}
  jloss = jadv.get_adversarial_loss(JConfiguration.from_dict(conf_d), name,
                                    loss_type)
  tloss = tadv.get_adversarial_loss(Configuration.from_dict(conf_d), name,
                                    loss_type)
  fake, real = _disc_outputs(0), _disc_outputs(1)
  jtree = jax.tree_util.tree_map(jnp.asarray, (fake, real))
  want = float(jloss(*jtree))
  ttree = jax.tree_util.tree_map(_t, (fake, real))
  got = tloss(*ttree).item()
  # Relative to the terms' scale: WGAN's mean of signed logits cancels.
  scale = max(abs(want), np.abs(fake['logits']).mean())
  assert abs(got - want) <= REL * scale, (got, want)
