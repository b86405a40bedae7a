"""Port parity for the models of ``csmri_refinement_tpu_torch`` on the CPU.

Each JAX model is initialised by flax, its variables are bridged into the
port's module (``utils/jax_weights.load_flax_variables``), and both run the
same seeded numpy inputs. Tolerances: RecNet 1e-4 (f32 convs + FFT DC),
U-Net 5e-4 (the JAX suite's bar, tests/test_conv_pallas.py:130).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.models import recnet as jrecnet
from csmri_refinement_tpu.models import unet as junet
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import recnet as trecnet
from csmri_refinement_tpu_torch.models import unet as tunet
from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.models.refinement_wrapper import (
    RefinementWrapper)
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
  return torch.from_numpy(np.array(a))


def _batch(batch, size, seed):
  rng = np.random.RandomState(seed)
  gt = rng.rand(batch, size, size).astype(np.float32)
  mask = jmasks.cartesian_mask_np((batch, size, size), 4, 8,
                                  rng=np.random.RandomState(seed + 1))
  return {k: np.asarray(v) for k, v in jus.undersample_batch(
      None, jnp.asarray(gt), fixed_mask=mask).items()}


RECNET_CASES = {
    'default': {},
    'refine_skip_dilated_reflect': dict(use_refinement=True,
                                        skip_final_dc=True,
                                        dilations_per_conv=[2, 1],
                                        padding='reflection'),
    'intermediate_recs': dict(return_intermediate_recs=True,
                              num_filters=[8, 4]),
}


@pytest.mark.parametrize('case', sorted(RECNET_CASES))
def test_recnet_matches_jax(case):
  kw = dict(num_blocks=2, num_convs=2, num_filters=8)
  kw.update(RECNET_CASES[case])
  b = _batch(2, 32, 0)
  model = jrecnet.RecNet(**kw)
  args = [jnp.asarray(b[k]) for k in ('inp', 'kspace', 'mask')]
  variables = jax.jit(model.init)(jax.random.PRNGKey(0), *args)
  want = jax.jit(model.apply)(variables, *args)
  port = trecnet.RecNet(**kw)
  load_flax_variables(port, _np(variables))
  with torch.no_grad():
    got = port(*[_t(b[k]) for k in ('inp', 'kspace', 'mask')])
  if kw.get('return_intermediate_recs'):
    assert len(got['reconstructions']) == len(want['reconstructions']) == 2
    for g, w in zip(got['reconstructions'], want['reconstructions']):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    got, want = got['pred'], want['pred']
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _perturbed_stats(variables, seed):
  stats = variables['batch_stats']
  leaves, treedef = jax.tree_util.tree_flatten(stats)
  keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
  leaves = [jnp.abs(l + 0.3 * jax.random.normal(k, l.shape)) + 0.05
            for l, k in zip(leaves, keys)]
  return {'params': variables['params'],
          'batch_stats': jax.tree_util.tree_unflatten(treedef, leaves)}


UNET_CASES = {
    'flagship_layout': dict(kernel_size=4, padding='reflection',
                            upsampling_mode='nn-resize-conv',
                            decoder_act_upsampling_only=True),
    'nn_merge_bn_zero_k3': dict(kernel_size=3, padding='zero',
                                upsampling_mode='nn',
                                decoder_act_upsampling_only=False),
    'replicate_extra_decoder': dict(kernel_size=4, padding='replication',
                                    upsampling_mode='nn-resize-conv',
                                    decoder_act_upsampling_only=True,
                                    decode_filters=[16, 8, 8]),
}


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case', sorted(UNET_CASES))
def test_unet_matches_jax(case, train):
  kw = dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
            encode_filters=[8, 16, 32], decode_filters=[16, 8],
            output_activation='none')
  kw.update(UNET_CASES[case])
  x = np.random.RandomState(3).randn(2, 32, 32, 2).astype(np.float32)
  model = junet.UNET(**kw)
  variables = _perturbed_stats(
      jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
  if train:
    want, _ = jax.jit(functools.partial(
        model.apply, train=True, mutable=['batch_stats']))(
            variables, jnp.asarray(x))
  else:
    want = jax.jit(functools.partial(model.apply, train=False))(
        variables, jnp.asarray(x))
  port = tunet.UNET(**kw)
  load_flax_variables(port, _np(variables))
  port.train(train)
  with torch.no_grad():
    got = port(_t(x)).numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(got, np.asarray(want), atol=5e-4)


def test_weight_bridge_is_strict():
  x = jnp.zeros((1, 16, 16, 2))
  kw = dict(num_inputs=2, num_outputs=1, num_layers_per_scale=1,
            encode_filters=[8, 16], decode_filters=[8], kernel_size=4,
            upsampling_mode='nn-resize-conv', output_activation='none',
            padding='reflection', decoder_act_upsampling_only=True)
  variables = _np(jax.jit(junet.UNET(**kw).init)(jax.random.PRNGKey(0), x))
  port = tunet.UNET(**kw)
  load_flax_variables(port, variables)
  extra = {'params': dict(variables['params'], stray={'kernel': np.zeros(1)}),
           'batch_stats': variables['batch_stats']}
  with pytest.raises(ValueError, match='stray'):
    load_flax_variables(port, extra)
  missing = {'params': {k: v for k, v in variables['params'].items()
                        if k != 'head'},
             'batch_stats': variables['batch_stats']}
  with pytest.raises(KeyError, match='head'):
    load_flax_variables(port, missing)
  with pytest.raises(ValueError, match='shape'):
    load_flax_variables(tunet.UNET(**dict(kw, encode_filters=[8, 32])),
                        variables)


def test_weight_inits_statistics():
  gen = torch.Generator().manual_seed(0)
  w = torch.empty(64, 32, 4, 4)
  weight_inits.init_(w, ('he_normal', 0.1), gen)
  want_std = np.sqrt(2.0 / 1.01) / np.sqrt(32 * 16)
  assert abs(w.std().item() / want_std - 1) < 0.03
  weight_inits.init_(w, ('xavier', 1.0), gen)
  limit = np.sqrt(6.0 / (32 * 16 + 64 * 16))
  assert w.abs().max().item() <= limit and w.abs().max().item() > 0.95 * limit
  weight_inits.init_(w, ('orthogonal', 'relu'), gen)
  cols = w.permute(2, 3, 1, 0).reshape(-1, 64).double()
  np.testing.assert_allclose((cols.T @ cols).numpy(), 2.0 * np.eye(64),
                             atol=1e-6)
  v = torch.empty(1000)
  weight_inits.init_(v, ('uniform', 0.98, 1.02), gen)
  assert 0.98 <= v.min().item() and v.max().item() <= 1.02
  weight_inits.init_(v, ('constant', 1.0), gen)
  assert bool((v == 1.0).all())


def test_construct_model_reads_refinement_config():
  """The generator_model section of configs/2-refinement.json, unchanged,
  builds the port's flagship; with bridged weights it matches the JAX
  package's construct_model on the same section."""
  from csmri_refinement_tpu.models import construct_model as jax_construct
  from csmri_refinement_tpu.utils.config import Configuration
  with open(os.path.join(REPO, 'configs', '2-refinement.json')) as f:
    section = json.load(f)['generator_model']
  port = construct_model(section)
  assert isinstance(port, RefinementWrapper)
  assert (port.mode, port.input_mode) == ('real-penalty-add', 'output')
  assert port.learnable_model.weight_init['conv_weight'] == \
      ('orthogonal', 'relu')
  assert port.learnable_model.encode_2.conv_1.weight.shape == (128, 128, 4, 4)
  assert port.pretrained_model.block_2.conv_1.weight.shape == (32, 32, 3, 3)
  port.init_weights(torch.Generator().manual_seed(0))
  assert bool((port.learnable_model.encode_0.bn_0.weight == 1.0).all())

  jmodel = jax_construct(Configuration.from_dict(section), section['name'])
  b = _batch(1, 32, 4)
  args = [jnp.asarray(b[k]) for k in ('inp', 'kspace', 'mask')]
  variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), *args)
  variables['params']['scale'] = jnp.full((1,), 0.5)
  want = jax.jit(jmodel.apply)(variables, *args)
  load_flax_variables(port.eval(), _np(variables))
  with torch.no_grad():
    got = port(*[_t(b[k]) for k in ('inp', 'kspace', 'mask')])
  for key in ('pred', 'prescaled_refinement'):
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=5e-4, err_msg=key)
  with pytest.raises(TypeError):
    construct_model(dict(section['learnable_model'], use_scan=True))


def _running_stats(module):
  return {k: v.numpy().copy() for k, v in module.state_dict().items()
          if 'running' in k}


@pytest.mark.parametrize('case', sorted(UNET_CASES))
def test_unet_train_step_updates_batch_stats_as_jax(case):
  """One train-mode forward updates every BN's running mean and variance as
  flax does: the variance is the biased batch variance (torch's own
  BatchNorm2d takes N/(N-1) times it, 8e-4 relative at the 8x8 scale)."""
  kw = dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
            encode_filters=[8, 16, 32], decode_filters=[16, 8],
            output_activation='none')
  kw.update(UNET_CASES[case])
  x = np.random.RandomState(3).randn(2, 32, 32, 2).astype(np.float32)
  model = junet.UNET(**kw)
  variables = _perturbed_stats(
      jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
  _, updated = jax.jit(functools.partial(
      model.apply, train=True, mutable=['batch_stats']))(
          variables, jnp.asarray(x))
  port = tunet.UNET(**kw)
  load_flax_variables(port, _np(variables))
  with torch.no_grad():
    port.train()(_t(x))
  want = tunet.UNET(**kw)
  load_flax_variables(want, _np({'params': variables['params'],
                                 'batch_stats': updated['batch_stats']}))
  got, want = _running_stats(port), _running_stats(want)
  assert got.keys() == want.keys() and len(got) > 10
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6,
                               err_msg=k)


def test_refinement_wrapper_keeps_pretrained_model_in_eval_mode():
  """A wrapper around a BN U-Net, in train mode, against the JAX wrapper's
  ``apply(train=True)``: the pretrained U-Net normalises with its running
  stats and keeps them; the learnable one uses and updates batch stats."""
  from csmri_refinement_tpu.models.refinement_wrapper import (
      RefinementWrapper as JWrapper)
  kw = dict(num_inputs=2, num_outputs=2, num_layers_per_scale=2,
            encode_filters=[8, 16], decode_filters=[8],
            output_activation='none', **UNET_CASES['flagship_layout'])
  x = np.random.RandomState(6).randn(2, 16, 16, 2).astype(np.float32)
  jmodel = JWrapper(pretrained_model=junet.UNET(**kw),
                    learnable_model=junet.UNET(**kw), mode='add')
  variables = _perturbed_stats(
      jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(x)), 7)
  want, updated = jax.jit(functools.partial(
      jmodel.apply, train=True, mutable=['batch_stats']))(
          variables, jnp.asarray(x))
  port = RefinementWrapper(tunet.UNET(**kw), tunet.UNET(**kw), mode='add')
  load_flax_variables(port, _np(variables))
  before = _running_stats(port.pretrained_model)
  port.train()
  assert not port.pretrained_model.training
  assert port.learnable_model.training
  with torch.no_grad():
    got = port(_t(x)).numpy()
  np.testing.assert_allclose(got, np.asarray(want), atol=5e-4)
  ref = RefinementWrapper(tunet.UNET(**kw), tunet.UNET(**kw), mode='add')
  load_flax_variables(ref, _np({'params': variables['params'],
                                'batch_stats': updated['batch_stats']}))
  for name in ('pretrained_model', 'learnable_model'):
    got_s = _running_stats(getattr(port, name))
    want_s = _running_stats(getattr(ref, name))
    for k in want_s:
      np.testing.assert_allclose(got_s[k], want_s[k], rtol=2e-5, atol=1e-6,
                                 err_msg=name + '.' + k)
  for k, v in before.items():
    np.testing.assert_array_equal(_running_stats(port.pretrained_model)[k], v)
