"""GAN refinement training in the port against the JAX package.

The tiny recipe of ``tests/test_adversarial.py`` (RefinementWrapper over a
1×2×4 RecNet and a [4, 8]/[4] k4 U-Net, a [8, 16, 16] PatchGAN
discriminator, GAN + feature matching + VGG19 + feature penalty, Adam) at
32², B = 4, with the discriminator's dropout off and an image pool larger
than every image the updates feed it, so both runners are deterministic, and
with BN after every discriminator layer (``use_norm_layers: true`` where the
paper has ``not-first``). Under ``not-first`` at its zero-init bias, the
first layer's pre-activations on the fakes' background (rounding noise of
~1e-9) sit on LeakyReLU's kink, where rounding picks the side: two
tensors' gradients are then decided by rounding, and Adam, whose first step
is ±lr whatever a gradient's size, carries that into the weights, which
part by more than the 1e-4 bar within three updates. So ``not-first`` is
held to one full update: its losses, every other tensor's gradient and the
BN statistics (``test_gan_not_first_update_*``). The JAX
runner's initial generator, discriminator and VGG19 weights are bridged into
the port's and both take the same numpy batches with fixed masks. The JAX
steps are jitted; one module fixture runs three full updates, one
discriminator-only update, one ``updates_per_step`` round (two discriminator
updates, then one generator update) and a validation batch on both sides,
and the tests read its record.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.models import construct_model as jconstruct_model
from csmri_refinement_tpu.models import get_input_keys as jget_input_keys
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu.training import build_runner as jbuild_runner
from csmri_refinement_tpu.training import image_pool as jimage_pool
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import train as ttrain
from csmri_refinement_tpu_torch.data import load_dataset
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import get_input_keys
from csmri_refinement_tpu_torch.ops import undersample as tus
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.training import image_pool
from csmri_refinement_tpu_torch.training.adversarial_runner import (
    AdversarialRunner)
from csmri_refinement_tpu_torch.utils import checkpoints
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

SIZE, BATCH, FULL_STEPS = 32, 4, 3
# Both runners compute in f32 and differ in summation order only (XLA vs
# ATen convs and reductions, the sampled-lines vs dense DC): the losses
# agree to ~1e-6 relative. Adam normalises each update, so a parameter
# whose gradient is near zero can move differently by up to lr (2e-4) per
# step; a wrong gradient or update rule moves every element by ~lr per step
# and fails 1e-4 after the six updates (the reasoning of
# tests/test_torch_port_train.py).
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
# The not-first update's gradients, each tensor's worst element relative to
# that tensor's largest: the compared tensors read at most 4.5e-5 (the
# U-Net's BN bias), float summation order in deep sums.
GRAD_RTOL = 2e-4
# Relative noise put on the batch's inputs to find the gradients that f32
# rounding alone decides: one rounding of an f32 value.
ROUNDING_NOISE = 1e-7
LOSS_NAMES = ('disc_loss_gan', 'disc_loss', 'gen_loss_gan',
              'gen_loss_FeatureMatching', 'gen_loss_VGG19',
              'gen_loss_FeaturePenalty', 'gen_loss')


def _conf_dict(**overrides):
  base = {
      'seed': 1,
      'run_name': 'tiny-gan',
      'train_dataset': 'Synthetic',
      'validation_dataset': 'Synthetic',
      'synthetic': {'image_size': SIZE, 'num_train': 8, 'num_val': 4},
      'undersampling': {'sampling_scheme': 'varden',
                        'acceleration_factor': 2,
                        'variable_acceleration': False},
      'runner_type': 'adversarial',
      'vgg_random_init': True,
      'application': 'reconstruction',
      'generator_model': {
          'name': 'RefinementWrapper',
          'mode': 'real-penalty-add',
          'input_mode': 'output',
          'pretrained_model': {'name': 'RecNet', 'num_blocks': 1,
                               'num_convs': 2, 'num_filters': 4},
          'learnable_model': {
              'name': 'UNET', 'num_inputs': 2, 'num_outputs': 1,
              'num_layers_per_scale': 1, 'encode_filters': [4, 8],
              'decode_filters': [4], 'kernel_size': 4,
              'upsampling_mode': 'nn-resize-conv',
              'output_activation': 'none', 'padding': 'reflection',
              'decoder_act_upsampling_only': True,
              'weight_init': {'conv_weight': ['orthogonal', 'relu'],
                              'batchnorm_weight': ['constant', 1.0]}},
      },
      'discriminator_model': {
          'num_inputs': 1,
          'input_method': 'simple-magnitude',
          'num_filters_per_layer': [8, 16, 16],
          'strides': [2, 2, 1],
          'kernel_sizes': 4,
          'final_conv_kernel_size': 4,
          'padding': 'reflection',
          'act_fn': 'lrelu',
          'relu_leakiness': 0.2,
          'dropout_after': [],
          'dropout_prob': 0.5,
          'use_norm_layers': True,
          'norm_layer': 'batch',
          'compute_features': True,
          'use_image_pool': True,
          'image_pool_size': 32,
      },
      'generator_adversarial_losses': ['gan', 'FeatureMatching'],
      'generator_losses': ['VGG19', 'FeaturePenalty'],
      'generator_loss_weights': {'gan': 0.5, 'VGG19': 10,
                                 'FeaturePenalty': 2},
      'discriminator_losses': ['gan'],
      'discriminator_label_smoothing': 0.1,
      'feature_penalty': {'criterion': 'L1',
                          'input_key': 'prescaled_refinement'},
      'generator_optimizer': {'name': 'Adam', 'learning_rate': 0.0002,
                              'beta1': 0.5},
      'discriminator_optimizer': {'name': 'Adam', 'learning_rate': 0.0002,
                                  'beta1': 0.5},
      'num_epochs': 1,
      'batch_size': BATCH,
      'epochs_per_validation': 1,
      'epochs_per_checkpoint': 1,
      'num_data_workers': 0,
      'train_generator_metrics': ['psnr'],
      'train_discriminator_metrics': ['binary_accuracy'],
      'validation_metrics': ['psnr', 'ssim'],
  }
  base.update(overrides)
  return base


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _batches(n):
  """n (JAX, port) prepared batches of phantoms with fixed masks."""
  conf = Configuration.from_dict(_conf_dict(
      synthetic={'image_size': SIZE, 'num_train': n * BATCH}))
  data = load_dataset(conf, None, 'Synthetic', 'train')
  out = []
  for i in range(n):
    gt = np.stack([data[j]['gt'] for j in range(i * BATCH, (i + 1) * BATCH)])
    mask = np.array(jmasks.cartesian_mask(
        jax.random.PRNGKey(i), (BATCH, SIZE, SIZE), 2.0))
    out.append((jus.undersample_batch(None, jnp.asarray(gt), fixed_mask=mask),
                tus.undersample_batch(None, torch.from_numpy(gt),
                                      fixed_mask=mask)))
  return out


class _FixedPreparer:
  """Hands the runner the prepared batch a host batch carries."""

  def prepare_train(self, generator, host_batch):
    return host_batch['prepared']

  def prepare_val(self, host_batch):
    return host_batch['prepared']


def _snapshot(jrunner, trunner):
  """Both sides' generator and discriminator state dicts and pools."""
  want_gen = _bridged(trunner.gen, jrunner.gen_state)
  want_disc = _bridged(trunner.disc, jrunner.disc_state)
  return {
      'gen': ({k: v.clone() for k, v in trunner.gen.state_dict().items()},
              want_gen),
      'disc': ({k: v.clone() for k, v in trunner.disc.state_dict().items()},
               want_disc),
      'pool': (trunner.pool.images.clone(), trunner.pool.count,
               np.asarray(jrunner.pool_state['images']),
               int(jrunner.pool_state['count'])),
  }


def _bridged(module, state):
  """``module``'s state dict with the JAX state's params and stats."""
  twin = copy.deepcopy(module)
  load_flax_variables(twin, {'params': _np_tree(state['params']),
                             'batch_stats': _np_tree(state['batch_stats'])})
  return {k: v.clone() for k, v in twin.state_dict().items()}


def _runners(conf_d, batch):
  """A JAX and a port runner of ``conf_d``, the port's generator,
  discriminator and VGG19 weights bridged from the JAX runner's init, and
  a ``jstep(batch, update_gen, update_disc, step)`` that runs one jitted
  JAX update and returns its losses."""
  jrunner = jbuild_runner(JConfiguration.from_dict(conf_d), 'adversarial',
                          'train')
  trunner = AdversarialRunner(Configuration.from_dict(conf_d), 'train', 'cpu')
  jrunner._ensure_initialized(batch)
  load_flax_variables(trunner.gen, {
      'params': _np_tree(jrunner.gen_state['params']),
      'batch_stats': _np_tree(jrunner.gen_state['batch_stats'])})
  load_flax_variables(trunner.disc, {
      'params': _np_tree(jrunner.disc_state['params']),
      'batch_stats': _np_tree(jrunner.disc_state['batch_stats'])})
  load_flax_variables(trunner.gen_criteria['VGG19'].criterion.vgg, {
      'params': _np_tree(jrunner.gen_criteria['VGG19'].criterion
                         .vgg_params)})

  def jstep(jb, update_gen, update_disc, step):
    fn = jrunner._get_step_fn(update_gen, update_disc, True)
    (jrunner.gen_state, jrunner.disc_state, jrunner.pool_state, losses,
     _) = fn(jrunner.gen_state, jrunner.disc_state, jrunner.pool_state, jb,
             jax.random.PRNGKey(step))
    return {k: float(v) for k, v in losses.items()}
  return jrunner, trunner, jstep


@pytest.fixture(scope='module')
def gan_record():
  batches = _batches(FULL_STEPS + 3)
  jrunner, trunner, jstep = _runners(_conf_dict(), batches[0][0])
  frozen = {k: v.clone() for k, v in
            trunner.gen.pretrained_model.state_dict().items()}

  record = {'losses': [], 'states': {}}
  for step in range(FULL_STEPS):
    jb, tb = batches[step]
    want = jstep(jb, True, True, step)
    got = {k: v.item() for k, v in trunner.train_batch(tb)[0].items()}
    record['losses'].append(('full {}'.format(step), got, want))
  record['states']['full'] = _snapshot(jrunner, trunner)

  jb, tb = batches[FULL_STEPS]
  want = jstep(jb, False, True, FULL_STEPS)
  got = {k: v.item() for k, v in
         trunner.train_batch(tb, update_gen=False)[0].items()}
  record['losses'].append(('disc only', got, want))
  record['states']['disc_only'] = _snapshot(jrunner, trunner)

  # updates_per_step 2 for the discriminator: D on b4, D on b5, G on b4
  (jb4, tb4), (jb5, tb5) = batches[FULL_STEPS + 1:]
  want = {}
  for jb, update_gen, update_disc in ((jb4, False, True),
                                      (jb5, False, True),
                                      (jb4, True, False)):
    for k, v in jstep(jb, update_gen, update_disc, 9).items():
      want.setdefault(k, []).append(v)
  want = {k: float(np.mean(v)) for k, v in want.items()}
  trunner.disc_updates_per_step = 2
  trunner.preparer = _FixedPreparer()
  n, metrics, _ = trunner._train_step(iter([{'prepared': tb4},
                                            {'prepared': tb5}]))
  assert n == 2
  got = {k: m.value for k, m in metrics.items()}
  record['losses'].append(('updates_per_step', got, want))
  record['states']['multi'] = _snapshot(jrunner, trunner)
  record['frozen'] = (frozen, trunner.gen.pretrained_model.state_dict())

  jb, tb = batches[0]
  jout, jfake, jreal, jlosses = jrunner._val_step_fn(
      jrunner.gen_state, jrunner.disc_state, jb)
  tlosses, (_, tout, tfake, treal) = trunner._val_step({'prepared': tb})
  record['val'] = ((jout, jfake, jreal, jlosses),
                   (tout, tfake, treal, tlosses))
  return record


def test_gan_losses_match_jax(gan_record):
  for label, got, want in gan_record['losses']:
    assert set(got) == set(want), label
    for name in want:
      assert abs(got[name] - want[name]) <= LOSS_RTOL * abs(want[name]), \
          (label, name, got[name], want[name])
  full = gan_record['losses'][0][2]
  assert set(LOSS_NAMES) <= set(full)
  assert set(gan_record['losses'][FULL_STEPS][2]) == {
      'disc_loss_gan', 'disc_loss'}


@pytest.mark.parametrize('phase', ['full', 'disc_only', 'multi'])
@pytest.mark.parametrize('net', ['gen', 'disc'])
def test_gan_parameters_and_bn_stats_match_jax(gan_record, phase, net):
  """Every parameter and BN running statistic of both networks, after the
  three full updates, the discriminator-only update (which keeps the
  generator's BN statistics) and the updates_per_step round."""
  got, want = gan_record['states'][phase][net]
  assert set(got) == set(want)
  for name, value in got.items():
    if name.endswith('num_batches_tracked'):
      continue
    np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                               atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize('phase', ['full', 'disc_only', 'multi'])
def test_gan_image_pool_matches_jax(gan_record, phase):
  got, count, want, want_count = gan_record['states'][phase]['pool']
  assert count == want_count
  np.testing.assert_allclose(got.numpy(), want, atol=PARAM_ATOL)


def test_gan_frozen_recnet_is_unchanged(gan_record):
  before, after = gan_record['frozen']
  for name, value in after.items():
    assert torch.equal(value, before[name]), name


def test_gan_validation_matches_jax(gan_record):
  (jout, jfake, jreal, jlosses), (tout, tfake, treal, tlosses) = \
      gan_record['val']
  np.testing.assert_allclose(tout['pred'].numpy(), np.asarray(jout['pred']),
                             atol=PARAM_ATOL)
  for want, got in ((jfake, tfake), (jreal, treal)):
    np.testing.assert_allclose(got['prob'].numpy(),
                               np.asarray(want['prob']), atol=PARAM_ATOL)
  assert set(tlosses) == {'gen_loss_' + k for k in jlosses}
  for name, value in jlosses.items():
    got = tlosses['gen_loss_' + name].value
    assert abs(got - float(value)) <= LOSS_RTOL * abs(float(value)), name


def _port_moments(module, optimizer):
  """The port optimizer's Adam first moments, (1 − beta1)·gradient after
  one update, by parameter name."""
  names = {id(p): n for n, p in module.named_parameters()}
  return {names[id(p)]: optimizer.state[p]['exp_avg'].clone()
          for group in optimizer.param_groups for p in group['params']}


def _rel_err(got, want):
  """max |got − want| over max |want|."""
  return ((got - want).abs().max() /
          want.abs().max().clamp_min(1e-30)).item()


@pytest.fixture(scope='module')
def not_first_record():
  """One full update of the recipe with the paper's ``not-first``
  discriminator on both sides; per network, the two sides' Adam first
  moments (JAX's ``mu`` in the port's layout), the state dicts, and the
  names of the tensors whose gradient f32 rounding alone decides: those
  that move by more than GRAD_RTOL of their max when the port's update
  runs again on the batch's inputs under ROUNDING_NOISE."""
  conf_d = _conf_dict()
  conf_d['discriminator_model']['use_norm_layers'] = 'not-first'
  (jb, tb), = _batches(1)
  jrunner, trunner, jstep = _runners(conf_d, jb)
  twin = copy.deepcopy(trunner)
  noise = torch.Generator().manual_seed(0)
  twin.train_batch(dict(tb, **{k: tb[k] * (1 + ROUNDING_NOISE * torch.randn(
      tb[k].shape, generator=noise)) for k in ('inp', 'kspace')}))
  want = jstep(jb, True, True, 0)
  got = {k: v.item() for k, v in trunner.train_batch(tb)[0].items()}
  record = {'losses': (got, want)}
  for net in ('gen', 'disc'):
    module, optimizer = getattr(trunner, net), getattr(trunner,
                                                       net + '_optimizer')
    jstate = getattr(jrunner, net + '_state')
    moments = _port_moments(module, optimizer)
    noisy = _port_moments(getattr(twin, net), getattr(twin,
                                                      net + '_optimizer'))
    mu = _bridged(module, {'params': jstate['opt_state'].inner_state[0].mu,
                           'batch_stats': jstate['batch_stats']})
    record[net] = {
        'moments': (moments, {n: mu[n] for n in moments}),
        'rounding_decided': {n for n in moments
                             if _rel_err(noisy[n], moments[n]) > GRAD_RTOL},
        'state': _snapshot(jrunner, trunner)[net]}
  return record


def test_gan_not_first_update_losses_match_jax(not_first_record):
  got, want = not_first_record['losses']
  assert set(got) == set(want) and set(LOSS_NAMES) <= set(want)
  for name in want:
    assert abs(got[name] - want[name]) <= LOSS_RTOL * abs(want[name]), \
        (name, got[name], want[name])


@pytest.mark.parametrize('net', ['gen', 'disc'])
def test_gan_not_first_update_gradients_match_jax(not_first_record, net):
  """Under ``not-first`` the first update's gradients (Adam's first
  moments) within GRAD_RTOL of each tensor's max, and the BN running
  statistics within PARAM_ATOL. The parameters themselves are not
  compared: Adam's first step is ±lr for every gradient element, whatever
  its size.

  Two tensors are left out by the fixture's rule, and the test checks that
  the rule leaves out those two alone. The fakes' background is rounding
  noise (~1e-9, from the DC's FFTs), so the sign of the first
  discriminator conv's output there, and with it LeakyReLU's slope, is
  decided by rounding. That conv's bias gradient sums the slope over every
  background pixel; its weight gradient multiplies it by the ~1e-9 pixel.
  The generator's output ``scale`` takes the discriminator's input
  gradient at those pixels. Both read 10-40% of their max apart under
  ROUNDING_NOISE in the port alone, as far as they read from JAX."""
  record = not_first_record[net]
  got, want = record['moments']
  assert got and set(got) == set(want)
  assert record['rounding_decided'] == {'gen': {'scale'},
                                        'disc': {'conv_0.bias'}}[net]
  errs = {n: _rel_err(got[n], want[n]) for n in got
          if n not in record['rounding_decided']}
  worst = max((e, n) for n, e in errs.items())
  assert worst[0] <= GRAD_RTOL, worst
  state, want_state = record['state']
  stats = [n for n in state if n.endswith(('running_mean', 'running_var'))]
  assert stats
  for name in stats:
    np.testing.assert_allclose(state[name].numpy(),
                               want_state[name].numpy(), atol=PARAM_ATOL,
                               err_msg=name)


def test_refinement_wrapper_input_keys_as_jax():
  """A RefinementWrapper takes its pretrained model's inputs, as the JAX
  wrapper's INPUT_KEYS say (a RecNet's k-space and mask too)."""
  section = _conf_dict()['generator_model']
  want = jget_input_keys(jconstruct_model(
      JConfiguration.from_dict(section), section['name']))
  assert get_input_keys(construct_model(section)) == tuple(want) == (
      'inp', 'kspace', 'mask')
  runner = build_runner(Configuration.from_dict(_conf_dict()), 'adversarial',
                        'test', 'cpu')
  assert get_input_keys(runner.gen) == tuple(want)
  assert runner.disc is None


def test_gan_modules_import_no_jax():
  """The slice's modules add no jax, flax or JAX-package module."""
  import subprocess
  import sys
  code = ('import sys; before = set(sys.modules); '
          'import csmri_refinement_tpu_torch.training.adversarial_runner, '
          'csmri_refinement_tpu_torch.models.discriminators, '
          'csmri_refinement_tpu_torch.models.vgg_loss, '
          'csmri_refinement_tpu_torch.training.model_setup, '
          'csmri_refinement_tpu_torch.profile_gan; '
          'new = set(sys.modules) - before; '
          'print(sorted(m for m in new if m.split(".")[0] in '
          '("jax", "jaxlib", "flax", "csmri_refinement_tpu")))')
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, check=True, cwd=os.path.dirname(
                           os.path.dirname(os.path.abspath(__file__))))
  assert out.stdout.strip() == '[]', out.stdout


def test_pretraining_schedules():
  """tests/test_adversarial.py:170-195's schedules on the port's runner."""
  def runner(**kw):
    return build_runner(Configuration.from_dict(_conf_dict(**kw)),
                        'adversarial', 'train', 'cpu')

  r = runner(pretrain_generator_epochs=2)
  r.epoch_beginning(1)
  assert r.generator_enabled and not r.discriminator_enabled
  r.epoch_beginning(3)
  assert r.generator_enabled and r.discriminator_enabled
  r = runner(pretrain_discriminator_epochs=[1, 3])
  r.epoch_beginning(2)
  assert r.discriminator_enabled and not r.generator_enabled
  r.epoch_beginning(3)
  assert r.discriminator_enabled and r.generator_enabled
  with pytest.raises(ValueError):
    runner(pretrain_discriminator_epochs=[3, 1])


def test_gen_pretraining_trains_without_disc():
  conf = Configuration.from_dict(_conf_dict(pretrain_generator_epochs=1))
  r = build_runner(conf, 'adversarial', 'train', 'cpu')
  disc_before = {k: v.clone() for k, v in r.disc.state_dict().items()}
  _, tb = _batches(1)[0]
  r.epoch_beginning(1)
  losses, _ = r.train_batch(tb)
  assert set(losses) == {'gen_loss_VGG19', 'gen_loss_FeaturePenalty',
                         'gen_loss'}
  for name, value in r.disc.state_dict().items():
    assert torch.equal(value, disc_before[name]), name
  assert r.pool is None


def test_pretrained_recnet_grafting(tmp_path):
  """``pretrained_weights: [path, 'model']`` on the wrapper's RecNet loads
  a standard runner's checkpoint written by the port, path relative to the
  config file; null disables it."""
  from csmri_refinement_tpu_torch.training.runner import Runner
  std = Runner(Configuration.from_dict(_conf_dict(
      runner_type='standard', seed=7,
      model={'name': 'RecNet', 'num_blocks': 1, 'num_convs': 2,
             'num_filters': 4},
      loss_name='MSE', optimizer={'name': 'Adam', 'learning_rate': 2e-4})),
               'train', 'cpu')
  _, tb = _batches(1)[0]
  std.train_batch(tb)
  ckpt_dir = tmp_path / 'ckpt'
  ckpt_dir.mkdir()
  checkpoints.save_checkpoint(str(ckpt_dir / 'recnet.ckpt'), std.conf, std,
                              1, {})
  conf_d = _conf_dict()
  conf_d['generator_model']['pretrained_model']['pretrained_weights'] = [
      'ckpt/recnet.ckpt', 'model']
  conf_path = tmp_path / 'gan.json'
  import json
  conf_path.write_text(json.dumps(conf_d))
  r = build_runner(Configuration.from_json(str(conf_path)), 'adversarial',
                   'train', 'cpu')
  want = std.model.state_dict()
  got = r.gen.pretrained_model.state_dict()
  assert set(got) == set(want)
  for name, value in got.items():
    assert torch.equal(value, want[name]), name

  conf_d['generator_model']['pretrained_model']['pretrained_weights'] = None
  conf_path.write_text(json.dumps(conf_d))
  r = build_runner(Configuration.from_json(str(conf_path)), 'adversarial',
                   'train', 'cpu')
  assert not torch.equal(r.gen.pretrained_model.state_dict()[
      'block_0.conv_0.weight'], want['block_0.conv_0.weight'])


def test_image_pool_swap_phase_matches_jax():
  """The swap phase, fed the decisions JAX's keys give, leaves the same
  pool and returns the same images as the JAX ``query``."""
  rng = np.random.RandomState(0)
  fill = rng.rand(3, 2, 2, 1).astype(np.float32)
  incoming = rng.rand(5, 2, 2, 1).astype(np.float32)
  key = jax.random.PRNGKey(4)
  jstate = jimage_pool.init_pool(3, (2, 2, 1))
  jstate, _ = jimage_pool.query(jstate, jnp.asarray(fill),
                                jax.random.PRNGKey(0))
  jstate, jout = jimage_pool.query(jstate, jnp.asarray(incoming), key, 0.5)
  decisions = []
  for k in jax.random.split(key, 5):
    k_idx, k_p = jax.random.split(k)
    decisions.append((int(jax.random.randint(k_idx, (), 0, 3)),
                      bool(jax.random.uniform(k_p) < 0.5)))
  assert {d[1] for d in decisions} == {True, False}   # both branches taken
  pool = image_pool.ImagePool(3, (2, 2, 1), 'cpu')
  np.testing.assert_array_equal(pool.query(torch.from_numpy(fill)).numpy(),
                                fill)
  pool.draw = lambda generator, p, it=iter(decisions): next(it)
  out = pool.query(torch.from_numpy(incoming))
  np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
  np.testing.assert_array_equal(pool.images.numpy(),
                                np.asarray(jstate['images']))
  assert pool.count == int(jstate['count']) == 3


def test_image_pool_draws_from_host_generator():
  pool = image_pool.ImagePool(2, (1, 1, 1), 'cpu')
  pool.query(torch.tensor([1.0, 2.0]).reshape(2, 1, 1, 1))
  gen = torch.Generator().manual_seed(0)
  out = pool.query(torch.tensor([3.0, 4.0]).reshape(2, 1, 1, 1), gen, p=1.0)
  assert set(out.flatten().tolist()) <= {1.0, 2.0, 3.0}
  assert {3.0, 4.0} <= set(pool.images.flatten().tolist()) | {3.0}
  keep = pool.query(torch.tensor([5.0, 6.0]).reshape(2, 1, 1, 1), gen, p=0.0)
  assert keep.flatten().tolist() == [5.0, 6.0]


def test_cli_trains_validates_and_resumes(tmp_path):
  """One epoch of the tiny GAN through the CLI on the CPU, then --resume
  for a second; the checkpoint holds both networks and optimizers."""
  import glob
  import json
  conf_path = tmp_path / 'gan.json'
  conf_path.write_text(json.dumps(_conf_dict(
      synthetic={'image_size': 16, 'num_train': 8, 'num_val': 4},
      discriminator_model=dict(_conf_dict()['discriminator_model'],
                               num_filters_per_layer=[4, 8],
                               strides=[2, 1]),
      best_checkpoint_metrics=['gen_psnr'])))
  run_dir = str(tmp_path / 'run')
  runner = ttrain.main([str(conf_path), '--device', 'cpu', '--run-dir',
                        run_dir])
  assert runner.step == 2
  ckpts = sorted(glob.glob(os.path.join(run_dir, 'periodic-chkpt_*')))
  assert ckpts, os.listdir(run_dir)
  assert glob.glob(os.path.join(run_dir, 'best_gen_psnr', '*'))
  state = checkpoints.load_checkpoint(ckpts[-1])
  assert {'generator', 'discriminator', 'gen_optimizer',
          'disc_optimizer'} <= set(state['runner'])
  resumed = ttrain.main([str(conf_path), '--device', 'cpu', '--resume',
                         ckpts[-1], '--conf', 'num_epochs=2'])
  assert resumed.step == 4
  for name, value in state['runner']['discriminator'].items():
    if name.endswith('weight'):
      assert not torch.equal(value, resumed.disc.state_dict()[name]), name


def test_cli_needs_a_card_or_cpu(tmp_path, monkeypatch):
  import json
  conf_path = tmp_path / 'gan.json'
  conf_path.write_text(json.dumps(_conf_dict()))
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='--device cpu'):
    ttrain.main([str(conf_path), '--dry'])
  with pytest.raises(RuntimeError, match='CUDA'):
    AdversarialRunner(Configuration.from_json(str(conf_path)))
