"""Standard RecNet training in the port against the JAX package.

Small sizes (32², RecNet 2 blocks × 2 convs × 8 filters), un-``slow``, the
JAX side jitted. The trajectory test bridges the JAX ``Runner``'s initial
parameters into the port's ``Runner`` and feeds both the same five numpy
batches with fixed masks (the two packages' random mask streams cannot
match). On the JAX side RecNet takes its exact sampled-lines DC (the
``undersampling`` section is threaded in); on the port's, the dense DC.
"""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.data import DataLoader as JDataLoader
from csmri_refinement_tpu.data import load_dataset as jload_dataset
from csmri_refinement_tpu.metrics import get_metric_fn as jget_metric_fn
from csmri_refinement_tpu.metrics import image_metrics as jimage_metrics
from csmri_refinement_tpu.models import construct_model as jconstruct_model
from csmri_refinement_tpu.models import criteria as jcriteria
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu.training import build_runner as jbuild_runner
from csmri_refinement_tpu.training import lr_schedulers as jlr
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import train as ttrain
from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.metrics import get_metric_fn
from csmri_refinement_tpu_torch.metrics import image_metrics
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import criteria
from csmri_refinement_tpu_torch.ops import undersample as tus
from csmri_refinement_tpu_torch.training import lr_schedulers
from csmri_refinement_tpu_torch.training.runner import Runner
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH, STEPS = 32, 4, 5
# Both runners compute in f32 and differ only in summation order (XLA vs
# ATen convs, the sampled-lines vs dense DC): the losses agree to 1.5e-6
# relative. Adam normalises each update, so a parameter whose gradient is
# near zero can move differently by up to lr per step: measured 2.7e-5 on
# one bias after five steps at lr 2e-4, 2e-7 on the weights. A wrong
# gradient or update rule moves every element by ~lr per step (1e-3 over
# the five steps) and fails 1e-4.
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
METRIC_ATOL = 1e-4


def _conf_dict(**overrides):
  base = {
      'seed': 0,
      'run_name': 'tiny',
      'train_dataset': 'Synthetic',
      'validation_dataset': 'Synthetic',
      'synthetic': {'image_size': SIZE, 'num_train': 8, 'num_val': 4},
      'undersampling': {'sampling_scheme': 'varden',
                        'acceleration_factor': 2,
                        'variable_acceleration': False},
      'runner_type': 'standard',
      'application': 'reconstruction',
      'model': {'name': 'RecNet', 'num_blocks': 2, 'num_convs': 2,
                'num_filters': 8},
      'loss_name': 'MSE',
      'optimizer': {'name': 'Adam', 'learning_rate': 0.0002},
      'num_epochs': 1,
      'batch_size': BATCH,
      'epochs_per_validation': 1,
      'epochs_per_checkpoint': 1,
      'num_data_workers': 0,
      'train_metrics': ['psnr'],
      'validation_metrics': ['psnr', 'ssim'],
      'validation_checkpoint_metrics': ['loss_MSE'],
  }
  base.update(overrides)
  return base


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _batches(n):
  """n batches of synthetic phantoms with fixed 16-line cartesian masks."""
  conf = Configuration.from_dict(_conf_dict(
      synthetic={'image_size': SIZE, 'num_train': n * BATCH}))
  data = load_dataset(conf, None, 'Synthetic', 'train')
  out = []
  for i in range(n):
    gt = np.stack([data[j]['gt'] for j in range(i * BATCH, (i + 1) * BATCH)])
    mask = np.array(jmasks.cartesian_mask(
        jax.random.PRNGKey(i), (BATCH, SIZE, SIZE), 2.0))
    out.append((gt, mask))
  return out


def test_runner_trajectory_matches_jax():
  jrunner = jbuild_runner(JConfiguration.from_dict(_conf_dict()),
                          'standard', 'train')
  trunner = Runner(Configuration.from_dict(_conf_dict()), 'train', 'cpu')
  assert trunner.model.dc_lines_acc == jrunner.model.dc_lines_acc == 2.0
  batches = _batches(STEPS)
  jbatches = [jus.undersample_batch(None, jnp.asarray(gt), fixed_mask=m)
              for gt, m in batches]
  tbatches = [tus.undersample_batch(None, torch.from_numpy(gt),
                                    fixed_mask=m) for gt, m in batches]
  jrunner._ensure_initialized(jbatches[0])
  load_flax_variables(trunner.model,
                      {'params': _np_tree(jrunner.state['params'])})

  for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
    jrunner.state, jlosses, _ = jrunner._train_step_fn(
        jrunner.state, jb, jax.random.PRNGKey(step))
    tlosses, _ = trunner.train_batch(tb)
    want, got = float(jlosses['loss']), tlosses['loss'].item()
    assert abs(got - want) <= LOSS_RTOL * abs(want), (step, got, want)
  assert trunner.step == STEPS

  want_model = copy.deepcopy(trunner.model)
  load_flax_variables(want_model,
                      {'params': _np_tree(jrunner.state['params'])})
  want = want_model.state_dict()
  for name, value in trunner.model.state_dict().items():
    np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                               atol=PARAM_ATOL, err_msg=name)


def test_synthetic_phantoms_equal_jax():
  conf_d = _conf_dict(synthetic={'image_size': SIZE, 'num_train': 3,
                                 'num_val': 2})
  for fold in ('train', 'val'):
    want = jload_dataset(JConfiguration.from_dict(conf_d), '/tmp',
                         'Synthetic', fold)
    got = load_dataset(Configuration.from_dict(conf_d), None, 'Synthetic',
                       fold)
    assert len(got) == len(want)
    for i in range(len(got)):
      np.testing.assert_array_equal(got[i]['gt'], want[i]['gt'])
      assert got[i]['index'] == want[i]['index']


def test_loader_batches_equal_jax():
  conf_d = _conf_dict(synthetic={'image_size': 8, 'num_train': 10})
  want_set = jload_dataset(JConfiguration.from_dict(conf_d), '/tmp',
                           'Synthetic', 'train')
  got_set = load_dataset(Configuration.from_dict(conf_d), None, 'Synthetic',
                         'train')
  for kw in (dict(shuffle=True, seed=3, num_samples=9),
             dict(shuffle=False, drop_last=True)):
    want = JDataLoader(want_set, 4, **kw)
    got = DataLoader(got_set, 4, num_workers=2, **kw)
    assert len(got) == len(want)
    for _ in range(2):     # the shuffle stream continues across epochs
      pairs = list(zip(got, want))
      assert len(pairs) == len(want)
      for g, w in pairs:
        np.testing.assert_array_equal(g['index'], w['index'])
        np.testing.assert_array_equal(g['gt'], w['gt'])


@pytest.mark.parametrize('name', ['psnr', 'ssim'])
def test_image_metrics_match_jax(name):
  rng = np.random.RandomState(0)
  target = rng.rand(1, SIZE, SIZE, 1).astype(np.float32)
  pred = np.clip(target + 0.05 * rng.randn(*target.shape), 0, 1).astype(
      np.float32)
  fn = 'compute_' + name
  want = getattr(jimage_metrics, fn)(pred, target)
  got = getattr(image_metrics, fn)(torch.from_numpy(pred),
                                   torch.from_numpy(target))
  assert abs(got - want) <= METRIC_ATOL


def test_metric_function_matches_jax():
  """Per-example magnitude + clamp, then the mean over the batch."""
  rng = np.random.RandomState(1)
  target = rng.rand(3, SIZE, SIZE, 2).astype(np.float32)
  pred = (target + 0.1 * rng.randn(*target.shape)).astype(np.float32)
  conf_d = _conf_dict()
  for name in ('psnr', 'ssim'):
    want = jget_metric_fn(JConfiguration.from_dict(conf_d), name, 'test')(
        {'pred': pred}, {'target': target})
    got = get_metric_fn(Configuration.from_dict(conf_d), name)(
        torch.from_numpy(pred), {'target': torch.from_numpy(target)})
    assert abs(got.value - want.value) <= METRIC_ATOL, name


@pytest.mark.parametrize('name', ['MSE', 'L1', 'SmoothL1Loss'])
def test_criteria_match_jax(name):
  rng = np.random.RandomState(2)
  pred = 2 * rng.randn(2, 8, 8, 2).astype(np.float32)
  target = rng.randn(2, 8, 8, 2).astype(np.float32)
  conf_d = _conf_dict()
  want = jcriteria.get_criterion(JConfiguration.from_dict(conf_d), name)(
      {'pred': jnp.asarray(pred)}, {'target': jnp.asarray(target)})
  got = criteria.get_criterion(Configuration.from_dict(conf_d), name)(
      {'pred': torch.from_numpy(pred)}, {'target': torch.from_numpy(target)})
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_vgg_criterion_defaults_to_the_card(monkeypatch):
  """``get_criterion`` called without a device builds its VGG19 on the
  card, as every entry point of the port does unless the caller asks for
  the CPU."""
  from csmri_refinement_tpu_torch.models import vgg_loss
  seen = []
  monkeypatch.setattr(vgg_loss, 'VGGLoss',
                      lambda *args, **kw: seen.append(kw['device']))
  criteria.get_criterion(Configuration.from_dict(_conf_dict()), 'VGG19')
  assert [torch.device(d).type for d in seen] == ['cuda']


def test_runner_builds_criteria_on_its_device(monkeypatch):
  """The standard Runner hands its own device to every criterion, so a
  reconstruction run with a VGG19 loss puts the VGG19 beside its model
  (the JAX Runner takes any criterion, VGG19 included)."""
  from csmri_refinement_tpu_torch.training import runner as trunner
  seen = []

  def recording(conf, name, **kw):
    seen.append((name, kw.get('device')))
    return criteria.get_criterion(conf, name, device='cpu')
  monkeypatch.setattr(trunner, 'get_criterion', recording)
  conf_d = _conf_dict(losses=['MSE', 'L1'])
  del conf_d['loss_name']
  Runner(Configuration.from_dict(conf_d), 'train', 'cpu')
  assert seen == [('MSE', torch.device('cpu')), ('L1', torch.device('cpu'))]


@pytest.mark.parametrize('opt', [
    {'learning_rate': 0.1, 'lr_scheduler': 'multistep',
     'decay_steps': [2, 4], 'decay_factor': 0.5},
    {'learning_rate': 0.1, 'lr_scheduler': 'polynomial',
     'end_learning_rate': 0.01, 'decay_steps': 5, 'start_decay': 1,
     'decay_power': 2.0}], ids=['multistep', 'polynomial'])
def test_lr_schedulers_match_jax(opt):
  want = jlr.get_lr_scheduler(JConfiguration.from_dict(opt),
                              opt['lr_scheduler'])
  got = lr_schedulers.get_lr_scheduler(Configuration.from_dict(opt),
                                       opt['lr_scheduler'])
  assert [got(e) for e in range(8)] == [want(e) for e in range(8)]


@pytest.mark.parametrize('name', sorted(os.listdir(os.path.join(REPO,
                                                                'configs'))))
def test_config_loads_as_jax(name):
  path = os.path.join(REPO, 'configs', name)
  got = Configuration.from_json(path)
  want = JConfiguration.from_json(path)
  got.update({'num_epochs': '3', 'optimizer': '{"name": "RMSProp"}'})
  want.update({'num_epochs': '3', 'optimizer': '{"name": "RMSProp"}'})
  assert got.to_dict() == want.to_dict()
  assert got.to_param_dict(['num_epochs'], {'absent': 1}) == \
      want.to_param_dict(['num_epochs'], {'absent': 1})


@pytest.mark.parametrize('name', ['1-recnet.json', 'synthetic-recnet.json'])
def test_construct_recnet_from_config(name):
  """The model section, with the run's undersampling section threaded in as
  the runners do, builds the published RecNet with the JAX dc_lines_acc."""
  with open(os.path.join(REPO, 'configs', name)) as f:
    conf = json.load(f)
  section = dict(conf['model'], undersampling=conf['undersampling'])
  model = construct_model(section)
  want = jconstruct_model(JConfiguration.from_dict(section), 'RecNet')
  assert model.dc_lines_acc == want.dc_lines_acc == 8.0
  assert model.dc_zero_filled_input == want.dc_zero_filled_input
  assert (model.num_blocks, len(model.block_0.convs())) == (3, 3)
  assert model.block_1.conv_1.weight.shape == (32, 32, 3, 3)
  assert model.block_2.conv_2.weight.shape == (2, 32, 3, 3)


def test_runner_builds_synthetic_recnet_config():
  conf = Configuration.from_json(os.path.join(REPO, 'configs',
                                              'synthetic-recnet.json'))
  runner = Runner(conf, 'train', 'cpu')
  assert runner.model.dc_lines_acc == 8.0
  assert runner.optimizer.param_groups[0]['lr'] == 2e-4
  assert runner.optimizer.param_groups[0]['eps'] == 1e-8
  with pytest.raises(RuntimeError, match='CUDA') if \
      not torch.cuda.is_available() else _nothing():
    Runner(conf, 'train', 'cuda')


class _nothing:
  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


def test_cli_trains_validates_checkpoints_and_resumes(tmp_path):
  path = str(tmp_path / 'tiny.json')
  with open(path, 'w') as f:
    json.dump(_conf_dict(), f)
  log_dir = str(tmp_path / 'runs')
  runner = ttrain.main([path, '--device', 'cpu', '--log-dir', log_dir])
  assert runner.step == 2 and runner.device.type == 'cpu'
  run_dir, = glob.glob(os.path.join(log_dir, 'tiny_*'))
  ckpt, = glob.glob(os.path.join(run_dir, 'periodic-chkpt_*_2.ckpt'))
  assert glob.glob(os.path.join(run_dir, 'best_loss_MSE', '*.ckpt'))
  assert glob.glob(os.path.join(run_dir, 'config_*.json'))

  resumed = ttrain.main([path, '--device', 'cpu', '--resume', ckpt,
                         '--conf', 'num_epochs=2'])
  assert resumed.step == 4
  assert glob.glob(os.path.join(run_dir, 'periodic-chkpt_*_3.ckpt'))
  before = runner.model.state_dict()
  changed = [k for k, v in resumed.model.state_dict().items()
             if not torch.equal(v, before[k])]
  assert changed, 'the resumed epoch did not train'
  assert resumed.optimizer.state_dict()['state'][0]['step'].item() == 4


@pytest.mark.parametrize('g', [0.1, 1e-3, 1e-5, 1e-7])
def test_rmsprop_matches_optax(g):
  """Five steps of the config's RMSProp (lr 1e-3, alpha 0.99) against
  ``optax.rmsprop`` on gradients of magnitude ``g``: eps sits under the
  square root in both, so the steps agree to f32 rounding at every |g|
  (with eps outside the root the step is 3900x too large at 1e-7)."""
  import optax
  from csmri_refinement_tpu_torch.training import optimizers
  rng = np.random.RandomState(7)
  p0 = (rng.randn(3, 5) * 1e-3).astype(np.float32)   # f32 ulps of 1e-10
  grads = [(rng.randn(3, 5) * g).astype(np.float32) for _ in range(5)]
  tx = optax.rmsprop(1e-3, decay=0.99, eps=1e-8)
  p, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
  for gr in grads:
    upd, state = tx.update(jnp.asarray(gr), state, p)
    p = optax.apply_updates(p, upd)
  conf = Configuration.from_dict({'learning_rate': 1e-3, 'alpha': 0.99})
  param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
  opt = optimizers.get_optimizer(conf, 'RMSProp', [param])
  for gr in grads:
    param.grad = torch.from_numpy(gr)
    opt.step()
  want = np.asarray(p) - p0
  got = param.detach().numpy() - p0
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
