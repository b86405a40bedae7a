"""Segmentation training and the segmentation score (SIS) in the port
against the JAX package, on the CPU.

Narrow widths throughout: the U-Net of ``configs/3-train-segmentation-
unet.json`` (2 → 2 channels, 2 layers per scale, k3, BN, reflection,
``pixelshuffle``, no output activation, CrossEntropy, Adam 2e-4) cut to
encoders [8, 16, 32] and decoders [16, 8], on 32² Synthetic phantoms. The
JAX side is jitted; weights cross through ``utils/jax_weights.py``. One
module fixture trains both runners for three steps on the same batches,
validates both, and writes a JAX and a port checkpoint of the same
variables for the segmentation-score tests.

Tolerances: the U-Net 5e-4 (the JAX suite's bar,
``tests/test_conv_pallas.py:130``), BN running statistics as in
``tests/test_torch_port_models.py``, losses 1e-4 relative (the bar of
``tests/test_torch_port_train.py``), CrossEntropy 1e-6. Dice values and
class maps on the same variables are compared exactly: both sides compute
in f32 and differ in summation order only (~1e-6 of the logits), far below
the argmax margins of these inputs. Training parts after its first step
where rounding decides a gradient (``ADAM_SPREAD``'s comment).
"""

import copy
import functools
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
from csmri_refinement_tpu.data import transform_wrappers as jtw
from csmri_refinement_tpu.metrics import get_metric_fn as jget_metric_fn
from csmri_refinement_tpu.metrics import segmentation_metrics as jsm
from csmri_refinement_tpu.metrics.segmentation_score import (
    SegmentationScore as JSegmentationScore)
from csmri_refinement_tpu.models import criteria as jcriteria
from csmri_refinement_tpu.models import unet as junet
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu.training import build_runner as jbuild_runner
from csmri_refinement_tpu.training import prep as jprep
from csmri_refinement_tpu.utils import checkpoints as jcheckpoints
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import train as ttrain
from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.data import transform_wrappers as ttw
from csmri_refinement_tpu_torch.metrics import get_metric_fn
from csmri_refinement_tpu_torch.metrics import segmentation_metrics as tsm
from csmri_refinement_tpu_torch.metrics.segmentation_score import (
    SegmentationScore)
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import criteria
from csmri_refinement_tpu_torch.models import unet as tunet
from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.ops import undersample as tus
from csmri_refinement_tpu_torch.training import prep
from csmri_refinement_tpu_torch.training.adversarial_runner import (
    AdversarialRunner)
from csmri_refinement_tpu_torch.training.runner import Runner
from csmri_refinement_tpu_torch.utils import checkpoints
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH, STEPS = 32, 8, 3
UNET_ATOL = 5e-4
LOSS_RTOL = 1e-4
# After the first step the trajectories part where rounding decides a
# gradient's sign: on a phantom's constant background, max-pool near-ties
# and LeakyReLU's kink pick a side by rounding, and Adam's first steps are
# ±lr whatever a gradient's size. Measured over three steps at lr 2e-4:
# losses 1.6e-5 relative apart, 0.6% of the parameters more than 1e-4
# apart (worst 7.9e-4, four lr), train dice 4.7e-4 apart at the third step.
# So every parameter is held within 2·lr per step, 98% of them within 1e-4
# (a wrong gradient or update moves nearly all), the dice of the later
# steps within 2e-3 (a wrong forward or transform moves it by far more).
ADAM_SPREAD = 2 * 2e-4 * STEPS
PARAMS_CLOSE = 0.98
DICE_ATOL = 2e-3
CE_ATOL = 1e-6
# One train-mode forward's running statistics (test_torch_port_models.py)
STATS_RTOL, STATS_ATOL = 2e-5, 1e-6
GAN_SIZE, GAN_BATCH = 128, 4


def _seg_model(**overrides):
  with open(os.path.join(REPO, 'configs',
                         '3-train-segmentation-unet.json')) as f:
    model = json.load(f)['model']
  model.update(encode_filters=[8, 16, 32], decode_filters=[16, 8])
  model.update(overrides)
  return model


def _seg_conf_dict(**overrides):
  with open(os.path.join(REPO, 'configs',
                         '3-train-segmentation-unet.json')) as f:
    conf = json.load(f)
  conf.update(
      train_dataset='Synthetic', validation_dataset='Synthetic',
      synthetic={'image_size': SIZE, 'num_train': STEPS * BATCH,
                 'num_val': 4},
      model=_seg_model(), num_epochs=1, num_data_workers=0,
      use_tensorboard=False)
  conf.update(overrides)
  return conf


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
  return torch.from_numpy(np.array(a))


def _random_variables(init, *args, seed=0):
  """A flax variable tree of ``init``'s shapes (traced, not compiled) with
  seeded values: kernels at a 1/fan_in variance, and every bias, BN scale
  and running statistic off its init, so that BN folding and the merge BN
  are exercised."""
  rng = np.random.RandomState(seed)

  def fill(path, leaf):
    name, shape = path[-1].key, leaf.shape
    if name == 'kernel':
      value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ('scale', 'var'):
      value = rng.uniform(0.5, 1.5, shape)
    else:                                       # bias, mean
      value = 0.2 * rng.randn(*shape)
    return jnp.asarray(value, jnp.float32)
  shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
  return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_eval_and_train(model, variables, *args):
  """One jitted call: the eval-mode output, the train-mode output and the
  batch statistics one train-mode forward leaves."""
  def both(v, *a):
    train, updated = model.apply(v, *a, train=True, mutable=['batch_stats'])
    return model.apply(v, *a, train=False), train, updated['batch_stats']
  return jax.jit(both)(variables, *args)


def _stats(module):
  return {k: v.numpy().copy() for k, v in module.state_dict().items()
          if 'running' in k}


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize('fold', ['train', 'val'])
@pytest.mark.parametrize('case', ['segmentation', 'include_labels',
                                  'include_labels_downscale'])
def test_synthetic_items_equal_jax(case, fold):
  conf_d = _seg_conf_dict(synthetic={'image_size': SIZE, 'num_train': 3,
                                     'num_val': 2})
  if case != 'segmentation':
    conf_d.update(dataset_mode='reconstruction', application='reconstruction',
                  include_labels=True)
  if case == 'include_labels_downscale':
    conf_d['downscale'] = 2
  want = jload_dataset(JConfiguration.from_dict(conf_d), '/tmp', 'Synthetic',
                       fold)
  got = load_dataset(Configuration.from_dict(conf_d), 'Synthetic', fold)
  assert len(got) == len(want)
  keys = {'segmentation': {'inp', 'target', 'index'}}.get(
      case, {'gt', 'label', 'index'})
  for i in range(len(got)):
    assert set(got[i]) == set(want[i]) == keys
    for key in keys:
      assert got[i][key].dtype == want[i][key].dtype, key
      np.testing.assert_array_equal(got[i][key], want[i][key], err_msg=key)
  assert got[0][('target' if case == 'segmentation' else 'label')].any()


def test_batch_preparers_match_jax():
  """Segmentation batches pass through; reconstruction batches carry
  ``label`` and ``index`` untouched."""
  conf_d = _seg_conf_dict()
  host = next(iter(DataLoader(load_dataset(
      Configuration.from_dict(conf_d), 'Synthetic', 'val'), 4)))
  preparer = prep.get_batch_preparer(Configuration.from_dict(conf_d), 'cpu')
  assert isinstance(preparer, prep.SegBatchPreparer)
  want = jprep.get_batch_preparer(JConfiguration.from_dict(conf_d))
  for got_b, want_b in ((preparer.prepare_train(None, host),
                         want.prepare_train(None, host)),
                        (preparer.prepare_val(host), want.prepare_val(host))):
    assert set(got_b) == set(want_b) == {'inp', 'target'}
    for key in got_b:
      np.testing.assert_array_equal(got_b[key].numpy(), want_b[key])

  conf_d.update(dataset_mode='reconstruction', application='reconstruction',
                include_labels=True)
  host = next(iter(DataLoader(load_dataset(
      Configuration.from_dict(conf_d), 'Synthetic', 'val'), 4)))
  preparer = prep.get_batch_preparer(Configuration.from_dict(conf_d), 'cpu')
  for batch in (preparer.prepare_train(torch.Generator().manual_seed(0),
                                       host),
                preparer.prepare_val(host)):
    assert {'inp', 'kspace', 'mask', 'target', 'label', 'index'} <= set(batch)
    np.testing.assert_array_equal(batch['label'].numpy(), host['label'])
    np.testing.assert_array_equal(batch['index'].numpy(), host['index'])


# --- models ------------------------------------------------------------------


@pytest.mark.parametrize('k', [2, 3])
def test_conv_transpose_bridge_flips_the_kernel(k):
  """flax ``ConvTranspose`` (stride 2, VALID) against the bridged
  ``nn.ConvTranspose2d`` on a kernel with no spatial symmetry."""
  import flax.linen as fnn
  rng = np.random.RandomState(k)
  x = rng.randn(2, 5, 6, 3).astype(np.float32)
  kernel = rng.randn(k, k, 3, 4).astype(np.float32)
  bias = rng.randn(4).astype(np.float32)
  layer = fnn.ConvTranspose(4, (k, k), strides=(2, 2), padding='VALID')
  want = layer.apply({'params': {'kernel': kernel, 'bias': bias}}, x)
  port = torch.nn.ConvTranspose2d(3, 4, k, stride=2)
  load_flax_variables(port, {'params': {'kernel': kernel, 'bias': bias}})
  with torch.no_grad():
    got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  assert got.shape == want.shape == (2, 2 * 5 + k - 2, 2 * 6 + k - 2, 4)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


DECODER_CASES = {
    'pixelshuffle': dict(mode='pixelshuffle'),
    'transposed_k2': dict(mode='transposed', transposed_kernel_size=2),
    'transposed_k3': dict(mode='transposed', transposed_kernel_size=3),
}


@functools.lru_cache(maxsize=None)
def _decoder_case(case):
  """One decode unit (up-sampling, pad-to-target, skip concat, merge BN,
  the 2-layer chain) with an odd-sized skip path, through JAX."""
  kw = DECODER_CASES[case]
  rng = np.random.RandomState(11)
  dec = rng.randn(2, 8, 8, 16).astype(np.float32)
  enc = rng.randn(2, 17, 17, 8).astype(np.float32)
  jmodel = junet.ConvDecodeUnit(
      16, 8, 8, 0.1, True, kernel_size=3, num_layers=2, padding='reflection',
      mode=kw['mode'], transposed_kernel_size=kw.get(
          'transposed_kernel_size', 2), conv_init=jax.nn.initializers.zeros,
      conv_transposed_init=jax.nn.initializers.zeros,
      bias_init=jax.nn.initializers.zeros, bn_init=jax.nn.initializers.ones)
  variables = _random_variables(jmodel.init, dec, enc, seed=1)
  port = tunet.ConvDecodeUnit(16, 8, 8, 0.1, True, kernel_size=3,
                              num_layers=2, padding='reflection', **kw)
  return (port, variables, (dec, enc),
          _jax_eval_and_train(jmodel, variables, dec, enc))


UNET_MODES = ('pixelshuffle', 'transposed')


@functools.lru_cache(maxsize=None)
def _unet_case(mode):
  """The narrow segmentation U-Net through JAX."""
  section = _seg_model(upsampling_mode=mode)
  x = np.random.RandomState(3).randn(2, SIZE, SIZE, 2).astype(np.float32)
  jmodel = junet.UNET(**{k: v for k, v in section.items() if k != 'name'})
  variables = _random_variables(jmodel.init, x, seed=2)
  return (construct_model(section), variables, (x,),
          _jax_eval_and_train(jmodel, variables, x))


def _check_against_jax(case, train, shape, merge_bns):
  """The port module of ``case`` with its JAX variables: its output within
  UNET_ATOL, and after a train-mode forward every BN's running mean and
  variance as flax leaves them."""
  port, variables, inputs, (want_eval, want_train, updated) = case
  port = copy.deepcopy(port)
  load_flax_variables(port, _np(variables))
  with torch.no_grad():
    got = port.train(train)(*[_t(a) for a in inputs])
  want = want_train if train else want_eval
  assert got.shape == want.shape == shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=UNET_ATOL)
  if train:
    ref = copy.deepcopy(port)
    load_flax_variables(ref, _np({'params': variables['params'],
                                  'batch_stats': updated}))
    want_stats, got_stats = _stats(ref), _stats(port)
    assert got_stats.keys() == want_stats.keys()
    assert sum('merge_bn' in k for k in got_stats) == 2 * merge_bns
    for name, value in want_stats.items():
      np.testing.assert_allclose(got_stats[name], value, rtol=STATS_RTOL,
                                 atol=STATS_ATOL, err_msg=name)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case', sorted(DECODER_CASES))
def test_decoder_matches_jax(case, train):
  _check_against_jax(_decoder_case(case), train, (2, 17, 17, 8), 1)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('mode', UNET_MODES)
def test_unet_matches_jax(mode, train):
  """The narrow segmentation U-Net: logits, and after one train-mode
  forward every BN's running mean and variance (merge BNs included)."""
  _check_against_jax(_unet_case(mode), train, (2, SIZE, SIZE, 2), 2)


def test_conv_transposed_init_law():
  """he_normal(0.1) over the flax kernel's fan_in Cin·k·k (the torch
  weight's own fan would be Cout·k·k), the bias at the conv bias init."""
  unet = construct_model(_seg_model(upsampling_mode='transposed',
                                    encode_filters=[16, 64],
                                    decode_filters=[8]))
  unet.init_weights(torch.Generator().manual_seed(0))
  conv = unet.decode_0.up_conv
  assert isinstance(conv, torch.nn.ConvTranspose2d)
  cin, cout, k, _ = conv.weight.shape
  assert (cin, cout, k) == (64, 8, 2)
  std = np.sqrt(2.0 / (1 + 0.1 ** 2)) / np.sqrt(cin * k * k)
  assert abs(conv.weight.std().item() / std - 1) < 0.1
  assert conv.bias is None          # BN and a skip path: no bias (JAX)
  fixed = construct_model(_seg_model(
      upsampling_mode='transposed', weight_init={
          'conv_transposed_weight': ['constant', 0.5]}))
  fixed.init_weights(torch.Generator().manual_seed(0))
  assert bool((fixed.decode_0.up_conv.weight == 0.5).all())


@pytest.mark.parametrize('overrides', [
    {'upsampling_mode': 'bilinear'}, {'upsampling_mode': 'nn-biresize-conv'},
    {'use_refinement': True}, {'encoder_features': [0]}, {'remat': True}],
    ids=['bilinear', 'nn-biresize-conv', 'use_refinement',
         'encoder_features', 'remat'])
def test_unported_unet_options_raise(overrides):
  with pytest.raises(NotImplementedError, match=str(
      overrides.get('upsampling_mode', next(iter(overrides))))):
    construct_model(_seg_model(**overrides))


# --- loss, output transform, dice ---------------------------------------------


def test_cross_entropy_matches_jax():
  rng = np.random.RandomState(4)
  logits = 3 * rng.randn(2, 8, 8, 3).astype(np.float32)
  labels = rng.randint(0, 3, (2, 8, 8)).astype(np.int64)
  want = float(jcriteria.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(labels)))
  got = criteria.cross_entropy_loss(_t(logits), _t(labels)).item()
  assert abs(got - want) <= CE_ATOL


@pytest.mark.parametrize('target_dims', [3, 4])
def test_segmentation_output_transform_matches_jax(target_dims):
  rng = np.random.RandomState(5)
  logits = rng.randn(2, 8, 8, 3).astype(np.float32)
  target = rng.randint(0, 3, (2, 8, 8) + (1,) * (target_dims - 3))
  want = jtw.get_output_transform(None, 'segmentation', 'test')(logits,
                                                                target)
  got = ttw.get_output_transform('segmentation')(_t(logits), _t(target))
  for g, w in zip(got, want):
    assert g.shape == w.shape == (2, 8, 8, 1)
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _class_maps():
  """Random 3-class maps where class 2 is absent from both and class 3 is
  outside the range, so absent-class conventions decide some scores."""
  rng = np.random.RandomState(6)
  pred = rng.randint(0, 2, (1, 16, 16, 1))
  target = rng.randint(0, 2, (1, 16, 16, 1))
  target[0, :4] = 0
  return pred, target


@pytest.mark.parametrize('absent_value', [0.0, 1.0])
def test_dice_matches_jax(absent_value):
  pred, target = _class_maps()
  for class_idx in range(4):
    want = jsm.compute_dice(pred, target, class_idx, absent_value)
    got = tsm.compute_dice(_t(pred), _t(target), class_idx, absent_value)
    assert got == want, class_idx
  assert tsm.compute_dice(_t(pred), _t(target), 2, absent_value) == \
      absent_value
  for num_classes in (2, 3, 4):
    for excluded in (-1, 0):
      want = jsm.compute_average_dice(pred, target, num_classes, excluded,
                                      absent_value)
      got = tsm.compute_average_dice(_t(pred), _t(target), num_classes,
                                     excluded, absent_value)
      assert got == want, (num_classes, excluded)


@pytest.mark.parametrize('metric', ['dice_class_0', 'dice_class_1',
                                    'dice_class_2', 'dice'])
@pytest.mark.parametrize('exclude_background', [False, True])
def test_dice_registry_matches_jax(metric, exclude_background):
  conf_d = {'application': 'segmentation',
            'dice_metric': {'num_classes': 3,
                            'exclude_background': exclude_background}}
  rng = np.random.RandomState(7)
  logits = rng.randn(3, 8, 8, 3).astype(np.float32)
  target = rng.randint(0, 2, (3, 8, 8))
  want = jget_metric_fn(JConfiguration.from_dict(conf_d), metric, 'test')(
      {'pred': logits}, {'target': target})
  got = get_metric_fn(Configuration.from_dict(conf_d), metric)(
      {'pred': _t(logits)}, {'target': _t(target)})
  assert got.value == want.value and got.num_updates == want.num_updates


def test_dice_registry_needs_its_section():
  for conf_d in ({'application': 'segmentation'},
                 {'application': 'segmentation', 'dice_metric': {}}):
    with pytest.raises(AssertionError):
      jget_metric_fn(JConfiguration.from_dict(conf_d), 'dice', 'test')
    with pytest.raises(ValueError):
      get_metric_fn(Configuration.from_dict(conf_d), 'dice')


# --- training, validation, checkpoints ------------------------------------------


def _host_batches(conf_d, fold, n, batch):
  data = load_dataset(Configuration.from_dict(conf_d), 'Synthetic', fold)
  return [{k: np.stack([data[j][k] for j in range(i * batch,
                                                    (i + 1) * batch)])
           for k in ('inp', 'target')} for i in range(n)]


@pytest.fixture(scope='module')
def seg_record(tmp_path_factory):
  """Three training steps of both runners on the same batches, from the JAX
  init; both validations on the JAX final state; a JAX checkpoint and a
  port checkpoint of those variables."""
  conf_d = _seg_conf_dict()
  jrunner = jbuild_runner(JConfiguration.from_dict(conf_d), 'standard',
                          'train')
  trunner = Runner(Configuration.from_dict(conf_d), 'train', 'cpu')
  batches = _host_batches(conf_d, 'train', STEPS, BATCH)
  jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
  jrunner._ensure_initialized(jbatches[0])
  jrunner.state.update(_random_variables(jrunner.model.init,
                                         jbatches[0]['inp'], seed=3))
  jrunner.state['opt_state'] = jrunner.tx.init(jrunner.state['params'])
  load_flax_variables(trunner.model, _np({
      'params': jrunner.state['params'],
      'batch_stats': jrunner.state['batch_stats']}))

  record = {'steps': []}
  for step, (host, jb) in enumerate(zip(batches, jbatches)):
    jrunner.state, jlosses, jout = jrunner._train_step_fn(
        jrunner.state, jb, jax.random.PRNGKey(step))
    jmetrics = jrunner._compute_metrics(jrunner.train_metric_fns, jout, jb)
    tb = trunner.preparer.prepare_train(None, host)
    tlosses, tout = trunner.train_batch(tb)
    tmetrics = trunner._compute_train_metrics((tb, tout))
    record['steps'].append(({k: float(v) for k, v in jlosses.items()},
                            {k: v.item() for k, v in tlosses.items()},
                            {k: m.value for k, m in jmetrics.items()},
                            {k: m.value for k, m in tmetrics.items()}))

  final = _np({'params': jrunner.state['params'],
               'batch_stats': jrunner.state['batch_stats']})
  record['params'] = (copy.deepcopy(trunner.model), final)
  load_flax_variables(trunner.model, final)
  val_conf = JConfiguration.from_dict(conf_d)
  jval = JDataLoader(jload_dataset(val_conf, '/tmp', 'Synthetic', 'val'), 2)
  _, jval_losses, jval_metrics = jrunner.validate(jval)
  tval = DataLoader(load_dataset(Configuration.from_dict(conf_d),
                                 'Synthetic', 'val'), 2)
  tval_losses, tval_metrics = trunner.validate(tval)
  record['val'] = ({k: m.value for k, m in {**jval_losses,
                                            **jval_metrics}.items()},
                   {k: m.value for k, m in {**tval_losses,
                                            **tval_metrics}.items()})

  tmp = tmp_path_factory.mktemp('seg')
  jckpt, tckpt = str(tmp / 'jax.ckpt'), str(tmp / 'port.ckpt')
  jcheckpoints.save_checkpoint(jckpt, val_conf, jrunner, STEPS, {})
  checkpoints.save_checkpoint(tckpt, Configuration.from_dict(conf_d),
                              trunner, STEPS, {})
  record.update(conf=conf_d, jckpt=jckpt, tckpt=tckpt, tmp=tmp,
                model=trunner.model)
  return record


def test_segmentation_training_matches_jax(seg_record):
  """Losses of every step within LOSS_RTOL; after three steps every
  parameter within ADAM_SPREAD and nearly all within LOSS_RTOL."""
  for step, (jlosses, tlosses, _, _) in enumerate(seg_record['steps']):
    assert set(tlosses) == set(jlosses) == {'CrossEntropy', 'loss'}
    for name, want in jlosses.items():
      assert abs(tlosses[name] - want) <= LOSS_RTOL * abs(want), (step, name)
  port, final = seg_record['params']
  want = copy.deepcopy(port)
  load_flax_variables(want, final)
  want = want.state_dict()
  close = total = 0
  for name, value in port.state_dict().items():
    if name.endswith('num_batches_tracked'):
      continue
    diff = (value - want[name]).abs()
    assert diff.max().item() <= ADAM_SPREAD, name
    close += int((diff <= LOSS_RTOL).sum())
    total += diff.numel()
  assert close >= PARAMS_CLOSE * total, close / total


def test_segmentation_train_and_val_dice_match_jax(seg_record):
  """Train dice: equal at the first step (the same weights), within
  DICE_ATOL after it; validation dice on the same variables: equal."""
  for step, (_, _, jmetrics, tmetrics) in enumerate(seg_record['steps']):
    assert set(tmetrics) == set(jmetrics) == {'dice_class_0', 'dice_class_1'}
    for name, want in jmetrics.items():
      if step == 0:
        assert tmetrics[name] == want, name
      assert abs(tmetrics[name] - want) <= DICE_ATOL, (step, name)
  jval, tval = seg_record['val']
  assert set(tval) == {'loss_CrossEntropy', 'dice_class_0', 'dice_class_1'}
  assert set(jval) == set(tval)
  for name in ('dice_class_0', 'dice_class_1'):
    assert tval[name] == jval[name], name
  want = jval['loss_CrossEntropy']
  assert abs(tval['loss_CrossEntropy'] - want) <= LOSS_RTOL * abs(want)


def _sis_inputs(conf_d, n=6, noise=0.05):
  """Reconstructions (the ground truth as complex, plus noise) and their
  label maps, from the Synthetic validation phantoms."""
  data = load_dataset(Configuration.from_dict(dict(
      conf_d, synthetic={'image_size': SIZE, 'num_val': n})),
                      'Synthetic', 'val')
  rng = np.random.RandomState(8)
  pred = np.stack([data[i]['inp'] for i in range(n)])
  pred = (pred + noise * rng.randn(*pred.shape)).astype(np.float32)
  return pred, np.stack([data[i]['target'] for i in range(n)])


@pytest.fixture(scope='module')
def jax_sis(seg_record):
  """The JAX SegmentationScore network, loaded from the JAX checkpoint and
  compiled for one 32² example; ``make(**kw)`` builds a JAX
  SegmentationScore that shares it (the network is the same for every
  option, and each instance would compile its own)."""
  model = seg_record['conf']['model']
  model_conf = JConfiguration.from_dict(dict(
      model, pretrained_weights=[seg_record['jckpt'], 'model']))
  first = JSegmentationScore(model_conf, None, class_idx=1)
  pred, target = _sis_inputs(seg_record['conf'], n=1)
  first(pred, target)

  def make(**kw):
    score = JSegmentationScore(model_conf, None, **kw)
    score.state, score._predict = first.state, first._predict
    return score
  return make


def _port_sis(seg_record, **kw):
  return SegmentationScore(dict(seg_record['conf']['model'],
                                pretrained_weights=[seg_record['tckpt'],
                                                    'model']), None, **kw)


@pytest.mark.parametrize('class_idx', [1, [0, 1]], ids=['1', '0_1'])
def test_segmentation_score_matches_jax(seg_record, jax_sis, class_idx):
  """Per-example scores and class maps; the port runs the batch at once."""
  jscore = jax_sis(class_idx=class_idx)
  tscore = _port_sis(seg_record, class_idx=class_idx)
  pred, target = _sis_inputs(seg_record['conf'])
  want = [jscore(pred[i:i + 1], target[i:i + 1]) for i in range(len(pred))]
  got = tscore(_t(pred), _t(target))
  assert got == want and len(set(want)) > 1
  want_maps = np.concatenate([np.asarray(jscore._predict(
      jscore.state, jnp.asarray(pred[i:i + 1]))) for i in range(len(pred))])
  np.testing.assert_array_equal(tscore.predict(_t(pred)).numpy(), want_maps)


def test_segmentation_score_skips_empty_images_and_saves_maps(seg_record,
                                                              jax_sis):
  """``skip_empty_images``: an example without the class scores None, is
  not run and is not saved; the saved uint8 maps equal JAX's."""
  pred, target = _sis_inputs(seg_record['conf'], n=4)
  target[1] = 0
  dirs = {side: str(seg_record['tmp'] / side / 'segmentations')
          for side in ('jax', 'port')}
  for path in dirs.values():
    os.makedirs(os.path.dirname(path))
  jscore = jax_sis(class_idx=1, save_segmentations_path=dirs['jax'],
                   skip_empty_images=True)
  want = [jscore(pred[i:i + 1], target[i:i + 1]) for i in range(len(pred))]
  got = _port_sis(seg_record, class_idx=1,
                  save_segmentations_path=dirs['port'],
                  skip_empty_images=True)(_t(pred), _t(target))
  assert got == want
  assert got[1] is None and None not in got[::2]
  names = sorted(os.listdir(dirs['jax']))
  assert names == sorted(os.listdir(dirs['port'])) == [
      '0001_segm.npy', '0002_segm.npy', '0003_segm.npy']
  for name in names:
    want_map = np.load(os.path.join(dirs['jax'], name))
    got_map = np.load(os.path.join(dirs['port'], name))
    assert got_map.dtype == want_map.dtype == np.uint8
    np.testing.assert_array_equal(got_map, want_map)
  metric = get_metric_fn(Configuration.from_dict({
      'application': 'reconstruction', 'segmentation_score_metric': {
          'model': dict(seg_record['conf']['model'], pretrained_weights=[
              seg_record['tckpt'], 'model']),
          'class': 1, 'skip_empty_images': True}}), 'segmentation_score')
  value = metric({'pred': _t(pred)}, {'label': _t(target)})
  assert value.num_updates == 3
  assert value.value == pytest.approx(np.mean([want[i] for i in (0, 2, 3)]))


@pytest.mark.parametrize('overrides', [
    {}, {'target_key': 'target', 'transform': 'reconstruction'},
    {'pred_key': 'pretrained', 'transform': 'none'}],
    ids=['defaults', 'target_and_transform', 'pred_key'])
def test_segmentation_score_registry_matches_jax(seg_record, jax_sis,
                                                 overrides):
  """``segmentation_score`` reads ``label`` without a transform unless its
  section overrides them (JAX ``metrics/__init__.py:176-205``)."""
  section = dict(overrides, model=dict(
      seg_record['conf']['model'],
      pretrained_weights=[seg_record['tckpt'], 'model']), **{'class': 1})
  conf_d = {'application': 'reconstruction',
            'segmentation_score_metric': section}
  want = jget_metric_fn(JConfiguration.from_dict(conf_d),
                        'segmentation_score', 'test')
  got = get_metric_fn(Configuration.from_dict(conf_d), 'segmentation_score')
  assert (got.pred_key, got.target_key) == (want.pred_key, want.target_key)
  assert (got.transform is None) == (want.transform is None)
  if got.transform is not None:
    assert got.transform is ttw.rec_output_transform
  assert got.metric_fn.class_idxs == want.metric_fn.class_idxs == [1]
  if not overrides:
    want.metric_fn = jax_sis(class_idx=1)
    pred, target = _sis_inputs(seg_record['conf'])
    value = got({'pred': _t(pred)}, {'label': _t(target)})
    assert value.value == want({'pred': pred}, {'label': target}).value


def test_segmentation_cli_keeps_the_best_checkpoint(tmp_path):
  """The CLI on the segmentation config (Synthetic, narrow widths, CPU):
  one epoch, a validation, the best checkpoint by dice_class_1, which the
  segmentation score loads."""
  conf_d = _seg_conf_dict(synthetic={'image_size': SIZE, 'num_train': 16,
                                     'num_val': 4})
  path = tmp_path / 'seg.json'
  path.write_text(json.dumps(conf_d))
  runner = ttrain.main([str(path), '--device', 'cpu', '--log-dir',
                        str(tmp_path / 'runs')])
  assert runner.step == 2
  best = glob.glob(str(tmp_path / 'runs' / '*' / 'best_dice_class_1' /
                       '*.ckpt'))
  assert len(best) == 1
  state = checkpoints.load_model_state_dict(best[0], 'model')
  assert state.keys() == runner.model.state_dict().keys()
  score = SegmentationScore(dict(conf_d['model'], pretrained_weights=[
      best[0], 'model']), None, class_idx=1)
  pred, target = _sis_inputs(conf_d, n=2)
  assert all(0 <= v <= 1 for v in score(_t(pred), _t(target)))
  for name, value in score.model.state_dict().items():
    assert torch.equal(value, state[name]), name


# --- the segmentation score in the GAN runner's validation ---------------------


def _gan_conf_dict(seg_record):
  return {
      'seed': 1,
      'train_dataset': 'Synthetic', 'validation_dataset': 'Synthetic',
      'synthetic': {'image_size': GAN_SIZE, 'num_train': 4,
                    'num_val': GAN_BATCH},
      'include_labels': True,
      'undersampling': {'sampling_scheme': 'varden',
                        'acceleration_factor': 4},
      'runner_type': 'adversarial', 'application': 'reconstruction',
      'generator_model': {
          'name': 'RefinementWrapper', 'mode': 'real-penalty-add',
          'input_mode': 'output',
          'pretrained_model': {'name': 'RecNet', 'num_blocks': 1,
                               'num_convs': 2, 'num_filters': 4},
          'learnable_model': {
              'name': 'UNET', 'num_inputs': 2, 'num_outputs': 1,
              'num_layers_per_scale': 1, 'encode_filters': [4, 8],
              'decode_filters': [4], 'kernel_size': 4,
              'upsampling_mode': 'nn-resize-conv',
              'output_activation': 'none', 'padding': 'reflection',
              'decoder_act_upsampling_only': True}},
      'discriminator_model': {
          'num_inputs': 1, 'input_method': 'simple-magnitude',
          'num_filters_per_layer': [8, 16, 16], 'strides': [2, 2, 1],
          'kernel_sizes': 4, 'final_conv_kernel_size': 4,
          'padding': 'reflection', 'act_fn': 'lrelu',
          'relu_leakiness': 0.2, 'dropout_after': [],
          'use_norm_layers': True, 'norm_layer': 'batch'},
      'generator_adversarial_losses': ['gan'],
      'generator_losses': ['MSE'],
      'discriminator_losses': ['gan'],
      'generator_optimizer': {'name': 'Adam', 'learning_rate': 0.0002},
      'discriminator_optimizer': {'name': 'Adam', 'learning_rate': 0.0002},
      'batch_size': GAN_BATCH,
      'validation_metrics': ['psnr', 'ssim', 'segmentation_score'],
      'segmentation_score_metric': {'model': dict(
          seg_record['conf']['model'],
          pretrained_weights=[seg_record['tckpt'], 'model']), 'class': 1},
  }


def test_gan_validation_segmentation_score_matches_jax(seg_record):
  """The GAN runner's validation scores its generator's output with the
  segmentation network against the batch's labels; the JAX runner reads
  the JAX checkpoint of the same variables."""
  conf_d = _gan_conf_dict(seg_record)
  jconf_d = copy.deepcopy(conf_d)
  jconf_d['segmentation_score_metric']['model']['pretrained_weights'] = [
      seg_record['jckpt'], 'model']
  data = load_dataset(Configuration.from_dict(conf_d), 'Synthetic', 'val')
  gt = np.stack([data[i]['gt'] for i in range(GAN_BATCH)])
  label = np.stack([data[i]['label'] for i in range(GAN_BATCH)])
  mask = np.array(jmasks.cartesian_mask(jax.random.PRNGKey(0),
                                        (GAN_BATCH, GAN_SIZE, GAN_SIZE), 4.0))
  jb = dict(jus.undersample_batch(None, jnp.asarray(gt), fixed_mask=mask),
            label=jnp.asarray(label))
  tb = dict(tus.undersample_batch(None, _t(gt), fixed_mask=mask),
            label=_t(label))

  jrunner = jbuild_runner(JConfiguration.from_dict(jconf_d), 'adversarial',
                          'train')
  trunner = AdversarialRunner(Configuration.from_dict(conf_d), 'train', 'cpu')
  jrunner._ensure_initialized(jb)
  for module, state in ((trunner.gen, jrunner.gen_state),
                        (trunner.disc, jrunner.disc_state)):
    load_flax_variables(module, _np({'params': state['params'],
                                     'batch_stats': state['batch_stats']}))
  jdata = (jb,) + tuple(jrunner._val_step_fn(jrunner.gen_state,
                                             jrunner.disc_state, jb)[:3])
  want = {k: m.value for k, m in jrunner._compute_test_metrics(jdata).items()}

  class FixedPreparer:
    def prepare_val(self, host_batch):
      return tb
  trunner.preparer = FixedPreparer()
  _, tdata = trunner._val_step(None)
  got = {k: m.value for k, m in trunner._compute_test_metrics(tdata).items()}
  assert {'gen_psnr', 'gen_ssim', 'gen_segmentation_score'} <= set(got)
  assert set(got) == set(want)
  assert got['gen_segmentation_score'] == want['gen_segmentation_score']
  assert 0 < got['gen_segmentation_score'] < 1
  assert abs(got['gen_psnr'] - want['gen_psnr']) <= 1e-3


def test_port_imports_no_jax_in_the_segmentation_modules():
  import subprocess
  import sys
  code = ('import sys; before = set(sys.modules); '
          'import csmri_refinement_tpu_torch.metrics.segmentation_score, '
          'csmri_refinement_tpu_torch.metrics.segmentation_metrics, '
          'csmri_refinement_tpu_torch.data.datasets, '
          'csmri_refinement_tpu_torch.training.prep; '
          'bad = [m for m in set(sys.modules) - before if m.split(".")[0] in '
          '("jax", "flax", "csmri_refinement_tpu")]; '
          'assert not bad, bad')
  subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True)


def test_weight_inits_know_the_transposed_conv():
  inits = weight_inits.resolve_inits()
  assert inits['conv_transposed_weight'] == ('he_normal', 0.0)
  assert inits['conv_transposed_bias'] == ('constant', 0.0)
