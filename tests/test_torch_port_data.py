"""The port's data path and checkpoint reader against the JAX package.

Analyze volumes, ScarSeg items (512² source volumes of one or two slices
per case written by ``write_scarseg_phantoms``, since the k-space crop to
``512 / downscale`` needs the 512² source; a 52-slice tree at 8² for the
slice names), the loader's batches and its prefetch queue, the msgpack
decoder on checkpoints the JAX package's own ``save_checkpoint`` writes,
and the port's runners restored from those checkpoints against the JAX
runners' ``predict``. The JAX side is jitted; flax variables are the JAX
runners' trees refilled with seeded numpy values (kernels at a 1/fan_in
variance, biases, BN scales and statistics and the wrapper's scale off
their inits).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import deploy_checkpoint
from csmri_refinement_tpu.data import DataLoader as JDataLoader
from csmri_refinement_tpu.data import analyze_io as janalyze_io
from csmri_refinement_tpu.data import datasets as jdatasets
from csmri_refinement_tpu.metrics.metric import MaxMetric as JMaxMetric
from csmri_refinement_tpu.metrics.metric import MinMetric as JMinMetric
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu.training import build_runner as jbuild_runner
from csmri_refinement_tpu.training import prep as jprep
from csmri_refinement_tpu.utils import checkpoints as jcheckpoints
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.data import analyze_io, datasets
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.ops import undersample as tus
from csmri_refinement_tpu_torch.training import build_runner, prep
from csmri_refinement_tpu_torch.utils import checkpoints, flax_msgpack
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

SIZE, BATCH = 64, 2
RECNET_ATOL = 2e-4      # tests/test_dc_pallas.py:26
UNET_ATOL = 5e-4        # tests/test_conv_pallas.py:130


def recnet_conf(**overrides):
  """A narrow configs/1-recnet.json on ScarSeg at downscale 8 (64²)."""
  base = {
      'seed': 0, 'run_name': 'tiny-recnet',
      'train_dataset': 'ScarSeg', 'validation_dataset': 'ScarSeg',
      'downscale': 8,
      'undersampling': {'sampling_scheme': 'varden',
                        'acceleration_factor': 8,
                        'variable_acceleration': False},
      'runner_type': 'standard', 'application': 'reconstruction',
      'model': {'name': 'RecNet', 'num_blocks': 2, 'num_convs': 2,
                'num_filters': 8},
      'loss_name': 'MSE',
      'optimizer': {'name': 'Adam', 'learning_rate': 0.0002},
      'num_epochs': 1, 'batch_size': BATCH, 'num_data_workers': 0,
      'validation_metrics': ['psnr', 'ssim'],
  }
  base.update(overrides)
  return base


def seg_model():
  return {'name': 'UNET', 'num_inputs': 2, 'num_outputs': 2,
          'num_layers_per_scale': 2, 'encode_filters': [4, 8, 16],
          'decode_filters': [8, 4], 'use_bn': True,
          'upsampling_mode': 'pixelshuffle', 'padding': 'reflection',
          'output_activation': 'none'}


def seg_conf(**overrides):
  """A narrow configs/3-train-segmentation-unet.json on ScarSeg (64²)."""
  base = recnet_conf(run_name='tiny-seg', dataset_mode='segmentation',
                     application='segmentation', model=seg_model(),
                     loss_name='CrossEntropy',
                     validation_metrics=['dice_class_0', 'dice_class_1'])
  base.update(overrides)
  return base


def gan_conf(**overrides):
  """A narrow configs/2-refinement.json (the tiny GAN of
  tests/test_torch_port_gan.py) on ScarSeg (64²), without its VGG19 loss
  (no network of a checkpoint; it would only slow the JAX runner's
  build)."""
  base = recnet_conf(
      seed=1, run_name='tiny-gan', runner_type='adversarial',
      generator_model={
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
      discriminator_model={
          'num_inputs': 1, 'input_method': 'simple-magnitude',
          'num_filters_per_layer': [8, 16, 16], 'strides': [2, 2, 1],
          'kernel_sizes': 4, 'final_conv_kernel_size': 4,
          'padding': 'reflection', 'act_fn': 'lrelu',
          'relu_leakiness': 0.2, 'dropout_after': [], 'dropout_prob': 0.5,
          'use_norm_layers': 'not-first', 'norm_layer': 'batch',
          'compute_features': True, 'use_image_pool': True,
          'image_pool_size': 8},
      generator_adversarial_losses=['gan', 'FeatureMatching'],
      generator_losses=['FeaturePenalty'],
      generator_loss_weights={'gan': 0.5, 'FeaturePenalty': 2},
      discriminator_losses=['gan'],
      feature_penalty={'criterion': 'L1',
                       'input_key': 'prescaled_refinement'},
      generator_optimizer={'name': 'Adam', 'learning_rate': 0.0002,
                           'beta1': 0.5},
      discriminator_optimizer={'name': 'Adam', 'learning_rate': 0.0002,
                               'beta1': 0.5})
  del base['model'], base['loss_name'], base['optimizer']
  base.update(overrides)
  return base


def randomize(tree, seed):
  """``tree`` (a flax variable collection) refilled with seeded values."""
  rng = np.random.RandomState(seed)

  def fill(path, leaf):
    name, shape = path[-1].key, leaf.shape
    if name == 'kernel':
      value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
    elif name in ('scale', 'var'):
      value = rng.uniform(0.5, 1.5, shape)
    else:                                        # bias, mean
      value = 0.2 * rng.randn(*shape)
    return jnp.asarray(value, leaf.dtype)
  return jax.tree_util.tree_map_with_path(fill, tree)


def rec_batch(n=BATCH, size=SIZE, seed=0):
  """(JAX, port) prepared reconstruction batches of phantoms with the
  same varden 8x line masks."""
  gt = datasets._make_phantoms(n, size, seed)[0]
  mask = np.array(jmasks.cartesian_mask(jax.random.PRNGKey(seed),
                                        (n, size, size), 8.0))
  return (jus.undersample_batch(None, jnp.asarray(gt), fixed_mask=mask),
          tus.undersample_batch(None, torch.from_numpy(gt),
                                fixed_mask=mask))


def seg_batch(n=BATCH, size=SIZE, seed=0):
  images, labels = datasets._make_phantoms(n, size, seed)
  inp = np.stack([images, np.zeros_like(images)], -1)
  return ({'inp': jnp.asarray(inp), 'target': jnp.asarray(labels)},
          {'inp': torch.from_numpy(inp), 'target': torch.from_numpy(labels)})


def jax_checkpoint(path, conf_d, seed=0):
  """A JAX runner of ``conf_d`` in train mode, initialized on one batch,
  its networks refilled with seeded values, saved with the JAX package's
  ``save_checkpoint``. Returns (the runner, its prepared JAX batch)."""
  jconf = JConfiguration.from_dict(conf_d)
  runner = jbuild_runner(jconf, conf_d['runner_type'], 'train')
  seg = conf_d.get('dataset_mode') == 'segmentation'
  jbatch = (seg_batch if seg else rec_batch)()[0]
  runner._ensure_initialized(jbatch)
  states = [runner.state] if conf_d['runner_type'] == 'standard' else \
      [runner.gen_state, runner.disc_state]
  for i, state in enumerate(states):
    for key in ('params', 'batch_stats'):
      state[key] = randomize(state[key], seed + 10 * i + len(key))
  jcheckpoints.save_checkpoint(path, jconf, runner, 3,
                               {'psnr': JMaxMetric(31.5),
                                'loss_MSE': JMinMetric(0.25)})
  return runner, jbatch


@pytest.fixture(scope='module')
def jax_checkpoints(tmp_path_factory):
  """{'recnet', 'gan', 'seg', 'recnet_scan', 'deploy'}: (path, conf dict,
  JAX runner, JAX batch) of checkpoints the JAX package wrote
  ('recnet_scan': a use_scan RecNet, its blocks stacked)."""
  root = tmp_path_factory.mktemp('jax_checkpoints')
  out = {}
  scan = recnet_conf(model=dict(recnet_conf()['model'], use_scan=True))
  for name, conf_d in (('recnet', recnet_conf()), ('gan', gan_conf()),
                       ('seg', seg_conf()), ('recnet_scan', scan)):
    path = str(root / '{}.ckpt'.format(name))
    out[name] = (path, conf_d) + jax_checkpoint(path, conf_d)
  deploy = str(root / 'gan-deploy.ckpt')
  deploy_checkpoint.main(['adversarial', out['gan'][0], deploy])
  out['deploy'] = (deploy,) + out['gan'][1:]
  return out


# --- Analyze -----------------------------------------------------------------


@pytest.mark.parametrize('big_endian', [False, True], ids=['le', 'be'])
@pytest.mark.parametrize('scale', [0.0, 2.5], ids=['unscaled', 'scaled'])
@pytest.mark.parametrize('dtype', [np.int16, np.uint8, np.float32])
def test_analyze_reader_equals_jax(tmp_path, dtype, scale, big_endian):
  rng = np.random.RandomState(3)
  volume = (rng.rand(5, 4, 3) * 200).astype(dtype)
  path = str(tmp_path / 'vol.img')
  analyze_io.save_analyze(path, volume, scale=scale, big_endian=big_endian)
  got = analyze_io.load_analyze(path)
  want = janalyze_io.load_analyze(path)
  assert got.dtype == want.dtype and got.shape == want.shape == (5, 4, 3)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, volume * scale if scale else volume)


def test_analyze_reader_squeezes_and_reads_hdr_path(tmp_path):
  volume = np.arange(6, dtype=np.int16).reshape(2, 1, 3)
  analyze_io.save_analyze(str(tmp_path / 'v.hdr'), volume)
  got = analyze_io.load_analyze(str(tmp_path / 'v.hdr'))
  np.testing.assert_array_equal(got, janalyze_io.load_analyze(
      str(tmp_path / 'v.img')))
  assert got.shape == (2, 3)
  with pytest.raises(FileNotFoundError):
    analyze_io.load_analyze(str(tmp_path / 'missing.img'))


# --- ScarSeg -----------------------------------------------------------------


@pytest.fixture(scope='module')
def scarseg_512(tmp_path_factory):
  """A ScarSeg-format tree of 512² phantom volumes, 2 slices per case."""
  root = str(tmp_path_factory.mktemp('scarseg512'))
  datasets.write_scarseg_phantoms(root, 512, 2, seed=4)
  return root


def _items_equal(got, want, indices):
  for i in indices:
    g, w = got[i], want[i]
    assert set(g) == set(w)
    for key in w:
      assert g[key].dtype == w[key].dtype, key
      np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize('fold', ['train', 'val', 'test'])
@pytest.mark.parametrize('mode,downscale,labels', [
    ('reconstruction', 1, False), ('reconstruction', 8, True),
    ('segmentation', 1, False), ('segmentation', 8, False)],
                         ids=['rec', 'rec-ds8-labels', 'seg', 'seg-ds8'])
def test_scarseg_items_equal_jax(scarseg_512, fold, mode, downscale, labels):
  conf_d = {'seed': 0, 'dataset_mode': mode, 'downscale': downscale,
            'include_labels': labels}
  got = datasets.load_dataset(Configuration.from_dict(conf_d), scarseg_512,
                              'ScarSeg', fold)
  want = jdatasets.load_dataset(JConfiguration.from_dict(conf_d),
                                scarseg_512, 'ScarSeg', fold)
  cases = datasets.STATIC_SPLIT[fold]
  assert len(got) == len(want) == 2 * len(cases)
  assert got.name == want.name == 'ScarSeg'
  np.testing.assert_array_equal(got.images, want.images)
  _items_equal(got, want, range(len(got)))
  side = 512 // downscale
  key = 'gt' if mode == 'reconstruction' else 'inp'
  assert got[0][key].shape[:2] == (side, side)
  # The port names each slice after its own case; the JAX package counts
  # NUM_SLICES names per case, right for the first case only here.
  assert [got.get_filename(i) for i in range(len(got))] == [
      '{}_slice{}'.format(c, s) for c in cases for s in range(2)]
  assert [got.get_filename(i) for i in range(2)] == \
      [want.get_filename(i) for i in range(2)]


def test_scarseg_random_split_equals_jax(scarseg_512):
  conf_d = {'seed': 0, 'random_split': True, 'split_ratio': [4, 1, 1],
            'downscale': 8}
  for fold in ('train', 'val', 'test'):
    got = datasets.load_dataset(Configuration.from_dict(conf_d), scarseg_512,
                                'ScarSeg', fold)
    want = jdatasets.load_dataset(JConfiguration.from_dict(conf_d),
                                  scarseg_512, 'ScarSeg', fold)
    assert len(got) == len(want)
    _items_equal(got, want, range(0, len(got), 7))
    got_cases = sorted({got.get_case_and_slice(got.get_filename(i))[0]
                        for i in range(len(got))})
    want_paths = jdatasets._split_scarseg(
        os.path.join(scarseg_512, 'scar_segmentation'), [4, 1, 1],
        False)[('train', 'val', 'test').index(fold)]
    assert got_cases == sorted(os.path.basename(p) for p in want_paths)


def test_scarseg_slice_names_equal_jax_for_full_volumes(tmp_path):
  """Volumes of NUM_SLICES slices: every name and item equals JAX's (8²
  sources at downscale 64, so no k-space crop)."""
  root = str(tmp_path)
  datasets.write_scarseg_phantoms(root, 8, datasets.NUM_SLICES, seed=5)
  conf_d = {'seed': 0, 'downscale': 64, 'include_labels': True}
  got = datasets.load_dataset(Configuration.from_dict(conf_d), root,
                              'ScarSeg', 'val')
  want = jdatasets.load_dataset(JConfiguration.from_dict(conf_d), root,
                                'ScarSeg', 'val')
  assert len(got) == len(want) == 6 * datasets.NUM_SLICES
  assert got.image_ids == want.image_ids
  _items_equal(got, want, range(len(got)))
  for i in (0, 60, len(got) - 1):
    name = got.get_filename(i)
    assert got.get_case_and_slice(name) == want.get_case_and_slice(name)


def test_scarseg_refuses_a_missing_case_and_unported_options(tmp_path):
  """A missing case and an unknown dataset raise; ``augmentation`` and
  ``native_pipeline``, refused before they were ported, no longer stop the
  check for the missing case."""
  root = str(tmp_path)
  datasets.write_scarseg_phantoms(root, 8, 1, cases=['c03_pre'])
  conf = Configuration.from_dict({'seed': 0, 'downscale': 64})
  with pytest.raises(FileNotFoundError, match='c43_pre'):
    datasets.load_dataset(conf, root, 'ScarSeg', 'train')
  for key, value in (('augmentation', {'shift': 2}),
                     ('native_pipeline', True)):
    with pytest.raises(FileNotFoundError, match='c43_pre'):
      datasets.load_dataset(Configuration.from_dict({key: value}),
                            root, 'ScarSeg', 'train')
  assert datasets.is_dataset('ScarSeg') and not datasets.is_dataset('Nope')
  with pytest.raises(ValueError, match='Nope'):
    datasets.load_dataset(conf, root, 'Nope', 'train')


# --- loader ------------------------------------------------------------------


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_batches_equal_jax(scarseg_512, workers):
  conf_d = {'seed': 0, 'downscale': 8, 'include_labels': True}
  got_set = datasets.load_dataset(Configuration.from_dict(conf_d),
                                  scarseg_512, 'ScarSeg', 'val')
  want_set = jdatasets.load_dataset(JConfiguration.from_dict(conf_d),
                                    scarseg_512, 'ScarSeg', 'val')
  for kw in (dict(shuffle=True, seed=3, num_samples=11),
             dict(shuffle=False, drop_last=True)):
    got = DataLoader(got_set, 4, num_workers=workers, prefetch=2, **kw)
    want = JDataLoader(want_set, 4, num_workers=workers, **kw)
    assert len(got) == len(want)
    for _ in range(2):          # the shuffle stream goes on across epochs
      pairs = list(zip(got, want))
      assert len(pairs) == len(want)
      for g, w in pairs:
        assert set(g) == set(w)
        for key in w:
          np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got.wait_s >= 0


class _Failing:
  def __len__(self):
    return 10

  def __getitem__(self, i):
    if i == 6:
      raise KeyError('slice 6 is broken')
    return {'x': np.full(3, i)}


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_raises_a_worker_error_in_the_consumer(workers):
  loader = DataLoader(_Failing(), 3, num_workers=workers, prefetch=2)
  seen = []
  with pytest.raises(KeyError, match='slice 6'):
    for batch in loader:
      seen.append(batch['x'][:, 0].tolist())
  assert seen == [[0, 1, 2], [3, 4, 5]]


def test_loader_stops_its_producer_when_left_early():
  loader = DataLoader(_Failing(), 2, prefetch=2)
  it = iter(loader)
  assert next(it)['x'][:, 0].tolist() == [0, 1]
  it.close()
  assert next(iter(loader))['x'][:, 0].tolist() == [0, 1]


# --- msgpack -----------------------------------------------------------------


def _assert_trees_equal(got, want, path='root'):
  if isinstance(want, dict):
    assert isinstance(got, dict) and list(got) == list(want), path
    for key in want:
      _assert_trees_equal(got[key], want[key], '{}/{}'.format(path, key))
  elif isinstance(want, list):
    assert isinstance(got, list) and len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
      _assert_trees_equal(g, w, '{}/{}'.format(path, i))
  elif isinstance(want, (np.ndarray, np.generic)) and \
      want.dtype == jnp.bfloat16:
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape, path
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32), err_msg=path)
  elif isinstance(want, (np.ndarray, np.generic)):
    assert type(got) is type(want), path
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)
  else:
    assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize('name', ['recnet', 'gan', 'seg', 'deploy'])
def test_msgpack_reads_jax_checkpoints_as_flax(jax_checkpoints, name):
  path = jax_checkpoints[name][0]
  with open(path, 'rb') as f:
    data = f.read()
  want = serialization.msgpack_restore(data)
  got = flax_msgpack.msgpack_restore(data)
  _assert_trees_equal(got, want)
  assert checkpoints.is_flax_checkpoint(path)
  assert got['conf']['run_name'] == jax_checkpoints[name][1]['run_name']
  runner_keys = {'recnet': {'model', 'step', 'optimizer'},
                 'seg': {'model', 'step', 'optimizer'},
                 'gan': {'generator', 'gen_optimizer', 'discriminator',
                         'disc_optimizer'},
                 'deploy': {'generator'}}[name]
  assert set(got['runner']) == runner_keys
  if name != 'deploy':
    assert type(got['epoch']) is int and got['epoch'] == 3
    assert got['best_val_metrics']['loss_MSE'] == {
        'value': 0.25, 'direction': 'min'}


def test_msgpack_reads_bf16_complex_scalar_and_edge_leaves():
  tree = {
      'bf16': np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)),
      'bf16_scalar': np.asarray(jnp.bfloat16(1.5))[()],
      'complex': 1.5 - 2j, 'f32_scalar': np.float32(0.25),
      'i64_scalar': np.int64(-(2 ** 40)), 'bool_scalar': np.bool_(True),
      'c64': (np.arange(4) * (1 + 1j)).astype(np.complex64),
      'ints': {'step': 7, 'neg': -33, 'big': 2 ** 62, 'u8': 200,
               'u16': 60000, 'i16': -300},
      'floats': 0.1, 'none': None, 'flags': [True, False],
      'text': 'x' * 300, 'blob': b'\x00\xff' * 40000,
      'f64': np.linspace(0, 1, 70000), 'empty': np.zeros((0, 3), np.int8),
      '0': {'1': 'list saved as a dict'},
  }
  data = serialization.msgpack_serialize(tree)
  want = serialization.msgpack_restore(data)
  got = flax_msgpack.msgpack_restore(data)
  _assert_trees_equal(got, want)
  assert isinstance(got['blob'], bytes) and got['ints']['step'] == 7
  got['f64'][0] = 5.0          # arrays come back writable
  with pytest.raises(ValueError, match='ends early'):
    flax_msgpack.msgpack_restore(data[:-5])
  with pytest.raises(ValueError, match='after'):
    flax_msgpack.msgpack_restore(data + b'\x00')


def test_msgpack_reassembles_chunked_arrays(monkeypatch):
  monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 1000)
  tree = {'big': np.arange(1000, dtype=np.float32).reshape(10, 100),
          'nested': {'bf16': np.asarray(jnp.ones((700,), jnp.bfloat16))},
          'small': np.arange(3)}
  data = serialization.msgpack_serialize(tree)
  raw = serialization.msgpack.unpackb(data, raw=False, strict_map_key=False,
                                      ext_hook=lambda c, d: None)
  assert '__msgpack_chunked_array__' in raw['big']
  _assert_trees_equal(flax_msgpack.msgpack_restore(data),
                      serialization.msgpack_restore(data))


def test_stacked_scan_tree_loads_into_the_per_block_modules():
  """A use_scan RecNet's flax tree (blocks stacked under ``blocks/block``)
  fills the port's per-block modules: block i takes entry i of each
  stacked leaf; a tree with another number of blocks raises."""
  import csmri_refinement_tpu.models.recnet as jrecnet
  section = {'name': 'RecNet', 'num_blocks': 3, 'num_convs': 2,
             'num_filters': 4, 'use_scan': True}
  model = jrecnet.RecNet(**{k: v for k, v in section.items() if k != 'name'})
  x = jnp.zeros((1, 8, 8, 2))
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x,
                          jnp.zeros((1, 8, 8, 1)))
  variables = randomize(shapes, 4)
  assert set(variables['params']) == {'blocks'}
  stacked = jax.tree_util.tree_map(np.asarray, variables)
  port = construct_model(section)
  assert port.scan_layout
  load_flax_variables(port, stacked)
  for i, block in enumerate(port.blocks()):
    kernel = stacked['params']['blocks']['block']['conv_1']['kernel'][i]
    np.testing.assert_array_equal(block.conv_1.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))
  with pytest.raises(ValueError, match='not used'):
    load_flax_variables(construct_model(dict(section, num_blocks=2)),
                        stacked)
  with pytest.raises(KeyError, match='blocks/block'):
    load_flax_variables(construct_model(dict(section, num_blocks=4)),
                        stacked)


# --- restoring JAX checkpoints -----------------------------------------------


def _pred(out):
  return np.asarray(out['pred'] if isinstance(out, dict) else out)


def _port_batch(name):
  seg = name == 'seg'
  return (seg_batch if seg else rec_batch)()[1]


@pytest.mark.parametrize('name,atol', [('recnet', RECNET_ATOL),
                                       ('gan', UNET_ATOL),
                                       ('deploy', UNET_ATOL),
                                       ('seg', UNET_ATOL),
                                       ('recnet_scan', RECNET_ATOL)])
def test_port_runner_restored_from_jax_checkpoint_predicts_as_jax(
    jax_checkpoints, name, atol):
  path, conf_d, jrunner, jbatch = jax_checkpoints[name]
  runner = build_runner(Configuration.from_dict(conf_d),
                        conf_d['runner_type'], 'test', 'cpu')
  state = checkpoints.restore_checkpoint(path, runner)
  want, got = _pred(jrunner.predict(jbatch)), _pred(runner.predict(
      _port_batch(name)))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=atol)
  if name == 'deploy':
    assert 'start_epoch' not in state
  else:
    assert state['start_epoch'] == 3
    assert state['best_val_metrics']['psnr'].value == 31.5
  if name.startswith('recnet'):
    assert runner.step == 0 or runner.step == int(jrunner.state['step'])
  if name == 'recnet_scan':
    assert runner.model.scan_layout


def test_train_mode_runner_restores_jax_networks_not_optax_state(
    jax_checkpoints):
  """A train-mode GAN runner takes a JAX checkpoint's generator,
  discriminator and BN statistics; its optimizers take the optax state,
  which is the initial one here (the JAX runner took no step): zero
  moments and step counts (``tests/test_torch_port_cli.py`` restores
  trained ones)."""
  path, conf_d, jrunner, _ = jax_checkpoints['gan']
  runner = build_runner(Configuration.from_dict(conf_d), 'adversarial',
                        'train', 'cpu')
  checkpoints.restore_checkpoint(path, runner)
  for module, state in ((runner.gen, jrunner.gen_state),
                        (runner.disc, jrunner.disc_state)):
    twin = copy.deepcopy(module)
    load_flax_variables(twin, jax.tree_util.tree_map(np.asarray, {
        'params': state['params'], 'batch_stats': state['batch_stats']}))
    want_sd = twin.state_dict()
    for key, value in module.state_dict().items():
      np.testing.assert_array_equal(value.numpy(), want_sd[key].numpy(),
                                    err_msg=key)
  for optimizer in (runner.gen_optimizer, runner.disc_optimizer):
    state = optimizer.state_dict()['state']
    assert len(state) == sum(len(g['params'])
                             for g in optimizer.param_groups)
    for entry in state.values():
      assert entry['step'].item() == 0
      assert not entry['exp_avg'].any() and not entry['exp_avg_sq'].any()


def test_jax_recnet_grafts_into_a_refinement_generator(jax_checkpoints,
                                                       tmp_path):
  """``pretrained_weights`` naming a JAX RecNet checkpoint: the port's
  wrapper, its U-Net and scale taken from the JAX wrapper, gives the JAX
  wrapper's output."""
  path, rec_d, _, _ = jax_checkpoints['recnet']
  conf_d = gan_conf()
  conf_d['generator_model']['pretrained_model'] = dict(
      rec_d['model'], pretrained_weights=[path, 'model'])
  jconf = JConfiguration.from_dict(conf_d)
  jrunner = jbuild_runner(jconf, 'adversarial', 'test')
  jbatch, tbatch = rec_batch(seed=1)
  jrunner._ensure_initialized(jbatch)
  params = jrunner.gen_state['params']
  params['learnable_model'] = randomize(params['learnable_model'], 7)
  params['scale'] = jnp.asarray([0.7], jnp.float32)
  runner = build_runner(Configuration.from_dict(conf_d), 'adversarial',
                        'test', 'cpu')
  want_rec = construct_model(dict(rec_d['model'],
                                  undersampling=rec_d['undersampling']))
  jrec = flax_msgpack.msgpack_restore(open(path, 'rb').read())
  load_flax_variables(want_rec, jrec['runner']['model'])
  for key, value in runner.gen.pretrained_model.state_dict().items():
    assert torch.equal(value, want_rec.state_dict()[key]), key
  load_flax_variables(runner.gen.learnable_model, jax.tree_util.tree_map(
      np.asarray, {'params': params['learnable_model'],
                   'batch_stats': jrunner.gen_state['batch_stats'].get(
                       'learnable_model', {})}))
  with torch.no_grad():
    runner.gen.scale.fill_(0.7)
  want, got = _pred(jrunner.predict(jbatch)), _pred(runner.predict(tbatch))
  assert got.shape == want.shape == (BATCH, SIZE, SIZE, 2)
  np.testing.assert_allclose(got, want, atol=UNET_ATOL)


@pytest.mark.parametrize('runner_type,name', [('standard', 'recnet'),
                                              ('adversarial', 'gan')])
def test_inference_checkpoint_equals_jax(jax_checkpoints, runner_type, name):
  """The deploy step's checkpoint from a decoded JAX checkpoint: the same
  keys and leaves as the JAX package's function gives."""
  path = jax_checkpoints[name][0]
  with open(path, 'rb') as f:
    data = f.read()
  got = checkpoints.inference_checkpoint_from_training_checkpoint(
      flax_msgpack.msgpack_restore(data), runner_type)
  want = jcheckpoints.inference_checkpoint_from_training_checkpoint(
      serialization.msgpack_restore(data), runner_type)
  _assert_trees_equal(got, want)
  with pytest.raises(ValueError, match='runner_type'):
    checkpoints.inference_checkpoint_from_training_checkpoint(
        flax_msgpack.msgpack_restore(data),
        'adversarial' if runner_type == 'standard' else 'standard')


@pytest.mark.parametrize('name', ['recnet', 'gan', 'seg'])
def test_named_outputs_equal_jax(jax_checkpoints, name):
  """``get_named_outputs`` of a validation step's data: the input as is,
  the prediction and target through the application's output transform
  (magnitude and clamp; argmax class maps), as the JAX runners name
  them."""
  path, conf_d, jrunner, jbatch = jax_checkpoints[name]
  runner = build_runner(Configuration.from_dict(conf_d),
                        conf_d['runner_type'], 'test', 'cpu')
  checkpoints.restore_checkpoint(path, runner)
  tbatch = _port_batch(name)
  want = jrunner.get_named_outputs((jbatch, jrunner.predict(jbatch)))
  got = runner.get_named_outputs((tbatch, runner.predict(tbatch)))
  assert {'input', 'prediction', 'target'} <= set(got)
  # the inputs: the same undersampling, one ortho FFT pair apart
  np.testing.assert_allclose(got['input'].numpy(), np.asarray(want['input']),
                             atol=1e-6)
  for key in ('prediction', 'target'):
    g, w = got[key].numpy(), np.asarray(want[key])
    assert g.shape == w.shape, key
    if name == 'seg':
      np.testing.assert_array_equal(g, w, err_msg=key)
    else:
      np.testing.assert_allclose(g, w, atol=UNET_ATOL, err_msg=key)


# --- validation inputs -------------------------------------------------------


def test_validation_inputs_with_noise_match_jax(monkeypatch):
  """With ``undersampling.noise`` > 0 the port's validation inputs equal
  the JAX package's: JAX's ``_val_cartesian`` adds no noise (the noise is
  training randomness), so on the same slices and masks (JAX's, handed to
  the port slice by slice) ``inp`` and ``kspace`` are one ortho FFT pair
  apart."""
  conf_d = recnet_conf(
      train_dataset='Synthetic', validation_dataset='Synthetic',
      synthetic={'image_size': SIZE, 'num_train': 4, 'num_val': 4},
      undersampling=dict(recnet_conf()['undersampling'], noise=0.05))
  jpreparer = jprep.get_batch_preparer(JConfiguration.from_dict(conf_d))

  def jax_val_mask(self, index, height, width):
    mask = np.array(jpreparer.prepare_val({
        'gt': np.zeros((1, height, width), np.float32),
        'index': np.array([index], np.int32)})['mask'])[0]
    return torch.from_numpy(mask[..., 0])
  monkeypatch.setattr(prep.RecBatchPreparer, '_val_mask', jax_val_mask)
  conf = Configuration.from_dict(conf_d)
  host = next(iter(DataLoader(load_dataset(conf, None, 'Synthetic', 'val'),
                              4)))
  assert sorted(host['index'].tolist()) == [0, 1, 2, 3]
  want = jpreparer.prepare_val(host)
  got = prep.RecBatchPreparer(conf, 'cpu').prepare_val(host)
  bar = 1e-6 * float(np.abs(np.asarray(want['target'])).max())
  for key in ('mask', 'target', 'inp', 'kspace'):
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=bar, rtol=0, err_msg=key)
