"""The port's validate, eval_results and train CLIs against the JAX CLIs.

One ScarSeg-format tree (``write_scarseg_phantoms``): the six validation
cases hold NUM_SLICES (52) slices of 64² phantoms, the JAX package's slice
names being right only for such volumes, every other case one slice; the
configs run at ``downscale: 8`` (64²). Both CLIs restore the same
checkpoint that the JAX package's ``save_checkpoint`` wrote
(``tests/test_torch_port_data.py::jax_checkpoint``) and evaluate the first
56 validation slices (all of one case, four of the next). The port draws
its validation masks from a generator per slice index, the JAX package by
folding the index into a key; the test hands the port JAX's mask for each
index (``RecBatchPreparer._val_mask``), as the trajectory tests fix masks.
"""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import loadmat

import eval_results as jeval_results
import validate as jvalidate
from csmri_refinement_tpu.training import base_runner as jbase_runner
from csmri_refinement_tpu.training import prep as jprep
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import eval_results, train, validate
from csmri_refinement_tpu_torch.data import datasets
from csmri_refinement_tpu_torch.training import prep
from test_torch_port_data import (jax_checkpoint, recnet_conf, seg_conf,
                                  seg_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_VAL = 56
PSNR_ATOL = 1e-3        # dB
SSIM_ATOL = 1e-4
PRED_ATOL = 2e-4        # tests/test_dc_pallas.py:26, RecNet's three DCs
IO_ATOL = 1e-6          # input and target: one ortho FFT pair apart
CSV_RTOL = 1e-6
SIS_ATOL = 1e-3         # chip_smoke.py phase 17, SIS card vs CPU


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
  """(data dir, JAX RecNet checkpoint, its config file, JAX segmentation
  checkpoint)."""
  root = tmp_path_factory.mktemp('validate')
  data_dir = str(root / 'data')
  datasets.write_scarseg_phantoms(data_dir, 64, datasets.NUM_SLICES, seed=2,
                                  cases=datasets.STATIC_SPLIT['val'])
  datasets.write_scarseg_phantoms(
      data_dir, 64, 1, seed=3,
      cases=datasets.STATIC_SPLIT['train'] + datasets.STATIC_SPLIT['test'])
  ckpt_dir = root / 'run'
  ckpt_dir.mkdir()
  conf_d = recnet_conf(num_validation_subset_samples=NUM_VAL)
  conf_path = str(ckpt_dir / 'tiny-recnet.json')
  with open(conf_path, 'w') as f:
    json.dump(conf_d, f)
  ckpt = str(ckpt_dir / 'recnet.ckpt')
  jax_checkpoint(ckpt, conf_d)
  seg_ckpt = str(ckpt_dir / 'seg.ckpt')
  jax_checkpoint(seg_ckpt, seg_conf(), seed=5)
  return data_dir, ckpt, conf_path, seg_ckpt


def _use_jax_masks(monkeypatch, conf_path):
  """Replace the port's validation masks by JAX's, slice by slice."""
  jpreparer = jprep.get_batch_preparer(JConfiguration.from_json(conf_path))

  def jax_val_mask(self, index, height, width):
    mask = np.array(jpreparer.prepare_val({
        'gt': np.zeros((1, height, width), np.float32),
        'index': np.array([index], np.int32)})['mask'])[0]
    return torch.from_numpy(mask[..., 0] if mask.ndim == 3 else mask)
  monkeypatch.setattr(prep.RecBatchPreparer, '_val_mask', jax_val_mask)


@pytest.fixture
def jax_masks(monkeypatch, tree):
  _use_jax_masks(monkeypatch, tree[2])


@pytest.fixture
def jax_metrics(monkeypatch):
  """The averaged metrics of every JAX ``validate`` call, as it returns
  them (the JAX CLI only logs them)."""
  seen = []
  original = jbase_runner.BaseRunner.validate

  def recording(self, *args, **kwargs):
    out = original(self, *args, **kwargs)
    seen.append({k: v.value for k, v in out[2].items()})
    return out
  monkeypatch.setattr(jbase_runner.BaseRunner, 'validate', recording)
  return seen


def _run_both(tree, tmp_path, flags):
  """The JAX CLI and the port's (on the CPU) with ``flags``; returns their
  output dirs (None without outputs) and the port's results."""
  data_dir, ckpt, conf_path, _ = tree
  common = [conf_path, ckpt, '--data-dir', data_dir] + flags
  jvalidate.main(common + ['--out-dir', str(tmp_path / 'jax')])
  got = validate.main(common + ['--out-dir', str(tmp_path / 'port'),
                                '--device', 'cpu'])
  dirs = [glob.glob(str(tmp_path / side / 'ScarSeg_tiny-recnet_*'))
          for side in ('jax', 'port')]
  return [d[0] if d else None for d in dirs], got


def test_validate_metrics_equal_jax(tree, tmp_path, jax_masks, jax_metrics):
  (jdir, pdir), got = _run_both(tree, tmp_path, ['-b', '8', '--dry'])
  assert jdir is None and pdir is None
  want, = jax_metrics
  got = got['ScarSeg']['metrics']
  assert set(got) == set(want) == {'psnr', 'ssim'}
  assert 15 < want['psnr'] < 60
  assert abs(got['psnr'] - want['psnr']) <= PSNR_ATOL
  assert abs(got['ssim'] - want['ssim']) <= SSIM_ATOL


@pytest.fixture(scope='module')
def raw_records(tree, tmp_path_factory):
  """Both CLIs' ``--raw`` output dirs (JAX masks for the port)."""
  tmp_path = tmp_path_factory.mktemp('raw')
  with pytest.MonkeyPatch.context() as mp:
    _use_jax_masks(mp, tree[2])
    (jdir, pdir), _ = _run_both(tree, tmp_path, ['--raw'])
  return jdir, pdir


def test_validate_raw_records_equal_jax(raw_records):
  jdir, pdir = raw_records
  names = sorted(os.listdir(jdir))
  assert names == sorted(os.listdir(pdir))
  assert len(names) == NUM_VAL
  assert names[0] == 'c18_pre_slice0.mat' and 'c34_post_slice3.mat' in names
  for name in names:
    want, got = loadmat(os.path.join(jdir, name)), loadmat(
        os.path.join(pdir, name))
    assert str(got['case'][0]) == str(want['case'][0])
    assert int(got['slice'][0]) == int(want['slice'][0])
    for key, atol in (('input', IO_ATOL), ('target', IO_ATOL),
                      ('pred', PRED_ATOL)):
      assert got[key].shape == want[key].shape == (64, 64, 2)
      np.testing.assert_allclose(got[key], want[key], atol=atol,
                                 err_msg='{} {}'.format(name, key))


def _magnitude_levels(record):
  """The 0-255 float value of each pixel of a record's image, as
  _save_image computes it before truncating."""
  mag = np.sqrt(record[..., 0] ** 2 + record[..., 1] ** 2)
  return np.clip(mag, 0.0, 1.0) * 255


def test_validate_images_equal_jax(tree, tmp_path, jax_masks, raw_records):
  """``-i -d`` PNGs: the port's decode (PIL) to what PIL writes from the
  same values, and equal JAX's pixel for pixel except where JAX's value
  lies within the prediction bar of a level boundary (there one level, in
  under a thousandth of the pixels)."""
  (jdir, pdir), _ = _run_both(tree, tmp_path, ['-b', '8', '-i', '-d'])
  jraw, praw = raw_records
  pngs = sorted(os.listdir(jdir))
  assert pngs == sorted(os.listdir(pdir))
  assert len(pngs) == 3 * NUM_VAL
  differ = 0
  for png in pngs:
    stem, kind = png[:-4].rsplit('_', 1)
    key = {'input': 'input', 'target': 'target', 'pred': 'pred'}[kind]
    want_img = np.asarray(Image.open(os.path.join(jdir, png)))
    got_img = np.asarray(Image.open(os.path.join(pdir, png)))
    assert got_img.dtype == np.uint8 and got_img.shape == (64, 64)
    own = _magnitude_levels(loadmat(os.path.join(praw, stem + '.mat'))[key])
    np.testing.assert_array_equal(got_img, own.astype(np.uint8))
    levels = _magnitude_levels(loadmat(os.path.join(jraw,
                                                    stem + '.mat'))[key])
    bar = 255 * (PRED_ATOL if kind == 'pred' else IO_ATOL)
    near = np.abs(levels - np.round(levels)) <= bar
    diff = np.abs(got_img.astype(int) - want_img.astype(int))
    assert np.all(diff[~near] == 0) and np.all(diff <= 1), png
    differ += int(np.count_nonzero(diff))
  assert differ < 1e-3 * len(pngs) * 64 * 64


def _read_csv(path):
  with open(path, newline='') as f:
    return list(csv.reader(f))


@pytest.mark.parametrize('segscore', [False, True], ids=['psnr-ssim',
                                                         'segscore'])
def test_eval_results_equal_jax(tree, raw_records, tmp_path, segscore):
  data_dir, _, _, seg_ckpt = tree
  jdir = raw_records[0]
  src = os.path.join(data_dir, 'scar_segmentation')
  flags = ['--src-path', src]
  if segscore:
    conf_path = str(tmp_path / 'segscore.json')
    with open(conf_path, 'w') as f:
      json.dump({'segmentation_score_metric': {
          'model': dict(seg_model(), pretrained_weights=[seg_ckpt, 'model']),
          'class': 1}}, f)
    flags += ['--segscore-conf', conf_path]
  (tmp_path / 'jax').mkdir()
  (tmp_path / 'port').mkdir()
  jeval_results.main(flags + ['--results-path', str(tmp_path / 'jax'), jdir])
  csv_path, values = eval_results.main(
      flags + ['--results-path', str(tmp_path / 'port'), '--device', 'cpu',
               jdir])
  base = os.path.basename(jdir)
  want = _read_csv(str(tmp_path / 'jax' / 'scarseg_{}.csv'.format(base)))
  got = _read_csv(csv_path)
  assert got[0] == want[0] == ['', 'psnr', 'name', 'ssim'] + (
      ['segscore'] if segscore else [])
  assert len(got) == len(want) == NUM_VAL + 1
  for g, w in zip(got[1:], want[1:]):
    assert g[0] == w[0]
    # JAX's pandas join leaves the name column empty; the port names the
    # slice's case.
    assert w[2] == '' and g[2] == g[0].rsplit('_', 1)[0]
    for i in (1,) + tuple(range(3, len(w))):
      np.testing.assert_allclose(
          float(g[i]), float(w[i]), rtol=CSV_RTOL,
          atol=SIS_ATOL if want[0][i] == 'segscore' else 0)
  assert [r[0] for r in got[1:3]] == ['c18_pre_00', 'c18_pre_01']
  with open(tmp_path / 'jax' / 'scarseg_{}.txt'.format(base)) as f:
    want_txt = f.read()
  with open(tmp_path / 'port' / 'scarseg_{}.txt'.format(base)) as f:
    got_txt = f.read()
  if not segscore:
    assert got_txt == want_txt
  else:
    want_seg = [float(r[4]) for r in want[1:]]
    got_seg = list(values['segscore'].values())
    np.testing.assert_allclose(got_seg, want_seg, atol=SIS_ATOL)
    assert 0 <= min(got_seg) and max(got_seg) <= 1
    assert got_txt.split('SegScore')[0] == want_txt.split('SegScore')[0]


def test_train_cli_on_scarseg_writes_a_checkpoint_validate_reads(tree,
                                                                 tmp_path):
  """configs/1-recnet.json as written, cut to downscale 8 and narrow
  widths, one epoch on the CPU from ``--data-dir``; the best checkpoint
  then validates, and the JAX package's checkpoint (epoch 3) resumes."""
  data_dir = tree[0]
  config = os.path.join(REPO, 'configs', '1-recnet.json')
  runner = train.main([
      config, '--device', 'cpu', '--data-dir', data_dir, '--log-dir',
      str(tmp_path / 'runs'), '--conf', 'num_epochs=1', 'downscale=8',
      'num_data_workers=2', 'num_validation_subset_samples=20',
      'model={"name": "RecNet", "num_blocks": 2, "num_convs": 2, '
      '"num_filters": 8}'])
  assert runner.step == 2          # 24 training slices, B = 20
  run_dir, = glob.glob(str(tmp_path / 'runs' / '1-recnet_*'))
  assert glob.glob(os.path.join(run_dir, 'log_train_*.txt'))
  best, = glob.glob(os.path.join(run_dir, 'best_loss_MSE', '*.ckpt'))
  conf_path, = glob.glob(os.path.join(run_dir, 'config_*.json'))
  got = validate.main([conf_path, best, '--data-dir', data_dir,
                       '--device', 'cpu', '-b', '5', '--conf',
                       'num_validation_subset_samples=10'])
  metrics = got['ScarSeg']['metrics']
  assert 5 < metrics['psnr'] < 60 and 0 < metrics['ssim'] <= 1
  assert os.path.exists(os.path.join(os.path.dirname(best), 'log_eval.txt'))
  resumed = train.main([
      config, '--device', 'cpu', '--dry', '--data-dir', data_dir,
      '--resume', tree[1], '--conf', 'num_epochs=3', 'downscale=8',
      'num_data_workers=2', 'num_validation_subset_samples=20',
      'model={"name": "RecNet", "num_blocks": 2, "num_convs": 2, '
      '"num_filters": 8}'])
  assert resumed.step == 2         # epoch 3 alone, from the JAX step 0
  assert resumed.optimizer.state_dict()['state'][0]['step'].item() == 2


def test_validate_refuses_raw_batches_and_a_missing_checkpoint(tree):
  data_dir, ckpt, conf_path, _ = tree
  with pytest.raises(ValueError, match='-b 1'):
    validate.main([conf_path, ckpt, '--raw', '-b', '2', '--device', 'cpu'])
  with pytest.raises(FileNotFoundError):
    validate.main([conf_path, ckpt + '.missing', '--device', 'cpu',
                   '--data-dir', data_dir, '--dry'])
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      validate.main([conf_path, ckpt])


def test_png_writer_decodes(tmp_path):
  image = (np.arange(7 * 5).reshape(7, 5) * 7 % 256).astype(np.uint8)
  path = str(tmp_path / 'x.png')
  validate.write_png(path, image)
  np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
