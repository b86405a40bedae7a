"""HFEN and mutual information against the JAX package's, and the port's
validate CLI on a radial, augmented 1-recnet checkpoint against the JAX
CLI.

Bars: the metric functions within 1e-10 relative of JAX's on the same
arrays; the mutual information of a contingency table within 1e-12 of
scikit-learn's ``mutual_info_score`` (the JAX package's call; the port has
its formula in numpy); the CLIs' averaged metrics within 1e-3 dB PSNR, 1e-4
SSIM and 1e-6 relative HFEN and MI.
"""

import json

import numpy as np
import pytest
import torch
from sklearn.metrics import mutual_info_score

import validate as jvalidate
from csmri_refinement_tpu.metrics import get_metric_fn as jget_metric_fn
from csmri_refinement_tpu.metrics import image_metrics as jimage_metrics
from csmri_refinement_tpu.training import base_runner as jbase_runner
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import validate
from csmri_refinement_tpu_torch.data import datasets
from csmri_refinement_tpu_torch.metrics import get_metric_fn, image_metrics
from csmri_refinement_tpu_torch.metrics.metric import MaxMetric, MinMetric
from csmri_refinement_tpu_torch.utils.config import Configuration
from test_torch_port_data import jax_checkpoint, recnet_conf

METRIC_REL = 1e-10
SKLEARN_ABS = 1e-12
PSNR_ATOL = 1e-3        # dB
SSIM_ATOL = 1e-4
CLI_REL = 1e-6          # HFEN and MI
AUGMENTATION = {'elastic_transform_alpha': 6.0, 'elastic_transform_sigma': 3.0,
                'shift': 4, 'rotate': 15, 'scale': [0.85, 1.15]}


def _pair(seed, shape):
  rng = np.random.RandomState(seed)
  target = rng.rand(*shape).astype(np.float32)
  pred = np.clip(target + 0.05 * rng.randn(*shape), 0, 1).astype(np.float32)
  return pred, target


def _rel(got, want):
  return abs(got - want) / abs(want)


@pytest.mark.parametrize('shape', [(1, 32, 32, 1), (48, 40), (1, 64, 64, 1)])
@pytest.mark.parametrize('name', ['compute_hfen',
                                  'compute_mutual_information'])
def test_host_metrics_equal_jax(name, shape):
  for seed in range(3):
    pred, target = _pair(seed, shape)
    want = getattr(jimage_metrics, name)(pred, target)
    for p, t in ((pred, target),
                 (torch.from_numpy(pred), torch.from_numpy(target))):
      got = getattr(image_metrics, name)(p, t)
      assert isinstance(got, float)
      assert _rel(got, want) <= METRIC_REL, (seed, got, want)


@pytest.mark.parametrize('bins', [2, 16, 256])
def test_mutual_information_of_a_table_equals_sklearn(bins):
  """Float tables (truncated to integers, as sklearn casts them), integer
  tables, and the single-row and empty-cell edges."""
  rng = np.random.RandomState(bins)
  pred, target = _pair(bins, (64, 64))
  tables = [rng.rand(bins, bins) * 40, rng.randint(0, 9, (bins, bins)),
            np.histogram2d(pred.ravel(), target.ravel(), bins=bins,
                           range=((0, 1), (0, 1)), density=True)[0],
            rng.randint(0, 5, (1, bins))]
  for table in tables:
    want = mutual_info_score(None, None, contingency=table)
    got = image_metrics.mutual_info_of_contingency(table)
    assert abs(got - want) <= SKLEARN_ABS, (got, want)


def test_hfen_and_mi_registered_as_jax():
  conf = Configuration.from_dict({'application': 'reconstruction'})
  jconf = JConfiguration.from_dict({'application': 'reconstruction'})
  rng = np.random.RandomState(0)
  pred = rng.randn(3, 32, 32, 2).astype(np.float32) * 0.6
  target = rng.randn(3, 32, 32, 2).astype(np.float32) * 0.6
  for name, kind in (('hfen', MinMetric), ('mutual_information', MaxMetric)):
    fn = get_metric_fn(conf, name)
    assert fn.metric_type is kind
    got = fn(torch.from_numpy(pred), torch.from_numpy(target))
    want = jget_metric_fn(jconf, name, 'test')(pred, target)
    assert type(got).__name__ == type(want).__name__
    assert _rel(got.value, want.value) <= CLI_REL, name
  with pytest.raises(ValueError, match='nope'):
    get_metric_fn(conf, 'nope')


@pytest.fixture(scope='module')
def radial_checkpoint(tmp_path_factory):
  """(data dir, JAX checkpoint, its config file): a narrow 1-recnet with
  radial masks, the paper's augmentation and the four image metrics, on a
  64² ScarSeg-format tree (4 slices per validation case)."""
  root = tmp_path_factory.mktemp('radial')
  data_dir = str(root / 'data')
  datasets.write_scarseg_phantoms(data_dir, 64, 4, seed=2,
                                  cases=datasets.STATIC_SPLIT['val'])
  datasets.write_scarseg_phantoms(
      data_dir, 64, 1, seed=3,
      cases=datasets.STATIC_SPLIT['train'] + datasets.STATIC_SPLIT['test'])
  conf_d = recnet_conf(
      augmentation=AUGMENTATION,
      undersampling={'sampling_scheme': 'radial', 'acceleration_factor': 12,
                     'variable_acceleration': False},
      validation_metrics=['psnr', 'ssim', 'hfen', 'mutual_information'],
      num_validation_subset_samples=12)
  conf_path = str(root / 'radial-recnet.json')
  with open(conf_path, 'w') as f:
    json.dump(conf_d, f)
  ckpt = str(root / 'recnet.ckpt')
  jax_checkpoint(ckpt, conf_d)
  return data_dir, ckpt, conf_path


def test_validate_on_radial_augmented_recnet_equals_jax(radial_checkpoint,
                                                        monkeypatch):
  """Both CLIs restore the JAX checkpoint and validate 12 slices: their
  radial validation masks are the same (``RandomState`` per slice index),
  so no mask is handed over."""
  data_dir, ckpt, conf_path = radial_checkpoint
  seen = []
  original = jbase_runner.BaseRunner.validate

  def recording(self, *args, **kwargs):
    out = original(self, *args, **kwargs)
    seen.append({k: v.value for k, v in out[2].items()})
    return out
  monkeypatch.setattr(jbase_runner.BaseRunner, 'validate', recording)
  common = [conf_path, ckpt, '--data-dir', data_dir, '-b', '4', '--dry']
  jvalidate.main(common)
  got = validate.main(common + ['--device', 'cpu'])['ScarSeg']['metrics']
  want, = seen
  assert set(got) == set(want) == {'psnr', 'ssim', 'hfen',
                                   'mutual_information'}
  assert 10 < want['psnr'] < 60 and 0 < want['hfen'] < 2
  assert abs(got['psnr'] - want['psnr']) <= PSNR_ATOL
  assert abs(got['ssim'] - want['ssim']) <= SSIM_ATOL
  for name in ('hfen', 'mutual_information'):
    assert _rel(got[name], want[name]) <= CLI_REL, (name, got, want)
