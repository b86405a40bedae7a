"""The port's serving artifact (``utils/export.py``, ``export_model.py``)
against the port's ``predict`` and the JAX runner's, on the CPU.

* The container: a round trip, a bad magic, a truncated payload and a JAX
  artifact, each raising ``ValueError`` as in JAX.
* The CLI for ``configs/1-recnet.json`` (RecNet 8 filters, 32², B = 2)
  and the generator of ``configs/2-refinement.json`` (narrow widths, 32²,
  B = 2; as written, and with its U-Net's ``upsampling_mode`` set to
  ``bilinear`` and to ``nn-biresize-conv``), each exporting a checkpoint
  the JAX runner wrote (the weight bridge uses every leaf of it): the artifact
  replayed in a fresh process, which imports no model code, equals the
  port's ``predict`` within 1e-6 of max |ref| (the same ops on the same
  weights), and the JAX runner's ``predict`` on the same weights and batch
  within the forward-parity bar of 5e-4 of max |ref| (XLA's and ATen's
  convolutions and FFTs sum in other orders).
* The graph holds the ``csmri::dc`` and ``csmri::conv_f32`` nodes that the
  eval path launches: 3 and 0 for 1-recnet, 3 and the U-Net's 10 chain
  layers for the narrow generator.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.training import build_runner as jbuild_runner
from csmri_refinement_tpu.utils import checkpoints as jcheckpoints
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import export_model
from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.profile_gan import synthetic_refinement_conf
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.utils import export
from csmri_refinement_tpu_torch.utils.checkpoints import restore_checkpoint
from csmri_refinement_tpu_torch.utils.config import Configuration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH = 32, 2
REPLAY_REL = 1e-6        # the same ops on the same weights
JAX_REL = 5e-4           # tests/test_forward_parity.py's forward bar
REPLAY_TIMEOUT_S = 120
MODEL_MODULES = ('models.recnet', 'models.unet', 'models.refinement_wrapper',
                 'training', 'flagship')


class _Toy(torch.nn.Module):
  def forward(self, x):
    return {'y': x * 2.0 + 1.0}


def _toy_artifact(path):
  x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
  exported = torch.export.export(_Toy(), (x,))
  export.save_artifact(path, exported, {'format': 1, 'input_keys': ['x'],
                                        'device': 'cpu',
                                        'precision': export.PRECISION},
                       extra_meta={'note': 'toy'})
  return x


def test_artifact_container_roundtrip(tmp_path):
  path = str(tmp_path / 'toy.pt2')
  x = _toy_artifact(path)
  loaded, header = export.load_artifact(path)
  assert header['meta']['note'] == 'toy' and header['payload_bytes'] > 0
  torch.testing.assert_close(loaded.module()(x)['y'], x * 2.0 + 1.0)
  call, header2 = export.load_callable(path, 'cpu')
  out = call({'x': x, 'target': torch.zeros(())})    # extra keys ignored
  torch.testing.assert_close(out['y'], x * 2.0 + 1.0)
  assert header2['input_keys'] == ['x']
  with pytest.raises(KeyError):
    call({'target': x})


def test_artifact_bad_magic_and_truncation_raise(tmp_path):
  path = str(tmp_path / 'bogus.pt2')
  with open(path, 'wb') as f:
    f.write(b'NOT-AN-ARTIFACT' + b'\x00' * 32)
  with pytest.raises(ValueError, match='bad magic'):
    export.load_artifact(path)
  with open(path, 'wb') as f:
    f.write(export.JAX_MAGIC + b'\x00' * 32)
  with pytest.raises(ValueError, match='JAX StableHLO'):
    export.load_artifact(path)
  good = str(tmp_path / 'toy.pt2')
  _toy_artifact(good)
  with open(good, 'rb') as f:
    blob = f.read()
  with open(path, 'wb') as f:
    f.write(blob[:-100])
  with pytest.raises(ValueError, match='truncated'):
    export.load_artifact(path)


def _recnet_conf():
  with open(os.path.join(REPO, 'configs', '1-recnet.json')) as f:
    conf = json.load(f)
  conf['model']['num_filters'] = 8
  conf.update(train_dataset='Synthetic', validation_dataset='Synthetic',
              synthetic={'image_size': SIZE, 'num_train': 2, 'num_val': 4},
              num_data_workers=0, use_tensorboard=False)
  return conf


def _generator_conf(upsampling_mode=None):
  conf = synthetic_refinement_conf(SIZE, 2, 4, BATCH, narrow=True)
  if upsampling_mode is not None:
    conf['generator_model']['learnable_model']['upsampling_mode'] = \
        upsampling_mode
  return conf


CASES = {'1-recnet': (_recnet_conf, 3, 0),
         '2-refinement': (_generator_conf, 3, 10),
         '2-refinement bilinear': (
             lambda: _generator_conf('bilinear'), 3, 10),
         '2-refinement nn-biresize-conv': (
             lambda: _generator_conf('nn-biresize-conv'), 3, 10)}


def _host_batch(conf):
  dataset = load_dataset(conf, None, 'Synthetic', 'val')
  return next(iter(DataLoader(dataset, BATCH)))


def _replay_in_fresh_process(artifact, batch, tmp_path):
  """The artifact replayed on the CPU in a new interpreter; returns its
  outputs (sorted leaves) and the port modules that process imported."""
  feed, out = str(tmp_path / 'feed.pt'), str(tmp_path / 'out.pt')
  torch.save({k: v for k, v in batch.items()
              if isinstance(v, torch.Tensor)}, feed)
  code = (
      'import sys, torch\n'
      'from csmri_refinement_tpu_torch.utils.export import load_callable\n'
      'call, _ = load_callable({a!r}, "cpu")\n'
      'got = call(torch.load({f!r}))\n'
      'got = got if isinstance(got, dict) else {{"pred": got}}\n'
      'mods = sorted(m for m in sys.modules if m.startswith("csmri"))\n'
      'torch.save({{"out": got, "modules": mods}}, {o!r})\n').format(
          a=artifact, f=feed, o=out)
  proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                        capture_output=True, text=True,
                        timeout=REPLAY_TIMEOUT_S)
  assert proc.returncode == 0, proc.stderr[-3000:]
  result = torch.load(out)
  return result['out'], result['modules']


def _rel(got, want):
  """max |got − want| over max |want| (over 1 where want is all zero)."""
  want = np.asarray(want, np.float64)
  return np.abs(np.asarray(got, np.float64) - want).max() / \
      (np.abs(want).max() or 1.0)


@pytest.mark.parametrize('name', sorted(CASES))
def test_export_cli_replays_predict_and_jax(name, tmp_path):
  make_conf, n_dc, n_conv = CASES[name]
  conf_d = make_conf()
  conf_path = str(tmp_path / 'conf.json')
  with open(conf_path, 'w') as f:
    json.dump(conf_d, f)

  # A JAX checkpoint of the seeded JAX init, exported by the port's CLI
  jconf = JConfiguration.from_dict(conf_d)
  jrunner = jbuild_runner(jconf, conf_d['runner_type'], 'test')
  conf = Configuration.from_dict(conf_d)
  runner = build_runner(conf, conf.runner_type, 'test', 'cpu')
  host = _host_batch(conf)
  batch = runner.preparer.prepare_val(host)
  jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
  jrunner._ensure_initialized(jbatch)
  ckpt = str(tmp_path / 'jax.ckpt')
  jcheckpoints.save_checkpoint(ckpt, jconf, jrunner, 1, {})

  artifact = str(tmp_path / 'model.pt2')
  rc = export_model.main([conf_path, ckpt, artifact, '-b', str(BATCH),
                          '--device', 'cpu', '--verify'])
  assert rc == 0
  exported, header = export.load_artifact(artifact)
  assert header['input_keys'] == ['inp', 'kspace', 'mask']
  assert header['input_shapes']['inp'] == [BATCH, SIZE, SIZE, 2]
  assert header['platforms'] == ['cpu', 'cuda']
  assert header['meta']['runner_type'] == conf_d['runner_type']
  targets = [str(n.target) for n in exported.graph.nodes]
  assert targets.count('csmri.dc.default') == n_dc
  assert targets.count('csmri.conv_f32.default') == n_conv

  restore_checkpoint(ckpt, runner)
  want = runner.predict(batch)
  want = want if isinstance(want, dict) else {'pred': want}
  got, modules = _replay_in_fresh_process(artifact, batch, tmp_path)
  assert not [m for m in modules if m.split('.', 1)[-1].startswith(
      MODEL_MODULES)], modules
  assert sorted(got) == sorted(want)
  for key in want:
    assert _rel(got[key], want[key]) <= REPLAY_REL, key
  jwant = jrunner.predict(jbatch)
  jwant = jwant['pred'] if isinstance(jwant, dict) else jwant
  assert _rel(got['pred'], np.asarray(jwant)) <= JAX_REL
