"""The port's training CLI surface and checkpoint interop against the JAX
package.

Small sizes on the CPU (the synthetic RecNet of
``tests/test_torch_port_train.py`` at 32², a narrow GAN at 64²), the JAX
side jitted:

* ``utils/tensor_transforms.py`` on the same arrays;
* TensorBoard summaries: the comparison grid, and one epoch of each CLI
  resumed from the same JAX checkpoint with the same masks, each with a
  recording writer in place of tensorboardX's;
* preemption: the flag, the handler, a preset flag, a real SIGTERM;
* ``--resume`` from a JAX checkpoint: the optax moments, step counts and
  learning rates restored, then the next updates against the JAX runner's;
* ``deploy_checkpoint``, ``-p``/``--print-parameters``/``-v`` and
  ``quality_dtype_table --checkpoint``.
"""

import contextlib
import copy
import glob
import io
import json
import logging
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorboardX
import torch

import deploy_checkpoint as jdeploy_checkpoint
import train as jtrain
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu.training import build_runner as jbuild_runner
from csmri_refinement_tpu.training import prep as jprep
from csmri_refinement_tpu.models import construct_model as jconstruct_model
from csmri_refinement_tpu.utils import checkpoints as jcheckpoints
from csmri_refinement_tpu.utils import diagnostics as jdiagnostics
from csmri_refinement_tpu.utils import preemption as jpreemption
from csmri_refinement_tpu.utils import tensor_transforms as jtt
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import deploy_checkpoint
from csmri_refinement_tpu_torch import quality_dtype_table
from csmri_refinement_tpu_torch import train as ttrain
from csmri_refinement_tpu_torch.data import load_dataset
from csmri_refinement_tpu_torch.flagship import flagship_model
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.ops import undersample as tus
from csmri_refinement_tpu_torch.training import build_runner, prep
from csmri_refinement_tpu_torch.utils import checkpoints, diagnostics
from csmri_refinement_tpu_torch.utils import preemption
from csmri_refinement_tpu_torch.utils import tensor_transforms as tt
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables
from test_torch_port_data import jax_checkpoint, randomize, recnet_conf
from test_torch_port_data import gan_conf as scarseg_gan_conf
from test_torch_port_train import PARAM_ATOL
from test_torch_port_train import _conf_dict as recnet_synthetic_conf
from test_torch_port_validate import _use_jax_masks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH = 32, 4
GAN_SIZE = 64
# Moments restored from a JAX checkpoint are its f32 values moved by
# transposes and flips only: equal but for the float noise of nothing.
MOMENT_ATOL = 1e-7
# The GAN's updates at narrow widths: chip_smoke.py phase 16's bar.
GAN_LOSS_RTOL = 1e-3
# A prediction grid holds RecNet outputs: tests/test_dc_pallas.py:26.
GRID_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _process_state():
  """Both packages' CLIs install a SIGTERM handler and set up the root
  logger: restore both, and clear both preemption flags, around every
  test."""
  previous = {sig: signal.getsignal(sig) for sig in preemption.SIGNALS}
  root = logging.getLogger()
  level, handlers = root.level, list(root.handlers)
  preemption.reset()
  jpreemption.reset()
  yield
  preemption.reset()
  jpreemption.reset()
  for sig, handler in previous.items():
    signal.signal(sig, handler)
  for handler in list(root.handlers):
    root.removeHandler(handler)
  for handler in handlers:
    root.addHandler(handler)
  root.setLevel(level)


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _write_conf(path, conf_d):
  with open(path, 'w') as f:
    json.dump(conf_d, f)
  return str(path)


# --- tensor transforms -------------------------------------------------------


def _transform_cases():
  rng = np.random.RandomState(3)
  x = rng.uniform(-0.5, 1.5, (3, 8, 6, 2)).astype(np.float32)
  labels = rng.randint(0, 4, (2, 5, 5)).astype(np.int32)
  return {
      'normalize_range': ((x, (-0.5, 1.5)), {}),
      'normalize_range_unclamped': ((x, (-0.5, 1.5)), {'clamp': False}),
      'scale_to_range': ((x, (-1.0, 3.0)), {}),
      'scale_batch_per_example': ((x,), {}),
      'normalize_batch_per_example': ((x,), {}),
      'normalize_batch_per_example_mean_only': ((x,),
                                                {'normalize_std': False}),
      'complex_abs': ((x,), {}),
      'magnitude_image': ((x,), {}),
      'convert_to_one_hot': ((labels,), {}),
      'convert_to_one_hot_num_classes': ((labels,), {'num_classes': 6}),
  }


@pytest.mark.parametrize('case', sorted(_transform_cases()))
def test_tensor_transforms_match_jax(case):
  args, kwargs = _transform_cases()[case]
  name = case
  for suffix in ('_unclamped', '_mean_only', '_num_classes'):
    name = name.replace(suffix, '')
  jfn = getattr(jtt, name)
  tfn = fft.complex_abs if name == 'complex_abs' else getattr(tt, name)
  want = np.asarray(jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                          else a for a in args], **kwargs))
  got = tfn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args], **kwargs).numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_print_tensor_stats_logs_as_jax(caplog):
  x = np.random.RandomState(4).randn(4, 7).astype(np.float32)
  with caplog.at_level(logging.DEBUG):
    jtt.print_tensor_stats(jnp.asarray(x), 'x')
    tt.print_tensor_stats(torch.from_numpy(x), 'x')
    tt.print_tensor_stats(torch.from_numpy(x), 'x', debug=True)
  want, got, debug = caplog.records[-3:]
  assert got.getMessage() == want.getMessage()
  assert (got.levelno, debug.levelno) == (logging.INFO, logging.DEBUG)


# --- TensorBoard summaries ---------------------------------------------------


class RecordingWriter:
  """tensorboardX's ``SummaryWriter`` surface that the CLIs call."""

  def __init__(self, *args, **kwargs):
    self.scalars = []
    self.images = []
    self.closed = False

  def add_scalar(self, tag, value, step):
    self.scalars.append((tag, float(value), int(step)))

  def add_image(self, tag, image, step):
    self.images.append((tag, np.array(image), int(step)))

  def close(self):
    self.closed = True


@pytest.mark.parametrize('num_images', [1, 3, 5, 6])
def test_comparison_grid_matches_jax(num_images):
  rng = np.random.RandomState(num_images)
  targets = rng.rand(6, 9, 7, 1).astype(np.float32)
  preds = rng.rand(6, 9, 7, 1).astype(np.float32)
  want = jtrain.make_comparison_grid(targets, preds, num_images)
  got = ttrain.make_comparison_grid(targets, preds, num_images)
  assert got.dtype == want.dtype and got.ndim == 3 and got.shape[0] == 1
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('segmentation', [False, True],
                         ids=['magnitude', 'segmentation'])
def test_image_summary_matches_jax(segmentation):
  """``save_images_to_tensorboard``: the same grid, tag and step, class
  maps scaled by ``num_classes`` with ``tensorboard_segmentation``, and a
  summary skipped for a shape that is not an image."""
  rng = np.random.RandomState(5)
  conf_d = {'tensorboard_segmentation': segmentation, 'num_classes': 3}
  if segmentation:
    target = rng.randint(0, 3, (4, 8, 8, 1)).astype(np.int64)
    pred = rng.randint(0, 3, (4, 8, 8, 1)).astype(np.int64)
  else:
    target, pred = rng.rand(2, 4, 8, 8, 1).astype(np.float32)
  writers = RecordingWriter(), RecordingWriter()
  for module, writer, cls in ((jtrain, writers[0], JConfiguration),
                              (ttrain, writers[1], Configuration)):
    conf = cls.from_dict(conf_d)
    assert module.save_images_to_tensorboard(
        writer, conf, 3, 7, 'validation/t_0', pred, target) == 3
    assert module.save_images_to_tensorboard(
        writer, conf, 3, 7, 'validation/t_1', pred[..., 0],
        target[..., 0]) == 3
  (jtag, jimg, jstep), = writers[0].images
  (ttag, timg, tstep), = writers[1].images
  assert (ttag, tstep) == (jtag, jstep) == ('validation/t_0', 7)
  np.testing.assert_array_equal(timg, jimg)


def _fixed_train_masks(monkeypatch, acc):
  """Both packages' training masks replaced by one per slice index (the
  JAX package's cartesian mask of key ``index``), the same on both
  sides."""
  cache = {}

  def masks(indices, height, width):
    return np.stack([cache.setdefault(int(i), np.array(jmasks.cartesian_mask(
        jax.random.PRNGKey(int(i)), (1, height, width), acc))[0])
                     for i in np.asarray(indices)])

  def jax_prepare_train(self, rng, host_batch):
    gt = np.asarray(host_batch['gt'])
    return self._passthrough(dict(jus.undersample_batch(
        None, jnp.asarray(gt), fixed_mask=masks(host_batch['index'],
                                                *gt.shape[1:3]))),
                             host_batch)

  def port_prepare_train(self, generator, host_batch):
    gt = torch.as_tensor(np.asarray(host_batch['gt']))
    return self._passthrough(tus.undersample_batch(
        None, gt.to(self.device), fixed_mask=masks(host_batch['index'],
                                                   *gt.shape[1:3])),
                             host_batch)
  monkeypatch.setattr(jprep.RecBatchPreparer, 'prepare_train',
                      jax_prepare_train)
  monkeypatch.setattr(prep.RecBatchPreparer, 'prepare_train',
                      port_prepare_train)


def _jax_runner_checkpoint(path, conf_d, steps=0):
  """A JAX standard runner of ``conf_d``, initialized on a batch and
  trained ``steps`` steps on fixed-mask batches, saved at epoch 1.
  Returns (the runner, its remaining (JAX, port) batches)."""
  jconf = JConfiguration.from_dict(conf_d)
  jrunner = jbuild_runner(jconf, 'standard', 'train')
  batches = _recnet_batches(steps + 2)
  jrunner._ensure_initialized(batches[0][0])
  for step in range(steps):
    jrunner.state, _, _ = jrunner._train_step_fn(
        jrunner.state, batches[step][0], jax.random.PRNGKey(step))
  jcheckpoints.save_checkpoint(path, jconf, jrunner, 1, {})
  return jrunner, batches[steps:]


def _recnet_batches(n):
  """n (JAX, port) prepared batches of 32² phantoms with fixed masks."""
  conf = Configuration.from_dict(recnet_synthetic_conf(
      synthetic={'image_size': SIZE, 'num_train': n * BATCH}))
  data = load_dataset(conf, None, 'Synthetic', 'train')
  out = []
  for i in range(n):
    gt = np.stack([data[j]['gt'] for j in range(i * BATCH, (i + 1) * BATCH)])
    mask = np.array(jmasks.cartesian_mask(
        jax.random.PRNGKey(100 + i), (BATCH, SIZE, SIZE), 2.0))
    out.append((jus.undersample_batch(None, jnp.asarray(gt), fixed_mask=mask),
                tus.undersample_batch(None, torch.from_numpy(gt),
                                      fixed_mask=mask)))
  return out


def test_cli_summaries_match_jax(tmp_path, monkeypatch):
  """One epoch of the synthetic RecNet through each CLI, both resumed from
  the same JAX checkpoint with the same training and validation masks:
  the same scalar tags at the same global steps with the same values, and
  the same image grids."""
  conf_d = recnet_synthetic_conf(
      use_tensorboard=True, num_image_summaries=3, steps_per_train_summary=1,
      validation_checkpoint_metrics=[])
  conf_path = _write_conf(tmp_path / 'tiny.json', conf_d)
  ckpt = str(tmp_path / 'start.ckpt')
  _jax_runner_checkpoint(ckpt, conf_d)
  _fixed_train_masks(monkeypatch, 2.0)
  _use_jax_masks(monkeypatch, conf_path)
  jwriter, twriter = RecordingWriter(), RecordingWriter()
  monkeypatch.setattr(tensorboardX, 'SummaryWriter', lambda run_dir: jwriter)
  monkeypatch.setattr(ttrain, '_summary_writer', lambda run_dir: twriter)
  jtrain.main([conf_path, '--resume', ckpt, '--run-dir',
               str(tmp_path / 'jax')])
  runner = ttrain.main([conf_path, '--resume', ckpt, '--run-dir',
                        str(tmp_path / 'port'), '--device', 'cpu'])
  assert runner.step == 2 and jwriter.closed and twriter.closed

  want = {(tag, step): v for tag, v, step in jwriter.scalars}
  got = {(tag, step): v for tag, v, step in twriter.scalars}
  assert len(got) == len(twriter.scalars)
  assert sorted(got) == sorted(want)
  assert {tag for tag, _ in got} == {
      'train/loss', 'train/loss_MSE', 'train/psnr', 'validation/loss_MSE',
      'validation/psnr', 'validation/ssim'}
  assert {step for tag, step in got if tag.startswith('train/')} == {1, 2}
  assert {step for tag, step in got if tag.startswith('validation/')} == {2}
  for key, value in want.items():
    assert abs(got[key] - value) <= PARAM_ATOL * max(1.0, abs(value)), (
        key, got[key], value)

  assert [(t, s) for t, _, s in twriter.images] == \
      [(t, s) for t, _, s in jwriter.images] == \
      [('validation/targets_and_predictions_0', 2)]
  (_, got_grid, _), = twriter.images
  (_, want_grid, _), = jwriter.images
  assert got_grid.shape == want_grid.shape == (1, 2 * (SIZE + 2) + 2,
                                               3 * (SIZE + 2) + 2)
  assert np.isfinite(got_grid).all()
  np.testing.assert_allclose(got_grid, want_grid, atol=GRID_ATOL)


def test_cli_without_tensorboardx_warns_and_trains(tmp_path, monkeypatch,
                                                   capsys):
  """Where tensorboardX cannot be imported the CLI logs the JAX
  package's warning and trains on without summaries."""
  monkeypatch.setitem(sys.modules, 'tensorboardX', None)
  conf_path = _write_conf(tmp_path / 'tiny.json', recnet_synthetic_conf(
      use_tensorboard=True, num_image_summaries=2))
  runner = ttrain.main([conf_path, '--device', 'cpu', '--log-dir',
                        str(tmp_path / 'runs')])
  assert runner.step == 2
  assert 'WARNING: tensorboardX not available; disabling summaries' in \
      capsys.readouterr().out


# --- preemption --------------------------------------------------------------


def _preempt_conf(num_epochs):
  return recnet_synthetic_conf(
      run_name='preempt', num_epochs=num_epochs,
      model={'name': 'RecNet', 'num_blocks': 1, 'num_convs': 2,
             'num_filters': 4},
      epochs_per_validation=1000, epochs_per_checkpoint=1000,
      validation_checkpoint_metrics=[])


def test_preemption_flag_roundtrip():
  assert not preemption.requested()
  preemption.request(signal.SIGTERM)
  assert preemption.requested()
  preemption.reset()
  assert not preemption.requested()


def test_preemption_install_reports_previous_handler():
  before = signal.getsignal(signal.SIGTERM)
  previous = preemption.install()
  assert signal.getsignal(signal.SIGTERM) is preemption.request
  assert previous == {signal.SIGTERM: before}
  os.kill(os.getpid(), signal.SIGTERM)
  assert preemption.requested()


def test_preset_flag_stops_after_first_epoch_and_saves(tmp_path):
  """With the flag set, training runs one epoch, saves a checkpoint for
  epoch 2 and returns; resuming from it runs one more and saves 3."""
  conf_path = _write_conf(tmp_path / 'conf.json', _preempt_conf(50))
  log_dir = str(tmp_path / 'runs')
  preemption.request()
  runner = ttrain.main([conf_path, '--device', 'cpu', '--log-dir', log_dir])
  assert runner.step == 2
  ckpts = glob.glob(os.path.join(log_dir, 'preempt_*',
                                 'periodic-chkpt_*.ckpt'))
  assert [c.rsplit('_', 1)[1] for c in ckpts] == ['2.ckpt']

  preemption.reset()
  preemption.request()
  resumed = ttrain.main([conf_path, '--device', 'cpu', '--resume',
                         ckpts[0]])
  assert resumed.step == 4
  assert glob.glob(os.path.join(log_dir, 'preempt_*',
                                'periodic-chkpt_*_3.ckpt'))


def test_sigterm_subprocess_checkpoints_and_exits_cleanly(tmp_path):
  """A real SIGTERM during training: the CLI ends the epoch, writes a
  checkpoint and exits 0."""
  conf_path = _write_conf(tmp_path / 'conf.json', _preempt_conf(10000))
  log_dir = str(tmp_path / 'runs')
  proc = subprocess.Popen(
      [sys.executable, '-m', 'csmri_refinement_tpu_torch.train', conf_path,
       '--device', 'cpu', '--log-dir', log_dir],
      cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  log_glob = os.path.join(log_dir, 'preempt_*', 'log_train_*.txt')
  try:
    deadline = time.time() + 120
    while time.time() < deadline:
      logs = glob.glob(log_glob)
      if logs and '===> Epoch[1]' in open(logs[0]).read():
        break
      time.sleep(0.2)
    else:
      pytest.fail('the trainer never logged a step')
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.communicate()
  assert proc.returncode == 0, out[-3000:]
  assert glob.glob(os.path.join(log_dir, 'preempt_*',
                                'periodic-chkpt_*.ckpt')), out[-3000:]
  log = open(glob.glob(log_glob)[0]).read()
  assert 'Preemption requested' in log
  assert 'Preemption: stopping after epoch' in log


def test_resume_refuses_an_inference_checkpoint(tmp_path):
  conf_d = recnet_synthetic_conf()
  conf_path = _write_conf(tmp_path / 'conf.json', conf_d)
  runner = build_runner(Configuration.from_dict(conf_d), 'standard', 'train',
                        'cpu')
  path = str(tmp_path / 'deployed.ckpt')
  torch.save({'conf': conf_d, 'runner': {'model': runner.model.state_dict()}},
             path)
  with pytest.raises(ValueError, match='Inference checkpoint'):
    ttrain.main([conf_path, '--device', 'cpu', '--resume', path,
                 '--run-dir', str(tmp_path / 'run')])


# --- --resume from a JAX checkpoint -----------------------------------------


def _moments(module, optimizer, key):
  """{parameter name: optimizer state ``key``} over ``module``'s
  parameters that ``optimizer`` holds."""
  names = {id(p): n for n, p in module.named_parameters()}
  return {names[id(p)]: optimizer.state[p][key]
          for group in optimizer.param_groups for p in group['params']}


def _assert_moments_equal_jax(module, optimizer, checkpoint, net_key,
                              opt_key, count, lr):
  """The port optimizer's state equals the optax state ``opt_key`` of a
  JAX checkpoint (decoded): each moment tree moved into ``module``'s
  layout, the step count and the learning rate."""
  inner = checkpoint['runner'][opt_key]['inner_state']['0']
  stats = checkpoint['runner'][net_key]['batch_stats']
  keys = {'mu': 'exp_avg', 'nu': 'exp_avg_sq'} if 'mu' in inner else \
      {'nu': 'nu'}
  for key, name in keys.items():
    twin = copy.deepcopy(module)
    load_flax_variables(twin, {'params': inner[key], 'batch_stats': stats})
    want = dict(twin.named_parameters())
    got = _moments(module, optimizer, name)
    assert got and len(got) == sum(p.requires_grad
                                   for p in module.parameters())
    for pname, value in got.items():
      assert value.device == want[pname].device
      np.testing.assert_allclose(value.numpy(), want[pname].detach().numpy(),
                                 atol=MOMENT_ATOL, rtol=0, err_msg=pname)
    if key == 'mu':
      assert any(float(v.abs().max()) > 0 for v in got.values())
  if 'count' in inner:
    assert int(inner['count']) == count
    for step in _moments(module, optimizer, 'step').values():
      assert step.item() == count
  assert all(g['lr'] == pytest.approx(lr, rel=1e-7)
             for g in optimizer.param_groups)


@pytest.mark.parametrize('optimizer', [
    {'name': 'Adam', 'learning_rate': 0.0002},
    {'name': 'RMSProp', 'learning_rate': 0.0002, 'alpha': 0.99}],
                         ids=['adam', 'rmsprop'])
def test_resume_standard_runner_from_jax_checkpoint(tmp_path, optimizer):
  """The JAX runner takes 3 steps and saves; the port resumes from that
  file with the moments, step count and learning rate restored; both take
  2 more steps on the same batches and end within PARAM_ATOL."""
  conf_d = recnet_synthetic_conf(optimizer=optimizer)
  path = str(tmp_path / 'jax.ckpt')
  jrunner, batches = _jax_runner_checkpoint(path, conf_d, steps=3)
  runner = build_runner(Configuration.from_dict(conf_d), 'standard', 'train',
                        'cpu')
  state = checkpoints.restore_checkpoint(path, runner)
  assert state['start_epoch'] == 1 and runner.step == 3
  _assert_moments_equal_jax(runner.model, runner.optimizer,
                            checkpoints.load_checkpoint(path), 'model',
                            'optimizer', 3, optimizer['learning_rate'])

  for step, (jb, tb) in enumerate(batches):
    jrunner.state, _, _ = jrunner._train_step_fn(
        jrunner.state, jb, jax.random.PRNGKey(10 + step))
    runner.train_batch(tb)
  want = copy.deepcopy(runner.model)
  load_flax_variables(want, {'params': _np_tree(jrunner.state['params'])})
  want = want.state_dict()
  for name, value in runner.model.state_dict().items():
    np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                               atol=PARAM_ATOL, err_msg=name)


def _gan_conf_d():
  """The narrow GAN of tests/test_torch_port_gan.py at 64², without the
  VGG19 loss, its pool larger than every image it is fed (so the pool,
  which no checkpoint holds, returns its input on both sides)."""
  from test_torch_port_gan import _conf_dict as gan_synthetic_conf
  conf_d = gan_synthetic_conf(
      synthetic={'image_size': GAN_SIZE, 'num_train': 8, 'num_val': 4},
      generator_losses=['FeaturePenalty'],
      generator_loss_weights={'gan': 0.5, 'FeaturePenalty': 2})
  return conf_d


def _gan_batches(conf_d, n):
  conf = Configuration.from_dict(dict(conf_d, synthetic={
      'image_size': GAN_SIZE, 'num_train': n * BATCH}))
  data = load_dataset(conf, None, 'Synthetic', 'train')
  out = []
  for i in range(n):
    gt = np.stack([data[j]['gt'] for j in range(i * BATCH, (i + 1) * BATCH)])
    mask = np.array(jmasks.cartesian_mask(
        jax.random.PRNGKey(i), (BATCH, GAN_SIZE, GAN_SIZE), 2.0))
    out.append((jus.undersample_batch(None, jnp.asarray(gt), fixed_mask=mask),
                tus.undersample_batch(None, torch.from_numpy(gt),
                                      fixed_mask=mask)))
  return out


@pytest.fixture(scope='module')
def gan_resume(tmp_path_factory):
  """A JAX GAN runner after 3 updates, saved; the port's runner restored
  from that file; 2 more updates on both. Returns (the checkpoint path,
  the port runner right after the restore (a copy), the JAX and port
  losses of the 2 updates, the conf dict)."""
  conf_d = _gan_conf_d()
  path = str(tmp_path_factory.mktemp('gan_resume') / 'jax.ckpt')
  jconf = JConfiguration.from_dict(conf_d)
  jrunner = jbuild_runner(jconf, 'adversarial', 'train')
  batches = _gan_batches(conf_d, 5)
  jrunner._ensure_initialized(batches[0][0])

  def jstep(jb, step):
    fn = jrunner._get_step_fn(True, True, True)
    (jrunner.gen_state, jrunner.disc_state, jrunner.pool_state, losses,
     _) = fn(jrunner.gen_state, jrunner.disc_state, jrunner.pool_state, jb,
             jax.random.PRNGKey(step))
    return {k: float(v) for k, v in losses.items()}
  for step in range(3):
    jstep(batches[step][0], step)
  jcheckpoints.save_checkpoint(path, jconf, jrunner, 1, {})
  runner = build_runner(Configuration.from_dict(conf_d), 'adversarial',
                        'train', 'cpu')
  checkpoints.restore_checkpoint(path, runner)
  restored = copy.deepcopy(runner)
  losses = []
  for step in range(3, 5):
    jb, tb = batches[step]
    want = jstep(jb, step)
    got = {k: v.item() for k, v in runner.train_batch(tb)[0].items()}
    losses.append((got, want))
  return path, restored, losses, conf_d


@pytest.mark.parametrize('net', ['generator', 'discriminator'])
def test_resume_adversarial_runner_restores_both_optimizers(gan_resume, net):
  path, runner, _, conf_d = gan_resume
  if net == 'generator':
    module, optimizer, key = runner.gen, runner.gen_optimizer, 'gen_optimizer'
  else:
    module, optimizer, key = (runner.disc, runner.disc_optimizer,
                              'disc_optimizer')
  _assert_moments_equal_jax(module, optimizer,
                            checkpoints.load_checkpoint(path), net, key, 3,
                            conf_d[net + '_optimizer']['learning_rate'])


def test_resume_adversarial_runner_updates_match_jax(gan_resume):
  _, _, losses, _ = gan_resume
  for got, want in losses:
    assert set(got) == set(want)
    for name, value in want.items():
      assert abs(got[name] - value) <= GAN_LOSS_RTOL * abs(value), (
          name, got[name], value)


def test_nonzero_moment_of_a_frozen_parameter_raises(gan_resume):
  """The JAX generator's optax tree covers the frozen RecNet, whose
  gradients JAX stops; the port's optimizer does not hold it, so a
  non-zero moment there cannot be placed and raises."""
  path, _, _, conf_d = gan_resume
  checkpoint = checkpoints.load_checkpoint(path)
  state = checkpoint['runner']
  frozen = state['gen_optimizer']['inner_state']['0']['mu'][
      'pretrained_model']['block_0']['conv_0']
  assert not np.any(frozen['bias'])
  frozen['bias'] = frozen['bias'] + 1e-3
  runner = build_runner(Configuration.from_dict(conf_d), 'adversarial',
                        'train', 'cpu')
  with pytest.raises(ValueError, match='outside the optimizer'):
    runner.load_state_dict(state)


def test_cli_resumes_a_jax_checkpoint(tmp_path):
  """``train --resume`` takes a JAX checkpoint and trains on from its
  epoch; the port's checkpoint it writes resumes as well."""
  conf_d = recnet_synthetic_conf(num_epochs=2)
  conf_path = _write_conf(tmp_path / 'conf.json', conf_d)
  ckpt = str(tmp_path / 'jax.ckpt')
  _jax_runner_checkpoint(ckpt, conf_d, steps=3)
  runner = ttrain.main([conf_path, '--device', 'cpu', '--resume', ckpt,
                        '--run-dir', str(tmp_path / 'run')])
  assert runner.step == 3 + 2 * 2
  assert runner.optimizer.state_dict()['state'][0]['step'].item() == 7
  assert glob.glob(str(tmp_path / 'run' / 'periodic-chkpt_*_3.ckpt'))


# --- deploy, diagnostics, quality table --------------------------------------


@pytest.mark.parametrize('runner_type', ['standard', 'adversarial'])
def test_deploy_checkpoint_matches_jax(tmp_path, runner_type):
  """The port's deploy CLI and the JAX one on the same JAX checkpoint: the
  same conf and network tensors (the port's a state dict, the JAX one's a
  flax tree loaded through the layout walk); the port's output restores
  into a test-mode runner."""
  conf_d = recnet_conf() if runner_type == 'standard' else \
      scarseg_gan_conf()
  src = str(tmp_path / 'train.ckpt')
  jax_checkpoint(src, conf_d)
  jax_out, port_out = str(tmp_path / 'jax.ckpt'), str(tmp_path / 'port.ckpt')
  jdeploy_checkpoint.main([runner_type, src, jax_out])
  deploy_checkpoint.main([runner_type, src, port_out])
  want, got = (checkpoints.load_checkpoint(p) for p in (jax_out, port_out))
  assert not checkpoints.is_flax_checkpoint(port_out)
  key, section = deploy_checkpoint.NETWORKS[runner_type]
  assert set(got) == set(want) == {'conf', 'runner'}
  assert set(got['runner']) == set(want['runner']) == {key}
  assert got['conf'] == want['conf']
  module = construct_model(conf_d[section])
  load_flax_variables(module, want['runner'][key])
  want_sd = module.state_dict()
  assert set(got['runner'][key]) == set(want_sd)
  for name, value in got['runner'][key].items():
    assert torch.equal(value, want_sd[name]), name
  runner = build_runner(Configuration.from_dict(conf_d), runner_type, 'test',
                        'cpu')
  assert 'start_epoch' not in checkpoints.restore_checkpoint(port_out, runner)


def test_deploy_checkpoint_of_a_port_checkpoint(tmp_path):
  conf_d = recnet_synthetic_conf()
  runner = build_runner(Configuration.from_dict(conf_d), 'standard', 'train',
                        'cpu')
  src, out = str(tmp_path / 'train.ckpt'), str(tmp_path / 'deployed.ckpt')
  checkpoints.save_checkpoint(src, Configuration.from_dict(conf_d), runner,
                              3, {})
  deployed = deploy_checkpoint.main(['standard', src, out])
  loaded = torch.load(out, weights_only=True)
  assert set(loaded) == {'conf', 'runner'} and set(loaded['runner']) == {
      'model'}
  for name, value in runner.model.state_dict().items():
    assert torch.equal(loaded['runner']['model'][name], value), name
  assert set(deployed['runner']) == {'model'}
  with pytest.raises(SystemExit):
    deploy_checkpoint.main(['other', src, out])


def _jax_parameter_listing(jrunner):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    jdiagnostics.print_model_parameters(jrunner)
  return out.getvalue()


@pytest.mark.parametrize('runner_type', ['standard', 'adversarial'])
def test_print_model_parameters_matches_jax(runner_type):
  """Per network the same count, and a line per parameter with the JAX
  package's flax path and shape, the frozen RecNet included."""
  conf_d = recnet_synthetic_conf() if runner_type == 'standard' else \
      _gan_conf_d()
  jrunner = jbuild_runner(JConfiguration.from_dict(conf_d), runner_type,
                          'train')
  batch = (_recnet_batches(1) if runner_type == 'standard' else
           _gan_batches(conf_d, 1))[0][0]
  jrunner._ensure_initialized(batch)
  want = _jax_parameter_listing(jrunner)
  runner = build_runner(Configuration.from_dict(conf_d), runner_type,
                        'train', 'cpu')
  got = io.StringIO()
  with contextlib.redirect_stdout(got):
    diagnostics.print_model_parameters(runner)
  assert got.getvalue() == want
  assert ('generator: ' in want) == (runner_type == 'adversarial')


def test_cli_print_flags_and_verbose(tmp_path, capsys):
  """``-p`` prints the runner, ``--print-parameters`` its parameters,
  ``-v`` logs at DEBUG the resolved config and each step's metrics."""
  conf_path = _write_conf(tmp_path / 'tiny.json', recnet_synthetic_conf())
  runner = ttrain.main([conf_path, '--device', 'cpu', '--dry', '-p',
                        '--print-parameters', '-v'])
  out = capsys.readouterr().out
  assert out.startswith('Model:\n' + str(runner.model)) or \
      ('Model:\n' + str(runner.model)) in out
  count = sum(p.numel() for p in runner.model.parameters())
  assert 'model: {:,} parameters'.format(count) in out
  assert "  ['block_0']['conv_0']['kernel']: (3, 3, 2, 8) -> 144" in out
  assert 'DEBUG: Configuration object' in out and '  loss_name: MSE' in out
  assert '===> Epoch[1](1/2): ' in out and '\n     psnr: ' in out


def test_cli_profile_dir_writes_a_trace(tmp_path):
  conf_path = _write_conf(tmp_path / 'tiny.json', recnet_synthetic_conf())
  prof = tmp_path / 'prof'
  ttrain.main([conf_path, '--device', 'cpu', '--dry', '--profile-dir',
               str(prof)])
  trace, = glob.glob(str(prof / '*.pt.trace.json'))
  with open(trace) as f:
    events = json.load(f)['traceEvents']
  assert any('conv' in e.get('name', '') for e in events)


def test_quality_table_reads_either_packages_checkpoint(tmp_path):
  """``--checkpoint``: the flagship's generator of a JAX checkpoint and of
  a port checkpoint holding the same weights give the same table, and
  not the random init's."""
  with open(os.path.join(REPO, 'configs', '2-refinement.json')) as f:
    section = json.load(f)['generator_model']
  section['pretrained_model'].pop('pretrained_weights', None)
  jmodel = jconstruct_model(JConfiguration.from_dict(section),
                            section['name'])
  zeros = jnp.zeros((1, 16, 16, 2))
  variables = jmodel.init(jax.random.PRNGKey(0), zeros, zeros,
                          jnp.ones((1, 16, 16, 1)))
  variables = _np_tree({key: randomize(value, 11)
                        for key, value in variables.items()})
  jpath = str(tmp_path / 'jax.ckpt')
  jcheckpoints.save_raw_checkpoint(jpath, {'conf': {}, 'runner': {
      'generator': variables}})
  model = flagship_model()
  load_flax_variables(model, variables)
  tpath = str(tmp_path / 'port.ckpt')
  torch.save({'conf': {}, 'runner': {'generator': model.state_dict()}},
             tpath)
  common = ['--sizes', '32', '--batch', '2', '--device', 'cpu']
  rows = [quality_dtype_table.main(common + ['--checkpoint', path])
          for path in (jpath, tpath)]
  assert rows[0] == rows[1]
  assert [r[1].split()[0] for r in rows[0]] == ['f32', 'bf16', 'int8']
  assert all(np.isfinite(r[2:]).all() for r in rows[0])
  assert rows[0][0][2] != quality_dtype_table.main(common)[0][2]
