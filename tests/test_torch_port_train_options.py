"""Mixed-precision and memory-mode training in the port against the JAX
package: ``train_dtype``, ``train_remat``, ``steps_per_fetch``, U-Net
``remat``, ``vgg_loss.dtype`` and ``use_scan`` (the standard runner and
the networks; ``tests/test_torch_port_gan_options.py`` holds the
adversarial runner).

Bars. bf16 rounding is not the same in XLA and in oneDNN: one bf16 conv
rounds to within a bf16 ulp (2**-8) of the other, and a forward of several
layers drifts by about 1% of max |ref|. Each bf16 forward is held to JAX
bf16 on the same weights within ``BF16_REL`` of max |ref|, the int8 path's
bar; each test states the error it reads. A remat run and a
``steps_per_fetch`` run are held to the plain run bit for bit: on the CPU
both compute the same operations in the same order.
"""

import contextlib
import copy
import glob
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import validate as jvalidate
from csmri_refinement_tpu.models import construct_model as jconstruct_model
from csmri_refinement_tpu.models import vgg as jvgg
from csmri_refinement_tpu.training import build_runner as jbuild_runner
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch import train as ttrain
from csmri_refinement_tpu_torch import validate
from csmri_refinement_tpu_torch.data import DataLoader, datasets, load_dataset
from csmri_refinement_tpu_torch.models import construct_model
from csmri_refinement_tpu_torch.models import vgg as tvgg
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.training.base_runner import to_host
from csmri_refinement_tpu_torch.utils import checkpoints, diagnostics
from csmri_refinement_tpu_torch.utils import preemption
from csmri_refinement_tpu_torch.utils.config import Configuration
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables
from test_torch_port_cli import _process_state  # noqa: F401 (autouse)
from test_torch_port_cli import (RecordingWriter, _assert_moments_equal_jax,
                                 _jax_parameter_listing,
                                 _jax_runner_checkpoint, _recnet_batches,
                                 _write_conf)
from test_torch_port_data import jax_checkpoint, recnet_conf
from test_torch_port_gan import _conf_dict as gan_conf_dict
from test_torch_port_seg import _random_variables, _seg_model
from test_torch_port_train import _conf_dict as recnet_conf_dict
from test_torch_port_validate import _use_jax_masks
from test_torch_port_validate import jax_metrics  # noqa: F401 (fixture)

BF16_REL = 2e-2
# One Adam step moves a weight by about lr whatever its gradient's size,
# and bf16 rounding decides the sign of the gradients that are near zero:
# so after one step a weight is within 2·lr of JAX's (the reasoning of
# tests/test_torch_port_seg.py's ADAM_SPREAD), and nearly all are within
# a tenth of lr.
LR = 2e-4
ADAM_SPREAD = 2 * LR
PARAMS_CLOSE = 0.9
# The JAX validate CLI and the port's on the same checkpoint and masks
# (tests/test_torch_port_validate.py).
PSNR_ATOL, SSIM_ATOL = 1e-3, 1e-4
TRAIN_KEYS = {'train_dtype': 'bfloat16', 'train_remat': True,
              'steps_per_fetch': 4}
NUM_VAL = 8


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
  """max |got - want| over max |want|, both as f32."""
  got = np.asarray(got.float().detach() if isinstance(got, torch.Tensor)
                   else got, np.float32)
  want = np.asarray(want, np.float32)
  return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_equal_states(got, want):
  assert set(got) == set(want)
  for name, value in want.items():
    assert torch.equal(got[name], value), name


def _epoch(conf_d, num_epochs=1):
  """A CPU runner of ``conf_d`` after ``num_epochs`` epochs on an
  unshuffled loader; returns (runner, [the epochs' loss averages])."""
  conf = Configuration.from_dict(conf_d)
  runner = build_runner(conf, conf_d['runner_type'], 'train', 'cpu')
  train_set = load_dataset(conf, None, 'Synthetic', 'train')
  losses = []
  for epoch in range(1, num_epochs + 1):
    loader = DataLoader(train_set, conf.batch_size, shuffle=False)
    averages = runner.train_epoch(loader, epoch,
                                  steps_per_train_summary=100)[0]
    losses.append({name: m.value for name, m in averages.items()})
  return runner, losses


# --- mode 'test' ignores the training options ------------------------------


@pytest.mark.parametrize('runner_type', ['standard', 'adversarial'])
def test_eval_mode_ignores_train_options(runner_type):
  """Mode 'test' refuses none of the three keys and ignores them, as the
  JAX runners do (``test_eval_mode_ignores_train_dtype``): no network
  takes ``train_dtype``, ``steps_per_fetch`` is 1, ``train_remat`` off."""
  base = recnet_conf_dict() if runner_type == 'standard' else \
      gan_conf_dict()
  conf_d = dict(base, **TRAIN_KEYS)
  jrunner = jbuild_runner(JConfiguration.from_dict(conf_d), runner_type,
                          'test')
  runner = build_runner(Configuration.from_dict(conf_d), runner_type,
                        'test', 'cpu')
  assert (runner.steps_per_fetch, runner.train_remat) == \
      (jrunner.steps_per_fetch, jrunner.train_remat) == (1, False)
  if runner_type == 'standard':
    assert runner.model.dtype is None and jrunner.model.dtype is None
  else:
    for name in ('pretrained_model', 'learnable_model'):
      assert getattr(runner.gen, name).dtype is None
      assert getattr(jrunner.gen, name).dtype is None
    assert runner.disc is None and jrunner.disc is None


@pytest.fixture(scope='module')
def scarseg(tmp_path_factory):
  """A ScarSeg-format tree (52-slice validation cases of 64² phantoms, the
  others of one slice, as tests/test_torch_port_validate.py writes it) and
  JAX RecNet checkpoints,
  unrolled and use_scan, each beside its config."""
  root = tmp_path_factory.mktemp('train_options')
  data_dir = str(root / 'data')
  datasets.write_scarseg_phantoms(data_dir, 64, datasets.NUM_SLICES, seed=2,
                                  cases=datasets.STATIC_SPLIT['val'])
  datasets.write_scarseg_phantoms(
      data_dir, 64, 1, seed=3,
      cases=datasets.STATIC_SPLIT['train'] + datasets.STATIC_SPLIT['test'])
  out = {'data': data_dir}
  for name, scan in (('recnet', False), ('recnet_scan', True)):
    conf_d = recnet_conf(num_validation_subset_samples=NUM_VAL)
    if scan:
      conf_d['model'] = dict(conf_d['model'], use_scan=True)
    ckpt = str(root / (name + '.ckpt'))
    jax_checkpoint(ckpt, conf_d)
    out[name] = (ckpt, conf_d)
  return out


@pytest.mark.parametrize('name', ['recnet', 'recnet_scan'])
def test_validate_ignores_train_options_as_jax(scarseg, tmp_path,
                                               monkeypatch, jax_metrics,
                                               name):
  """``validate`` on the CPU with a config that carries ``train_dtype``,
  ``train_remat`` and ``steps_per_fetch`` gives the metrics it gives
  without them, and the JAX CLI's on the same JAX checkpoint and masks
  (for ``recnet_scan`` one whose RecNet the JAX package saved stacked)."""
  ckpt, conf_d = scarseg[name]
  paths = {}
  for label, keys in (('plain', {}), ('train_options', TRAIN_KEYS)):
    paths[label] = _write_conf(tmp_path / (label + '.json'),
                               dict(conf_d, **keys))
  _use_jax_masks(monkeypatch, paths['plain'])
  flags = ['--data-dir', scarseg['data'], '-b', '4', '--dry']
  jvalidate.main([paths['train_options'], ckpt] + flags)
  want, = jax_metrics
  got = {label: validate.main([path, ckpt, '--device', 'cpu'] + flags)[
      'ScarSeg']['metrics'] for label, path in paths.items()}
  assert got['plain'] == got['train_options']
  assert abs(got['plain']['psnr'] - want['psnr']) <= PSNR_ATOL
  assert abs(got['plain']['ssim'] - want['ssim']) <= SSIM_ATOL


# --- bf16 networks against JAX bf16 ----------------------------------------


def _train_forward(jmodel, variables, *args):
  """JAX's train-mode output and updated batch statistics (the output
  alone for a model without a train flag), jitted."""
  def fn(v, *a):
    if not getattr(jmodel, 'HAS_TRAIN_ARG', False):
      return jmodel.apply(v, *a), {}
    out, updated = jmodel.apply(v, *a, train=True, mutable=['batch_stats'])
    return out, updated['batch_stats']
  return jax.jit(fn)(variables, *[jnp.asarray(a) for a in args])


def _disc_section():
  section = dict(gan_conf_dict()['discriminator_model'],
                 name='CNNDiscriminator')
  for key in ('input_method', 'use_image_pool', 'image_pool_size',
              'dropout_after', 'dropout_prob'):
    section.pop(key)
  return section


# The sections at narrow widths: the GAN's generator U-Net (k4 subpixel
# nn-resize-conv, reflection, BN on the up path only), the segmentation
# U-Net (k3, pixelshuffle, two layers a scale), a 2×3×8 RecNet with its
# DC, the paper's discriminator with BN after each layer.
BF16_SECTIONS = {
    'unet_flagship': dict(gan_conf_dict()['generator_model'][
        'learnable_model'], weight_init={}),
    'unet_segmentation': _seg_model(),
    'recnet': {'name': 'RecNet', 'num_blocks': 2, 'num_convs': 3,
               'num_filters': 8},
    'discriminator': _disc_section(),
}
# Measured (max |port - JAX| over max |JAX|, on an x86 CPU): the flagship
# U-Net 9.2e-3, the segmentation U-Net 1.5e-2, RecNet 4.8e-3, the
# discriminator's logits 5.4e-3 (each feature map within 7.9e-3); the f32
# running statistics within 4.4e-4.
STATS_REL = 2e-3


@pytest.mark.parametrize('name', sorted(BF16_SECTIONS))
def test_bf16_train_forward_matches_jax(name):
  """A network built with dtype bfloat16: its train-mode forward in bf16
  and its running statistics in f32, each within its bar of JAX's on the
  same f32 parameters; the parameters stay f32."""
  section = BF16_SECTIONS[name]
  rng = np.random.RandomState(0)
  cin = 1 if name == 'discriminator' else 2
  x = rng.randn(2, 32, 32, cin).astype(np.float32)
  args = [x]
  if name == 'recnet':
    mask = (rng.rand(2, 32, 32, 1) < 0.4).astype(np.float32)
    args += [rng.randn(2, 32, 32, 2).astype(np.float32) * mask, mask]
  jmodel = jconstruct_model(JConfiguration.from_dict(
      dict(section, dtype='bfloat16')), section['name'])
  variables = _random_variables(jmodel.init, *[jnp.asarray(a) for a in args])
  want, want_stats = _train_forward(jmodel, variables, *args)

  port = construct_model(dict(section, dtype='bfloat16'))
  load_flax_variables(port, _np(variables))
  port.train()
  got = port(*[torch.from_numpy(a) for a in args])
  assert all(t.dtype == torch.float32 for t in port.state_dict().values()
             if t.is_floating_point())
  if name == 'discriminator':
    pairs = list(zip(got['features'], want['features']))
    pairs.append((got['logits'], want['logits']))
  else:
    pairs = [(got, want)]
  for g, w in pairs:
    assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
    assert _rel(g, w) <= BF16_REL
  if want_stats:
    twin = construct_model(section)
    load_flax_variables(twin, _np({'params': variables['params'],
                                   'batch_stats': want_stats}))
    want_sd = twin.state_dict()
    for key, value in port.state_dict().items():
      if 'running' in key:
        assert _rel(value, want_sd[key].numpy()) <= STATS_REL, key


def test_bf16_vgg19_blocks_match_jax():
  """VGG19 blocks 1 and 4 in bf16 (measured 5.3e-3 and 5.5e-3 of max
  |ref|); the parameters stay f32."""
  rng = np.random.RandomState(1)
  x = rng.rand(2, 32, 32, 3).astype(np.float32)
  jmodel = jvgg.VGG19(output_blocks=(1, 4), dtype=jnp.bfloat16)
  variables = _random_variables(jmodel.init, jnp.asarray(x))
  want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
  port = tvgg.VGG19((1, 4), torch.bfloat16)
  load_flax_variables(port, _np(variables))
  got = port(torch.from_numpy(x))
  assert port.conv_0.weight.dtype == torch.float32
  for g, w in zip(got, want):
    assert g.dtype == torch.bfloat16
    assert _rel(g.permute(0, 2, 3, 1), w) <= BF16_REL


# --- which dtype each network takes ----------------------------------------


@pytest.mark.parametrize('model_dtype,vgg_dtype', [
    (None, None), ('float32', None), (None, 'float32'),
    ('float32', 'bfloat16')])
def test_explicit_dtypes_win_over_train_dtype(model_dtype, vgg_dtype):
  """``train_dtype`` sets the model's and the VGG19's compute dtype in
  mode 'train'; a model section's ``dtype`` and ``vgg_loss.dtype`` win.
  Each decision as the JAX package makes it (mode 'test' ignores
  ``train_dtype``: ``test_eval_mode_ignores_train_options``)."""
  model = dict(recnet_conf_dict()['model'])
  if model_dtype:
    model['dtype'] = model_dtype
  conf_d = recnet_conf_dict(model=model, train_dtype='bfloat16',
                            losses=['MSE', 'VGG19'], vgg_random_init=True)
  conf_d.pop('loss_name')
  if vgg_dtype:
    conf_d['vgg_loss'] = {'dtype': vgg_dtype}
  names = {None: None, 'float32': torch.float32, 'bfloat16': torch.bfloat16}
  jnames = {None: None, 'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
  jrunner = jbuild_runner(JConfiguration.from_dict(conf_d), 'standard',
                          'train')
  runner = build_runner(Configuration.from_dict(conf_d), 'standard',
                        'train', 'cpu')
  want_model = model_dtype or 'bfloat16'
  assert runner.model.dtype == names[want_model]
  assert jrunner.model.dtype == jnames[want_model]
  want_vgg = vgg_dtype or 'bfloat16'
  assert runner.criteria['VGG19'].criterion.vgg.dtype == names[want_vgg]
  assert jrunner.criteria['VGG19'].criterion.vgg.dtype == jnames[want_vgg]


# --- one bf16 step of the standard runner against JAX ----------------------


def test_bf16_standard_step_matches_jax():
  """One bf16 update of the synthetic RecNet runner on the same weights
  and fixed-mask batch as the JAX runner: the losses within BF16_REL
  (measured 1.5e-5 relative), every parameter within ADAM_SPREAD (worst
  3.9e-4) and nearly all within a tenth of lr (99.5%); parameters and Adam
  moments stay f32."""
  conf_d = recnet_conf_dict(train_dtype='bfloat16')
  jrunner = jbuild_runner(JConfiguration.from_dict(conf_d), 'standard',
                          'train')
  runner = build_runner(Configuration.from_dict(conf_d), 'standard', 'train',
                        'cpu')
  (jb, tb), = _recnet_batches(1)
  jrunner._ensure_initialized(jb)
  load_flax_variables(runner.model,
                      {'params': _np(jrunner.state['params'])})
  jrunner.state, jlosses, jout = jrunner._train_step_fn(
      jrunner.state, jb, jax.random.PRNGKey(0))
  losses, out = runner.train_batch(tb)
  assert out.dtype == torch.float32 and jout.dtype == jnp.float32
  for name in ('loss', 'MSE'):
    want = float(jlosses[name])
    assert abs(losses[name].item() - want) <= BF16_REL * abs(want), name
  want = copy.deepcopy(runner.model)
  load_flax_variables(want, {'params': _np(jrunner.state['params'])})
  want = want.state_dict()
  close = total = 0
  for name, value in runner.model.state_dict().items():
    assert value.dtype == torch.float32
    diff = (value - want[name]).abs()
    assert diff.max().item() <= ADAM_SPREAD, name
    close += int((diff <= LR / 10).sum())
    total += diff.numel()
  assert close >= PARAMS_CLOSE * total
  for entry in runner.optimizer.state_dict()['state'].values():
    assert entry['exp_avg'].dtype == entry['exp_avg_sq'].dtype == \
        torch.float32


# --- remat: bit-equal to the stored forward --------------------------------


def _seg_conf(**overrides):
  from test_torch_port_seg import _seg_conf_dict
  return _seg_conf_dict(num_epochs=1, **overrides)


@pytest.mark.parametrize('case', ['recnet', 'recnet_bf16', 'unet_remat',
                                  'unet_remat_train_remat'])
def test_remat_run_is_bit_equal_to_the_plain_run(case):
  """Two epochs with ``train_remat`` (RecNet; in bf16 too) or with the
  segmentation U-Net's ``remat`` (and both): every parameter, BN running
  statistic and step count bit-equal to the run that stores its forward
  (JAX's own bar is 1e-6, ``tests/test_runner.py:246-265``)."""
  if case.startswith('recnet'):
    plain = recnet_conf_dict(
        train_dtype='bfloat16' if case == 'recnet_bf16' else None)
    remat = dict(plain, train_remat=True)
  else:
    plain = _seg_conf()
    remat = _seg_conf(model=dict(plain['model'], remat=True),
                      train_remat=case == 'unet_remat_train_remat')
  want, want_losses = _epoch(plain, 2)
  got, got_losses = _epoch(remat, 2)
  assert got.train_remat == (case != 'unet_remat')
  assert got_losses == want_losses
  _assert_equal_states(got.model.state_dict(), want.model.state_dict())
  _assert_equal_states(got.optimizer.state_dict()['state'][0],
                       want.optimizer.state_dict()['state'][0])


@pytest.mark.parametrize('remat', [False, True])
def test_unet_remat_recomputes_each_unit_once_and_moves_bn_once(remat):
  """With ``remat`` the backward runs every encode and decode unit's
  forward again (JAX ``nn.remat``), and each BN moves its statistics and
  its count once."""
  model = construct_model(_seg_model(remat=remat))
  model.init_weights(torch.Generator().manual_seed(0))
  model.train()
  calls = {}
  units = [m for n, m in model.named_children() if 'code' in n]
  for unit in units:
    unit.register_forward_pre_hook(
        lambda m, args: calls.__setitem__(m, calls.get(m, 0) + 1))
  x = torch.randn(2, 16, 16, 2, generator=torch.Generator().manual_seed(1))
  model(x).square().mean().backward()
  assert len(units) == 5
  assert all(calls[unit] == (2 if remat else 1) for unit in units)
  counts = {int(m.num_batches_tracked) for m in model.modules()
            if isinstance(m, torch.nn.BatchNorm2d)}
  assert counts == {1}


def test_remat_checkpoint_replays_a_generator():
  """``models/remat.checkpoint``: the recompute draws the forward's values
  from a generator, and the generator then stands where it stood; the
  gradient equals the stored forward's."""
  from csmri_refinement_tpu_torch.models import remat
  w = torch.randn(4, 4, requires_grad=True)
  grads, states = [], []
  for use_remat in (False, True):
    gen = torch.Generator().manual_seed(3)

    def fn(x, g):
      return (x @ w) * torch.rand(x.shape, generator=g)
    x = torch.ones(2, 4)
    y = remat.checkpoint(fn, x, gen, generators=(gen,)) if use_remat \
        else fn(x, gen)
    after = gen.get_state()
    grads.append(torch.autograd.grad(y.sum(), w)[0])
    assert torch.equal(gen.get_state(), after)
    states.append(after)
  assert torch.equal(grads[0], grads[1])
  assert torch.equal(states[0], states[1])
  assert not remat.recomputing()


# --- steps_per_fetch: k updates per fetch, the trajectory of k steps -------


@pytest.mark.parametrize('num_train,k,chunks', [
    (12, 2, [2, 1]), (10, 3, [2, 1]), (16, 4, [4])],
                         ids=['partial_chunk', 'ragged_batch', 'whole'])
def test_steps_per_fetch_equals_single_steps(num_train, k, chunks):
  """Batches of 4 (the last of 10 samples ragged): each fetch's losses are
  the mean of its updates' as single steps report them, the parameters
  and Adam state after the epoch are bit-equal, no batch is held back, and
  a fetch returns no train metrics (JAX ``tests/test_runner.py:186-240``,
  there within 2e-5)."""
  synthetic = {'image_size': 32, 'num_train': num_train, 'num_val': 4}
  conf = Configuration.from_dict(recnet_conf_dict(synthetic=synthetic))
  train_set = load_dataset(conf, None, 'Synthetic', 'train')
  runs = {}
  for steps_per_fetch in (1, k):
    runner = build_runner(Configuration.from_dict(recnet_conf_dict(
        synthetic=synthetic, steps_per_fetch=steps_per_fetch)), 'standard',
                          'train', 'cpu')
    it = iter(DataLoader(train_set, 4, shuffle=False))
    fetches = []
    while True:
      n, losses, data = runner._train_step(it)
      if n == 0:
        break
      fetches.append((n, {name: m.value for name, m in losses.items()},
                      runner._compute_train_metrics(data)))
    runs[steps_per_fetch] = (runner, fetches)
  single, fetched = runs[1][1], runs[k][1]
  assert [n for n, _, _ in fetched] == chunks
  assert runs[k][0]._pending_host_batch is None
  assert all(metrics == {} for _, _, metrics in fetched)
  start = 0
  for n, losses, _ in fetched:
    assert set(losses) == {'loss', 'loss_MSE'}
    for name, value in losses.items():
      want = np.mean(np.float32([single[i][1][name]
                                 for i in range(start, start + n)]))
      assert value == pytest.approx(float(want), rel=1e-6), name
    start += n
  assert runs[k][0].step == len(single) == start
  _assert_equal_states(runs[k][0].model.state_dict(),
                       runs[1][0].model.state_dict())
  for i, entry in runs[1][0].optimizer.state_dict()['state'].items():
    _assert_equal_states(runs[k][0].optimizer.state_dict()['state'][i],
                         entry)


# --- use_scan ---------------------------------------------------------------


@pytest.mark.parametrize('num_filters', [4, [4, 8, 4]],
                         ids=['homogeneous', 'heterogeneous'])
def test_use_scan_recnet_matches_jax(num_filters):
  """A use_scan RecNet on a JAX tree: a homogeneous cascade's stacked
  ``blocks/block`` (JAX ``_forward_scan``, ``tests/test_recnet.py:152``),
  a heterogeneous one's ``block_i`` (JAX runs it unrolled); the forward
  within the DC's bar of JAX's."""
  section = {'name': 'RecNet', 'num_blocks': 3, 'num_convs': 2,
             'num_filters': num_filters, 'use_scan': True}
  rng = np.random.RandomState(2)
  mask = (rng.rand(2, 16, 16, 1) < 0.4).astype(np.float32)
  args = [rng.randn(2, 16, 16, 2).astype(np.float32),
          rng.randn(2, 16, 16, 2).astype(np.float32) * mask, mask]
  jmodel = jconstruct_model(JConfiguration.from_dict(section), 'RecNet')
  variables = _random_variables(jmodel.init, *[jnp.asarray(a) for a in args])
  homogeneous = isinstance(num_filters, int)
  assert set(variables['params']) == (
      {'blocks'} if homogeneous else {'block_0', 'block_1', 'block_2'})
  want = jax.jit(jmodel.apply)(variables, *[jnp.asarray(a) for a in args])
  port = construct_model(section)
  assert port.scan_layout == homogeneous
  load_flax_variables(port, _np(variables))
  with torch.no_grad():
    got = port(*[torch.from_numpy(a) for a in args])
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_use_scan_parameter_listing_matches_jax():
  """``--print-parameters`` of a use_scan run lists each stacked leaf once
  with its stacked shape, as the JAX package prints its tree."""
  model = dict(recnet_conf_dict()['model'], use_scan=True)
  conf_d = recnet_conf_dict(model=model)
  jrunner = jbuild_runner(JConfiguration.from_dict(conf_d), 'standard',
                          'train')
  jrunner._ensure_initialized(_recnet_batches(1)[0][0])
  want = _jax_parameter_listing(jrunner)
  got = io.StringIO()
  with contextlib.redirect_stdout(got):
    diagnostics.print_model_parameters(build_runner(
        Configuration.from_dict(conf_d), 'standard', 'train', 'cpu'))
  assert got.getvalue() == want
  assert "['blocks']['block']['conv_0']['kernel']: (2, 3, 3, 2, 8)" in want


def test_resume_a_jax_use_scan_run_with_its_optax_state(tmp_path):
  """A JAX use_scan run takes 3 steps and saves; the port resumes from the
  file with its Adam moments (stacked in the optax state) and step count,
  and both take 2 more steps on the same batches within the trajectory
  test's bar."""
  from test_torch_port_train import PARAM_ATOL
  conf_d = recnet_conf_dict(model=dict(recnet_conf_dict()['model'],
                                       use_scan=True))
  path = str(tmp_path / 'jax.ckpt')
  jrunner, batches = _jax_runner_checkpoint(path, conf_d, steps=3)
  assert 'blocks' in jrunner.state['params']
  runner = build_runner(Configuration.from_dict(conf_d), 'standard', 'train',
                        'cpu')
  assert checkpoints.restore_checkpoint(path, runner)['start_epoch'] == 1
  assert runner.step == 3
  _assert_moments_equal_jax(runner.model, runner.optimizer,
                            checkpoints.load_checkpoint(path), 'model',
                            'optimizer', 3, LR)
  for step, (jb, tb) in enumerate(batches):
    jrunner.state, _, _ = jrunner._train_step_fn(
        jrunner.state, jb, jax.random.PRNGKey(10 + step))
    runner.train_batch(tb)
  want = copy.deepcopy(runner.model)
  load_flax_variables(want, {'params': _np(jrunner.state['params'])})
  want = want.state_dict()
  for name, value in runner.model.state_dict().items():
    np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                               atol=PARAM_ATOL, err_msg=name)


# --- checkpoints and the CLI -----------------------------------------------


def test_bf16_remat_checkpoint_holds_f32_and_resumes_the_trajectory(
    tmp_path):
  """A bf16 remat run's checkpoint holds f32 parameters and optimizer
  state; a runner restored from it trains the next epoch bit-equal to the
  run that wrote it."""
  conf_d = recnet_conf_dict(train_dtype='bfloat16', train_remat=True)
  conf = Configuration.from_dict(conf_d)
  runner, _ = _epoch(conf_d)
  path = str(tmp_path / 'run.ckpt')
  checkpoints.save_checkpoint(path, conf, runner, 2, {})
  saved = checkpoints.load_checkpoint(path)['runner']
  floats = list(saved['model'].values()) + [
      t for entry in saved['optimizer']['state'].values()
      for t in entry.values()]
  assert all(t.dtype == torch.float32 for t in floats if
             t.is_floating_point() and t.dim())
  resumed = build_runner(conf, 'standard', 'train', 'cpu')
  assert checkpoints.restore_checkpoint(path, resumed)['start_epoch'] == 2
  train_set = load_dataset(conf, None, 'Synthetic', 'train')
  for r in (runner, resumed):
    r.train_epoch(DataLoader(train_set, conf.batch_size, shuffle=False), 2,
                  steps_per_train_summary=100)
  _assert_equal_states(resumed.model.state_dict(), runner.model.state_dict())
  for i, entry in runner.optimizer.state_dict()['state'].items():
    _assert_equal_states(resumed.optimizer.state_dict()['state'][i], entry)


def test_cli_with_train_options_summarises_every_k_steps(tmp_path,
                                                         monkeypatch):
  """The training CLI with ``train_dtype``, ``train_remat`` and
  ``steps_per_fetch`` 2 over 4 batches: the ``train/`` scalars at global
  steps 2 and 4, each the mean of two single steps' losses as the same
  run with k = 1 writes them, the parameter listing as without the
  options, and a preemption stops after the epoch with a checkpoint that
  resumes."""
  synthetic = {'image_size': 32, 'num_train': 16, 'num_val': 4}
  base = recnet_conf_dict(synthetic=synthetic, use_tensorboard=True,
                          num_image_summaries=0, steps_per_train_summary=1,
                          validation_checkpoint_metrics=[],
                          train_dtype='bfloat16', train_remat=True)
  writers = {}
  monkeypatch.setattr(ttrain, '_summary_writer', lambda run_dir: writers[
      run_dir.rsplit(os.sep, 1)[-1]])
  runners = {}
  for k in (1, 2):
    conf_path = _write_conf(tmp_path / 'k{}.json'.format(k),
                            dict(base, steps_per_fetch=k))
    writers['k{}'.format(k)] = RecordingWriter()
    runners[k] = ttrain.main([conf_path, '--device', 'cpu', '--run-dir',
                              str(tmp_path / 'k{}'.format(k))])
  assert runners[1].step == runners[2].step == 4
  single = {(t, s): v for t, v, s in writers['k1'].scalars
            if t.startswith('train/loss')}
  fetched = {(t, s): v for t, v, s in writers['k2'].scalars
             if t.startswith('train/')}
  assert sorted(fetched) == [(t, s) for t in ('train/loss', 'train/loss_MSE')
                             for s in (2, 4)]
  for (tag, step), value in fetched.items():
    want = np.mean(np.float32([single[(tag, step - 1)], single[(tag, step)]]))
    assert value == pytest.approx(float(want), rel=1e-6), (tag, step)
  _assert_equal_states(runners[2].model.state_dict(),
                       runners[1].model.state_dict())

  listings = []
  for runner in (runners[2], build_runner(Configuration.from_dict(
      recnet_conf_dict(synthetic=synthetic)), 'standard', 'train', 'cpu')):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
      diagnostics.print_model_parameters(runner)
    listings.append(out.getvalue())
  assert listings[0] == listings[1]

  conf_path = _write_conf(tmp_path / 'preempt.json', dict(
      base, steps_per_fetch=2, use_tensorboard=False, num_epochs=50))
  log_dir = str(tmp_path / 'runs')
  preemption.request()
  runner = ttrain.main([conf_path, '--device', 'cpu', '--log-dir', log_dir])
  assert runner.step == 4
  ckpt, = glob.glob(os.path.join(log_dir, '*', 'periodic-chkpt_*.ckpt'))
  preemption.reset()
  preemption.request()
  assert ttrain.main([conf_path, '--device', 'cpu', '--resume',
                      ckpt]).step == 8


@pytest.mark.parametrize('mode', ['reflect', 'replicate'])
@pytest.mark.parametrize('pads', [(1, 2, 1, 2), (0, 2, 1, 0), (2, 1, 0, 0)])
def test_pad_by_slices_equals_f_pad(mode, pads):
  """The model's reflect and replicate pad (``layers.pad``: F.pad, and a
  backward that folds the border back by slices): F.pad's values, and
  its gradient to float rounding, first and second order."""
  from csmri_refinement_tpu_torch.models.layers import pad
  gen = torch.Generator().manual_seed(sum(pads))
  x = torch.randn(2, 3, 5, 6, generator=gen, dtype=torch.float64,
                  requires_grad=True)
  want = torch.nn.functional.pad(x, pads, mode=mode)
  got = pad(x, pads, mode)
  assert torch.equal(got, want)
  weight = torch.randn(want.shape, generator=gen, dtype=torch.float64)
  grads = [torch.autograd.grad((y * weight).sum(), x, create_graph=True)[0]
           for y in (got, want)]
  torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-12)
  assert torch.autograd.gradcheck(lambda v: pad(v, pads, mode), (x,))
  assert torch.autograd.gradgradcheck(lambda v: pad(v, pads, mode), (x,))


def test_to_host_never_hands_numpy_a_bf16_tensor():
  tree = {'a': torch.ones(2, dtype=torch.bfloat16), 'b': [torch.ones(1)],
          'c': None}
  host = to_host(tree)
  assert host['a'].dtype == torch.float32 and host['a'].numpy().sum() == 2
  assert host['b'][0].dtype == torch.float32 and host['c'] is None
