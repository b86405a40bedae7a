"""Mixed-precision and memory-mode training of the port's adversarial
runner against the JAX package: ``train_dtype``, ``train_remat`` and
``steps_per_fetch`` on the tiny GAN of ``tests/test_torch_port_gan.py``
(the bars of ``tests/test_torch_port_train_options.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.training import build_runner
from csmri_refinement_tpu_torch.utils.config import Configuration
from test_torch_port_gan import (_FixedPreparer, _batches, _conf_dict,
                                 _runners, _snapshot)
from test_torch_port_train_options import (ADAM_SPREAD, BF16_REL, LR,
                                           PARAMS_CLOSE,
                                           _assert_equal_states)

# The paper's discriminator drops out after its first layers (p = 0.5);
# the tiny GAN of the trajectory tests turns it off, these tests on.
DROPOUT_AFTER = [0, 1]


def _rel(got, want):
  want = np.asarray(want, np.float32)
  return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope='module')
def bf16_record():
  """One bf16 D-then-G update of the JAX runner and of the port's on the
  same weights and batch, then a validation batch on both."""
  conf_d = _conf_dict(train_dtype='bfloat16')
  (jb, tb), = _batches(1)
  jrunner, trunner, jstep = _runners(conf_d, jb)
  want = jstep(jb, True, True, 0)
  got = {k: v.item() for k, v in trunner.train_batch(tb)[0].items()}
  record = {'runners': (jrunner, trunner), 'losses': (got, want),
            'states': _snapshot(jrunner, trunner)}
  trunner.preparer = _FixedPreparer()
  record['val'] = (jrunner._val_step_fn(jrunner.gen_state,
                                        jrunner.disc_state, jb),
                   trunner._val_step({'prepared': tb}))
  return record


def test_bf16_networks_and_frozen_recnet(bf16_record):
  """``train_dtype`` reaches both models of the wrapper, the
  discriminator and the VGG19, as in JAX; the frozen RecNet stays in eval
  mode and in bf16 through the update."""
  jrunner, trunner = bf16_record['runners']
  for port, jax_net in ((trunner.gen.pretrained_model,
                         jrunner.gen.pretrained_model),
                        (trunner.gen.learnable_model,
                         jrunner.gen.learnable_model),
                        (trunner.disc, jrunner.disc)):
    assert port.dtype == torch.bfloat16 and jax_net.dtype == jnp.bfloat16
  assert trunner.gen_criteria['VGG19'].criterion.vgg.dtype == torch.bfloat16
  assert jrunner.gen_criteria['VGG19'].criterion.vgg.dtype == jnp.bfloat16
  assert not trunner.gen.pretrained_model.training


def test_bf16_update_losses_match_jax(bf16_record):
  """Every loss of the update within BF16_REL of JAX's (measured: the
  VGG19 loss 1.1e-2 relative, the others within 6e-4)."""
  got, want = bf16_record['losses']
  assert set(got) == set(want)
  for name, value in want.items():
    assert abs(got[name] - value) <= BF16_REL * abs(value), name


@pytest.mark.parametrize('net', ['gen', 'disc'])
def test_bf16_update_parameters_match_jax(bf16_record, net):
  """Every parameter and BN statistic, f32, within ADAM_SPREAD of JAX's
  after the update, nearly all within a tenth of lr (measured: 98.5% of
  the generator's, 96.7% of the discriminator's); Adam's moments f32."""
  got, want = bf16_record['states'][net]
  close = total = 0
  for name, value in got.items():
    if name.endswith('num_batches_tracked'):
      continue
    assert value.dtype == torch.float32, name
    diff = (value - want[name]).abs()
    assert diff.max().item() <= ADAM_SPREAD, name
    close += int((diff <= LR / 10).sum())
    total += diff.numel()
  assert close >= PARAMS_CLOSE * total
  trunner = bf16_record['runners'][1]
  optimizer = trunner.gen_optimizer if net == 'gen' else \
      trunner.disc_optimizer
  for entry in optimizer.state_dict()['state'].values():
    assert entry['exp_avg'].dtype == entry['exp_avg_sq'].dtype == \
        torch.float32


def test_bf16_pool_stays_f32(bf16_record):
  """The image pool holds f32 images (the generator's output is cast at
  the loss boundary), within BF16_REL of JAX's (measured 4.2e-3)."""
  got, count, want, want_count = bf16_record['states']['pool']
  assert got.dtype == torch.float32 and count == want_count
  assert _rel(got, want) <= BF16_REL


def test_bf16_validation_matches_jax_and_returns_f32(bf16_record):
  """The bf16 networks' validation: the generator's prediction and the
  discriminator's outputs cast to f32 (so the host fetch of TensorBoard's
  grid and the disc metrics never sees bf16), each within BF16_REL of
  JAX's (measured 4.2e-3 and 3.9e-3), the losses too (5.7e-3)."""
  (jout, jfake, jreal, jlosses), (tlosses, data) = bf16_record['val']
  _, tout, tfake, treal = data
  assert tout['pred'].dtype == tfake['prob'].dtype == treal['prob'].dtype \
      == torch.float32
  assert _rel(tout['pred'], jout['pred']) <= BF16_REL
  for got, want in ((tfake, jfake), (treal, jreal)):
    assert _rel(got['prob'], want['prob']) <= BF16_REL
  for name, value in jlosses.items():
    got = tlosses['gen_loss_' + name].value
    assert abs(got - float(value)) <= BF16_REL * abs(float(value)), name


def _train(conf_d, epochs=1):
  """A CPU adversarial runner of ``conf_d`` after ``epochs`` epochs on an
  unshuffled loader; returns (runner, [each fetch's (batches, losses,
  train metrics)])."""
  conf = Configuration.from_dict(conf_d)
  runner = build_runner(conf, 'adversarial', 'train', 'cpu')
  train_set = load_dataset(conf, None, 'Synthetic', 'train')
  fetches = []
  for epoch in range(1, epochs + 1):
    runner.epoch_beginning(epoch)
    it = iter(DataLoader(train_set, conf.batch_size, shuffle=False))
    while True:
      n, losses, data = runner._train_step(it)
      if n == 0:
        break
      metrics = runner._compute_train_metrics(data)
      fetches.append((n, {k: m.value for k, m in losses.items()},
                      {k: m.value for k, m in metrics.items()}))
  return runner, fetches


def _assert_runs_equal(got, want):
  for net in ('gen', 'disc'):
    _assert_equal_states(getattr(got, net).state_dict(),
                         getattr(want, net).state_dict())
  for opt in ('gen_optimizer', 'disc_optimizer'):
    for i, entry in getattr(want, opt).state_dict()['state'].items():
      _assert_equal_states(getattr(got, opt).state_dict()['state'][i], entry)
  assert torch.equal(got.pool.images, want.pool.images)
  assert got.pool.count == want.pool.count
  assert torch.equal(got.dropout_generator.get_state(),
                     want.dropout_generator.get_state())
  assert torch.equal(got.pool_generator.get_state(),
                     want.pool_generator.get_state())


@pytest.mark.parametrize('train_dtype', [None, 'bfloat16'])
def test_remat_gan_is_bit_equal_to_the_plain_run(train_dtype):
  """Two epochs of two D-then-G updates with ``train_remat`` (the
  generator forward, each discriminator apply and the VGG19's prediction
  branch recomputed in the backward), the discriminator dropping out after
  two layers: every loss, parameter, BN statistic, Adam state, pool image
  and generator state bit-equal to the plain run (JAX's bar is 1e-6,
  ``tests/test_adversarial.py:369``)."""
  conf_d = _conf_dict(train_dtype=train_dtype)
  conf_d['discriminator_model']['dropout_after'] = DROPOUT_AFTER
  want, want_fetches = _train(conf_d, epochs=2)
  got, got_fetches = _train(dict(conf_d, train_remat=True), epochs=2)
  assert got.train_remat and got.gen_criteria['VGG19'].criterion.remat
  assert got_fetches == want_fetches
  _assert_runs_equal(got, want)


@pytest.mark.parametrize('num_train,k,chunks', [(12, 2, [2, 1]),
                                               (10, 3, [2, 1])],
                         ids=['partial_chunk', 'ragged_batch'])
def test_steps_per_fetch_gan_equals_single_updates(num_train, k, chunks):
  """k full updates per fetch, batches of 4 (the last of 10 ragged, held
  back for its own fetch): each fetch's losses the mean of its single
  updates', no train metrics, and everything after the epoch bit-equal to
  single updates (JAX ``tests/test_adversarial.py:318-365``)."""
  synthetic = {'image_size': 32, 'num_train': num_train, 'num_val': 4}
  conf_d = _conf_dict(synthetic=synthetic)
  conf_d['discriminator_model']['dropout_after'] = DROPOUT_AFTER
  want, single = _train(conf_d)
  got, fetched = _train(dict(conf_d, steps_per_fetch=k))
  assert [n for n, _, _ in fetched] == chunks
  assert got._pending_host_batch is None and got.step == len(single)
  start = 0
  for n, losses, metrics in fetched:
    assert metrics == {}
    assert set(losses) == set(single[0][1])
    for name, value in losses.items():
      mean = np.mean(np.float32([single[i][1][name]
                                 for i in range(start, start + n)]))
      assert value == pytest.approx(float(mean), rel=1e-6), name
    start += n
  _assert_runs_equal(got, want)


def test_steps_per_fetch_waits_for_the_generator():
  """While discriminator pretraining disables the generator, each step is
  one update, as in JAX (``:540-548``)."""
  conf_d = _conf_dict(steps_per_fetch=2, pretrain_discriminator_epochs=1)
  runner, fetches = _train(conf_d)
  assert not runner.generator_enabled
  assert [n for n, _, _ in fetches] == [1, 1]
  assert set(fetches[0][1]) == {'disc_loss', 'disc_loss_gan'}
  assert all(metrics for _, _, metrics in fetches)


def test_bf16_validation_batch_reaches_numpy():
  """A bf16 run's validation returns its batches on the host in f32, so
  the CLI's grids and metrics take them as numpy arrays."""
  conf = Configuration.from_dict(_conf_dict(train_dtype='bfloat16'))
  runner = build_runner(conf, 'adversarial', 'train', 'cpu')
  val_set = load_dataset(conf, None, 'Synthetic', 'val')
  data, losses, metrics = runner.validate(DataLoader(val_set, 2),
                                          num_batches_to_return=1)
  named = runner.get_named_outputs(data[0])
  for key in ('input', 'prediction', 'target'):
    assert np.isfinite(np.asarray(named[key])).all(), key
  assert named['disc_fake']['prob'].dtype == torch.float32
  assert all(np.isfinite(m.value) for m in list(losses.values()) +
             list(metrics.values()))
