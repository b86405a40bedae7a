"""The port's data parallelism (``parallel/``) against one process and
against the JAX package, on the CPU.

* The loader's ``process_shard`` slices equal the JAX loader's, index for
  index (world 2 and 3; shuffled, ragged, ``drop_last``; the prefetch
  thread and the native batch path).
* ``mesh_from_conf`` and ``shard_batch`` on the JAX mesh configs.
* Two gloo ranks (``tests/_torch_dist_child.py``, spawned as in
  ``tests/test_distributed.py``) against one process on JAX's tiny
  configs, with JAX's bars (``tests/test_distributed.py:104-114``): the
  ranks within 1e-6 of each other, two ranks against one within 2e-5
  (standard) or 1e-4 (adversarial), rtol 1e-4. The standard runner, the
  adversarial runner with the image pool and dropout, a BN U-Net
  (segmentation, its running statistics included; also with
  ``train_remat``, whose recompute runs the synced statistics again) and
  ``steps_per_fetch: 2``.
* The two-rank standard run against the JAX package's one-process run on
  its 8-device mesh (``_run_world(1, 'standard')``'s config), from JAX's
  initial weights and masks, within 2e-5.
* The synced ``BatchNorm2d`` at world 2 against flax's ``BatchNorm`` on the
  global batch: output, gradients and running statistics within 1e-6.
* The training CLI on two ranks: only rank 0 writes.

Every child has its own 120 s timeout and is killed on expiry.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.data.loader import DataLoader as JDataLoader
from csmri_refinement_tpu_torch.data.loader import DataLoader
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
from csmri_refinement_tpu_torch.utils.config import Configuration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, 'tests', '_torch_dist_child.py')
sys.path.insert(0, os.path.join(REPO, 'tests'))
import _torch_dist_child as child  # noqa: E402

CHILD_TIMEOUT_S = 120
TRAIN_SCENARIOS = ('standard', 'adversarial', 'segmentation',
                   'segmentation_remat', 'standard_spf2')
# JAX's bars (tests/test_distributed.py): f32 reduction order only.
RANKS_ATOL = 1e-6
WORLD_ATOL = {'standard': 2e-5, 'standard_spf2': 2e-5, 'segmentation': 2e-5,
              'segmentation_remat': 2e-5, 'adversarial': 1e-4}


def _free_port():
  s = socket.socket()
  s.bind(('127.0.0.1', 0))
  port = s.getsockname()[1]
  s.close()
  return port


# -- the loader's process shard ----------------------------------------------

class _Items:
  def __init__(self, n):
    self.n = n

  def __len__(self):
    return self.n

  def __getitem__(self, i):
    return {'x': np.full((2,), i, np.float32)}


class _NativeItems(_Items):
  """A dataset whose batches come from ``native_batch`` (the host
  library's path), as the index list it was given."""

  def native_batch(self, chunk):
    return {'x': np.repeat(np.asarray(chunk, np.float32)[:, None], 2, 1)}


def _indices(loader):
  return [b['x'][:, 0].astype(int).tolist() for b in loader]


@pytest.mark.parametrize('world', [2, 3])
@pytest.mark.parametrize('n, batch, shuffle, drop_last', [
    (12, 6, True, False),       # even
    (10, 6, True, False),       # ragged, shrinks to a multiple of world
    (13, 6, False, False),      # ragged below world: dropped
    (14, 6, True, True),        # drop_last
])
def test_loader_process_shard_matches_jax(world, n, batch, shuffle,
                                          drop_last):
  for rank in range(world):
    kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last,
              process_shard=(rank, world))
    want = JDataLoader(_Items(n), batch, **kw)
    want_indices = _indices(want)       # one epoch of a fresh loader each
    for prefetch in (1, 2):
      got = DataLoader(_Items(n), batch, prefetch=prefetch, **kw)
      assert len(got) == len(want) == len(want_indices)
      assert _indices(got) == want_indices
    assert _indices(DataLoader(_NativeItems(n), batch, **kw)) == want_indices


def test_loader_process_shard_concatenates_to_the_global_batch():
  full = _indices(DataLoader(_Items(12), 6, shuffle=True, seed=3))
  ranks = [_indices(DataLoader(_Items(12), 6, shuffle=True, seed=3,
                               process_shard=(r, 3))) for r in range(3)]
  assert [sum(parts, []) for parts in zip(*ranks)] == full
  with pytest.raises(ValueError, match='divide'):
    DataLoader(_Items(12), 5, process_shard=(0, 2))


# -- the mesh ----------------------------------------------------------------

def _conf(**kw):
  return Configuration.from_dict(kw)


def test_mesh_from_conf():
  assert mesh_lib.mesh_from_conf(_conf(), 'cpu') is None
  for section in ({'data': -1}, {'data': 1}):
    mesh = mesh_lib.mesh_from_conf(_conf(mesh=section), 'cpu')
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
  with pytest.raises(ValueError, match='torchrun'):
    mesh_lib.mesh_from_conf(_conf(mesh={'data': 2}), 'cpu')
  # a spatial mesh needs data × spatial processes
  with pytest.raises(ValueError, match='spatial=2 does not divide'):
    mesh_lib.mesh_from_conf(_conf(mesh={'data': -1, 'spatial': 2}), 'cpu')
  with pytest.raises(ValueError, match='needs 4 processes'):
    mesh_lib.mesh_from_conf(_conf(mesh={'data': 2, 'spatial': 2}), 'cpu')
  mesh = mesh_lib.mesh_from_conf(_conf(mesh={'data': 1, 'spatial': 1}),
                                 'cpu')
  assert (mesh.data, mesh.spatial, mesh.shard) == (1, 1, (0, 1))
  # image rows that do not divide by spatial raise, as JAX's shard_batch
  # does; 24 rows split into 12 a rank, which a third pool would split
  mesh = mesh_lib.Mesh(4, 3, torch.device('cpu'), spatial=2)
  assert (mesh.d, mesh.s, mesh.shard) == (1, 1, (1, 2))
  assert mesh.image_rows(32) == slice(16, 32)
  assert mesh.image_rows(24) == slice(12, 24)
  with pytest.raises(ValueError, match='spatial=2: an image of 25 rows'):
    mesh.image_rows(25)
  assert not mesh_lib.multiprocess()


def test_shard_batch_takes_the_rank_rows_and_requires_divisible_batch():
  mesh = mesh_lib.Mesh(2, 1, torch.device('cpu'))
  batch = {'inp': np.arange(8)[:, None], 'scalar': np.float32(3)}
  got = mesh_lib.shard_batch(batch, mesh)
  np.testing.assert_array_equal(got['inp'][:, 0], [4, 5, 6, 7])
  assert got['scalar'] == 3
  stacked = mesh_lib.shard_stacked_batch({'inp': np.zeros((3, 8, 2))}, mesh)
  assert stacked['inp'].shape == (3, 4, 2)
  with pytest.raises(ValueError, match='divide'):
    mesh_lib.shard_batch({'inp': np.zeros((6, 8, 8, 2))},
                         mesh_lib.Mesh(4, 0, torch.device('cpu')))
  assert mesh_lib.gather_to_replicated(batch, mesh) is batch   # no group


# -- the runs ----------------------------------------------------------------

def _jax_standard_run(out_dir, mesh=None, epochs=2, scenario='standard_jax'):
  """JAX's one-process run of ``_run_world(1, 'standard')`` (or of the
  child's ``scenario``'s config) on its 8-device CPU mesh (``mesh``
  replacing the config's section), recording its initial and final weights
  (as port state dicts) and its train and validation masks for the
  ``scenario`` replay (files ``child.jax_prefix(scenario)`` + ``.npz``,
  ``_init.pt``, ``_final.pt``)."""
  from csmri_refinement_tpu.data import load_dataset as jload_dataset
  from csmri_refinement_tpu.training import build_runner as jbuild_runner
  from csmri_refinement_tpu.utils.config import Configuration as JConf
  from csmri_refinement_tpu_torch.models import construct_model
  from csmri_refinement_tpu_torch.utils.jax_weights import (
      load_flax_variables)

  conf_d = child._conf_dict(scenario, REPO)
  prefix = os.path.join(out_dir, child.jax_prefix(scenario))
  if mesh is not None:
    conf_d['mesh'] = mesh
  conf = JConf.from_dict(conf_d)
  runner = jbuild_runner(conf, 'standard', 'train')
  train_masks, val_masks, init = [], {}, []
  prepare_train, prepare_val = (runner.preparer.prepare_train,
                                runner.preparer.prepare_val)
  step_fn = runner._train_step_fn

  def record_train(rng, host_batch):
    batch = prepare_train(rng, host_batch)
    train_masks.append(np.asarray(batch['mask'])[..., 0])
    return batch

  def record_val(host_batch):
    batch = prepare_val(host_batch)
    for i, m in zip(host_batch['index'], np.asarray(batch['mask'])):
      val_masks[int(i)] = m[..., 0]
    return batch

  def first_state(state, *args):
    if not init:
      init.append(jax.tree_util.tree_map(np.asarray, state['params']))
    return step_fn(state, *args)

  runner.preparer.prepare_train = record_train
  runner.preparer.prepare_val = record_val
  runner._train_step_fn = first_state
  loader = JDataLoader(jload_dataset(conf, '/tmp', 'Synthetic', 'train'),
                       conf.batch_size, shuffle=True, seed=conf.seed)
  result = {'train': []}
  for epoch in range(1, epochs + 1):
    runner.epoch_beginning(epoch)
    losses, _ = runner.train_epoch(loader, epoch,
                                   steps_per_train_summary=10 ** 6)
    runner.epoch_finished(epoch)
    result['train'].append({k: float(m.value) for k, m in losses.items()})
  val_loader = JDataLoader(jload_dataset(conf, '/tmp', 'Synthetic', 'val'),
                           conf.batch_size)
  _, val_losses, val_metrics = runner.validate(val_loader)
  result['val'] = {k: float(m.value)
                   for k, m in {**val_losses, **val_metrics}.items()}

  model = construct_model(dict(conf_d['model'],
                               undersampling=conf_d['undersampling']))
  load_flax_variables(model, {'params': init[0]})
  torch.save(model.state_dict(), prefix + '_init.pt')
  load_flax_variables(model, {'params': jax.tree_util.tree_map(
      np.asarray, runner.state['params'])})
  torch.save(model.state_dict(), prefix + '_final.pt')
  np.savez(prefix + '.npz',
           train=np.stack(train_masks).astype(np.float32),
           val=np.stack([val_masks[i] for i in range(len(val_masks))])
           .astype(np.float32))
  return result


def _spawn(world, rank, port, out_dir, scenarios, mesh=None, threads=2,
           epochs=None):
  cfg = {'repo': REPO, 'world': world, 'rank': rank, 'port': port,
         'out': out_dir, 'scenarios': list(scenarios), 'threads': threads,
         'mesh': mesh, 'epochs': epochs or {}}
  env = dict(os.environ, OMP_NUM_THREADS=str(threads))
  return subprocess.Popen([sys.executable, CHILD, json.dumps(cfg)], env=env,
                          cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)


def _results(proc, timeout):
  try:
    out, _ = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    proc.kill()
    proc.communicate()
    raise
  assert proc.returncode == 0, out[-4000:]
  results = {}
  for line in out.splitlines():
    if line.startswith('DISTRESULT '):
      _, name, payload = line.split(' ', 2)
      results[name] = json.loads(payload)
  return results


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """{'jax': JAX's run, 'one': the 1-process port run, 'ranks': [rank 0's,
  rank 1's]} by scenario, and the directories of their state dicts."""
  two = str(tmp_path_factory.mktemp('two_ranks'))
  one = str(tmp_path_factory.mktemp('one_process'))
  jax_result = _jax_standard_run(two)
  port = _free_port()
  procs = [_spawn(2, r, port, two, TRAIN_SCENARIOS + ('standard_jax', 'bn',
                                                      'cli'))
           for r in range(2)]
  single = _spawn(1, 0, 0, one, TRAIN_SCENARIOS)
  try:
    ranks = [_results(p, CHILD_TIMEOUT_S) for p in procs]
    one_result = _results(single, CHILD_TIMEOUT_S)
  finally:
    for p in procs + [single]:
      if p.poll() is None:
        p.kill()
        p.communicate()
  return {'jax': jax_result, 'one': one_result, 'ranks': ranks,
          'two_dir': two, 'one_dir': one}


def _assert_results_close(a, b, atol):
  assert len(a['train']) == len(b['train'])
  for ea, eb in zip(a['train'], b['train']):
    assert set(ea) == set(eb)
    for name in ea:
      np.testing.assert_allclose(ea[name], eb[name], atol=atol, rtol=1e-4,
                                 err_msg='train loss {}'.format(name))
  assert set(a['val']) == set(b['val'])
  for name in a['val']:
    np.testing.assert_allclose(a['val'][name], b['val'][name], atol=atol,
                               rtol=1e-4, err_msg='val {}'.format(name))


def _states(directory, name, rank):
  return torch.load(os.path.join(directory, '{}_rank{}.pt'.format(name,
                                                                  rank)))


def _assert_states_close(a, b, atol, keys=None):
  for net in a:
    for key, value in a[net].items():
      if keys is not None and not any(k in key for k in keys):
        continue
      np.testing.assert_allclose(value.double().numpy(),
                                 b[net][key].double().numpy(), atol=atol,
                                 rtol=1e-4, err_msg='{}.{}'.format(net, key))


@pytest.mark.parametrize('scenario', TRAIN_SCENARIOS)
def test_two_ranks_match_one_process(runs, scenario):
  r0, r1 = (ranks[scenario] for ranks in runs['ranks'])
  _assert_results_close(r0, r1, RANKS_ATOL)
  _assert_results_close(runs['one'][scenario], r0, WORLD_ATOL[scenario])
  s0, s1 = (_states(runs['two_dir'], scenario, r) for r in (0, 1))
  _assert_states_close(s0['final'], s1['final'], RANKS_ATOL)
  if scenario.startswith('segmentation'):
    # The synced BN statistics of the first update. Later ones follow the
    # weights, where Adam turns f32 reduction-order noise in a near-zero
    # gradient into a step of up to lr (tests/test_torch_port_train.py):
    # after the run one running mean of 32 parts by 2.6e-5.
    one = _states(runs['one_dir'], scenario, 0)['first_update']
    _assert_states_close(one, s0['first_update'], WORLD_ATOL[scenario],
                         keys=('running_',))


def test_two_rank_standard_run_matches_jax(runs):
  r0, r1 = (ranks['standard_jax'] for ranks in runs['ranks'])
  _assert_results_close(r0, r1, RANKS_ATOL)
  _assert_results_close(runs['jax'], r0, 2e-5)


def test_synced_batchnorm_matches_flax_on_the_global_batch(runs):
  """Each rank ran ``BatchNorm2d`` on its half of ``child.bn_inputs()``
  with the cotangent ``c``; flax's ``BatchNorm`` on the whole batch."""
  import flax.linen as nn
  x, c, scale, bias = child.bn_inputs()
  bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
  variables = {'params': {'scale': jnp.asarray(scale),
                          'bias': jnp.asarray(bias)},
               'batch_stats': {'mean': jnp.zeros(scale.shape),
                               'var': jnp.ones(scale.shape)}}
  nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))

  def loss(params, xin):
    y, upd = bn.apply({'params': params,
                       'batch_stats': variables['batch_stats']}, xin,
                      mutable=['batch_stats'])
    return jnp.sum(y * nhwc(c)), (y, upd['batch_stats'])

  (_, (y, stats)), (gp, gx) = jax.value_and_grad(
      loss, argnums=(0, 1), has_aux=True)(variables['params'], nhwc(x))
  got = [torch.load(os.path.join(runs['two_dir'],
                                 'bn_rank{}.pt'.format(r))) for r in (0, 1)]
  to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
  close = lambda g, w: np.testing.assert_allclose(np.asarray(g), w,
                                                  atol=1e-6, rtol=1e-6)
  close(np.concatenate([g['y'] for g in got]), to_nchw(y))
  close(np.concatenate([g['grad_x'] for g in got]), to_nchw(gx))
  for g in got:
    close(g['grad_weight'], gp['scale'])
    close(g['grad_bias'], gp['bias'])
    close(g['running_mean'], stats['mean'])
    close(g['running_var'], stats['var'])


def test_cli_on_two_ranks_writes_from_rank_zero_only(runs):
  r0, r1 = (ranks['cli'] for ranks in runs['ranks'])
  assert r0['files'] and not r1['files']
  assert any(f.endswith('.ckpt') for f in r0['files'])
  assert r0['val'] == r1['val']
