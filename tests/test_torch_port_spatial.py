"""The port's spatial mesh axis (image rows sharded over processes) against
one process and against the JAX package, on the CPU.

* The spatial layers on the rank's rows against the whole image
  (``tests/_torch_dist_child.py::run_units``), at S = 2 (two gloo ranks)
  and S = 4 (four): ``same_conv`` (zero, reflection, replication; k3, k4;
  stride 1, 2: the halo rows and their backward) with its output and input
  gradient within 1e-6 of max |ref| and its parameter gradients (summed
  over the ranks) within 1e-5; instance norm likewise; the U-Nets (train
  mode with BN over the group, eval mode through the conv chain on halo
  tiles; subpixel, pixelshuffle and transposed k4 up-convs), the
  discriminator (PatchGAN, FC and average heads on gathered rows), VGG19
  and the refinement wrapper's min/max scale within 1e-5 (many layers, and
  BN's synced statistics, add rounding); the DC and its gradient bit for
  bit.
* Two gloo ranks under ``{"data": -1, "spatial": 2}`` against one process
  on JAX's tiny configs, at the JAX suite's spatial bars
  (``tests/test_parallel.py:199-310``), rtol 1e-5: the standard RecNet
  run (losses 1e-5, parameters 5e-5, PSNR 1e-3 dB), ``steps_per_fetch: 2``
  (parameters 1e-4), the GAN step with its pool and dropout (losses 1e-4,
  generator 5e-5, discriminator 5e-4, BN statistics 5e-5) and a 2-scale
  segmentation U-Net (as standard); the ranks within 1e-6 of each other.
* Four gloo ranks under ``{"data": 2, "spatial": 2}``: the standard run.
* The two-rank standard run against the JAX package's 8-device ``{"data":
  4, "spatial": 2}`` run from JAX's initial weights and masks, one epoch as
  there, at ``tests/test_parallel.py:216-222``'s bars; the same for the
  standard config with an ``nn-biresize-conv`` U-Net
  (``_torch_dist_child.py::UNET_RECONSTRUCTION``) in RecNet's place.
* The validate CLI on two spatial ranks (``-i``): the metrics of one
  process within 1e-5 (PSNR 1e-3 dB), the same PNGs written by rank 0
  only.
* A spatial mesh raises on image rows that do not divide.

Every child has its own timeout and is killed on expiry.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tests'))
import _torch_dist_child as child  # noqa: E402
from test_torch_port_parallel import (  # noqa: E402
    _free_port, _jax_standard_run, _results, _spawn, _states)

CHILD_TIMEOUT_S = 180
SPATIAL = {'data': -1, 'spatial': 2}
SCENARIOS = ('standard', 'standard_spf2', 'adversarial', 'segmentation2')
JAX_SCENARIOS = ('standard_jax', 'unet_jax')
RANKS_ATOL = 1e-6
# (losses and validation, parameters) per scenario; the GAN's parameter bar
# is the generator's, the discriminator's is DISC_ATOL.
BARS = {'standard': (1e-5, 5e-5), 'standard_spf2': (1e-5, 1e-4),
        'segmentation2': (1e-5, 5e-5), 'adversarial': (1e-4, 5e-5)}
DISC_ATOL = 5e-4
BN_ATOL = 5e-5
PSNR_ATOL = 1e-3
CONV_ATOL = 1e-6
NET_ATOL = 1e-5


def _close(a, b, atol, what):
  np.testing.assert_allclose(np.asarray(a, np.float64),
                             np.asarray(b, np.float64), atol=atol, rtol=1e-5,
                             err_msg=what)


def _assert_run_close(got, want, atol):
  """Losses and validation values within ``atol`` (PSNR within 1e-3 dB)."""
  assert len(got['train']) == len(want['train'])
  for g, w in zip(got['train'], want['train']):
    assert set(g) == set(w)
    for name in w:
      _close(g[name], w[name], atol, 'train ' + name)
  assert set(got['val']) == set(want['val'])
  for name in want['val']:
    _close(got['val'][name], want['val'][name],
           PSNR_ATOL if 'psnr' in name else atol, 'val ' + name)


def _assert_state_close(got, want, atol, keys=None, skip=()):
  for key, value in want.items():
    if key in skip or keys is not None and not any(k in key for k in keys):
      continue
    if value.is_floating_point():
      _close(got[key].double().numpy(), value.double().numpy(), atol, key)


def _finish(procs, timeout):
  try:
    return [_results(p, timeout) for p in procs]
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """The JAX spatial run, the two spatial ranks', the four {2, 2} ranks'
  and the one-process runs, with the directories of their states."""
  from csmri_refinement_tpu.ops import dc as jax_dc
  dirs = {k: str(tmp_path_factory.mktemp(k))
          for k in ('two', 'four', 'one')}
  try:
    jax_result = {name: _jax_standard_run(dirs['two'], {'data': 4,
                                                        'spatial': 2},
                                          epochs=1, scenario=name)
                  for name in JAX_SCENARIOS}
  finally:
    jax_dc.set_spatial_mesh(False)
  port2, port4 = _free_port(), _free_port()
  procs = [_spawn(2, r, port2, dirs['two'],
                  SCENARIOS + JAX_SCENARIOS + ('units', 'validate_cli'),
                  SPATIAL, epochs={name: 1 for name in JAX_SCENARIOS})
           for r in range(2)]
  procs += [_spawn(4, r, port4, dirs['four'], ('standard', 'units'),
                   {'data': 2, 'spatial': 2}, threads=1) for r in range(4)]
  procs.append(_spawn(1, 0, 0, dirs['one'], SCENARIOS + ('validate_cli',)))
  results = _finish(procs, CHILD_TIMEOUT_S)
  return {'jax': jax_result, 'two': results[:2], 'four': results[2:6],
          'one': results[6], 'dirs': dirs}


@pytest.mark.parametrize('ranks', [2, 4])
@pytest.mark.parametrize('case', child.UNIT_CASES)
def test_spatial_layers_match_the_whole_image(runs, ranks, case):
  """Each rank's rows of the layer's output and gradients against the
  whole image's."""
  for rank_result in runs['two' if ranks == 2 else 'four']:
    out, grad_x, grad_params = rank_result['units'][case]
    if case == 'dc':
      assert (out, grad_x) == (0.0, 0.0), 'the DC is not bit for bit'
      continue
    bar = CONV_ATOL if case.startswith(('same_conv', 'instance_norm')) \
        else NET_ATOL
    assert out <= bar and grad_x <= bar, (out, grad_x)
    assert grad_params <= NET_ATOL, grad_params


@pytest.mark.parametrize('scenario', SCENARIOS)
def test_two_spatial_ranks_match_one_process(runs, scenario):
  r0, r1 = (ranks[scenario] for ranks in runs['two'])
  _assert_run_close(r1, r0, RANKS_ATOL)
  loss_atol, param_atol = BARS[scenario]
  _assert_run_close(r0, runs['one'][scenario], loss_atol)
  states = [_states(runs['dirs']['two'], scenario, r) for r in (0, 1)]
  one = _states(runs['dirs']['one'], scenario, 0)
  for net, want in one['final'].items():
    _assert_state_close(states[1]['final'][net], states[0]['final'][net],
                        RANKS_ATOL)
    if net == 'discriminator':
      _assert_state_close(states[0]['final'][net], want, DISC_ATOL,
                          skip=[k for k in want if 'running_' in k])
      _assert_state_close(states[0]['final'][net], want, BN_ATOL,
                          keys=('running_',))
    else:
      _assert_state_close(states[0]['final'][net], want, param_atol)


def test_four_ranks_data_and_spatial_match_one_process(runs):
  results = [ranks['standard'] for ranks in runs['four']]
  for r in results[1:]:
    _assert_run_close(r, results[0], RANKS_ATOL)
  _assert_run_close(results[0], runs['one']['standard'], 1e-5)
  one = _states(runs['dirs']['one'], 'standard', 0)['final']['model']
  for r in range(4):
    _assert_state_close(_states(runs['dirs']['four'], 'standard',
                                r)['final']['model'], one, 5e-5)


def _assert_matches_jax(runs, scenario):
  r0, r1 = (ranks[scenario] for ranks in runs['two'])
  _assert_run_close(r1, r0, RANKS_ATOL)
  _assert_run_close(r0, runs['jax'][scenario], 1e-5)
  want = torch.load(os.path.join(runs['dirs']['two'], '{}_final.pt'.format(
      child.jax_prefix(scenario))))
  _assert_state_close(_states(runs['dirs']['two'], scenario,
                              0)['final']['model'], want, 5e-5)


def test_two_spatial_ranks_match_jax_data_and_spatial_mesh(runs):
  _assert_matches_jax(runs, 'standard_jax')


def test_two_spatial_ranks_match_jax_with_a_biresize_unet(runs):
  """The bilinear up-sample's halo rows and the resize conv's on two ranks
  against JAX's GSPMD run of the same U-Net."""
  _assert_matches_jax(runs, 'unet_jax')


def test_validate_cli_on_two_spatial_ranks_writes_from_rank_zero(runs):
  r0, r1 = (ranks['validate_cli'] for ranks in runs['two'])
  one = runs['one']['validate_cli']
  assert r0['files'] == one['files'] and len(one['files']) == 8
  assert not r1['files']
  for name, want in one['metrics'].items():
    for got in (r0, r1):
      _close(got['metrics'][name], want,
             PSNR_ATOL if 'psnr' in name else 1e-5, name)


def test_spatial_rows_must_divide():
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  mesh = mesh_lib.Mesh(2, 1, torch.device('cpu'), spatial=2, row_factor=16)
  batch = {'inp': np.zeros((4, 64, 8, 2)), 'mask': np.zeros((4, 64, 8, 1)),
           'index': np.arange(4)}
  got = mesh_lib.split_image_rows(batch, mesh)
  assert got['inp'].shape == (4, 32, 8, 2)
  assert got['mask'].shape == (4, 64, 8, 1)        # whole on every rank
  assert got['index'].shape == (4,)
  with pytest.raises(ValueError, match='spatial=2'):
    mesh_lib.split_image_rows({'inp': np.zeros((4, 48, 8, 2))}, mesh)
