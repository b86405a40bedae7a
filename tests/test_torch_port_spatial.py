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
  BN's synced statistics, add rounding); the noisy DC within 1e-5; the
  DC on K1's three passes (its output, input gradient and k0 gradient, on
  the radix route and on a dense-DFT one) and a chain of quantized layers
  bit for bit; the int8 U-Net within one int8 step (``INT8_STEP``). The
  DC's two all-to-alls send 2(S − 1)/S² of an image off each rank, and
  nothing else moves.
* The DC's plain passes (``dc_kernel``) against the composed ``dc_plain``
  and the 2D ``torch.fft`` formula, and the column pass's block rule.
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
* A validation of the int8 U-Net (``quantize_inference``) on two spatial
  ranks against the JAX package's one-device int8 forward of the same
  inputs and weights, at the int8 suite's bar (2e-2 of max |ref|,
  ``tests/test_torch_port_quant.py::test_unet_int8_matches_jax``), and
  against one process within one int8 step.
* Each spatial rank's batch holds its rows of ``inp`` and ``target`` and
  all rows of its column block of ``kspace`` and ``mask``.
* A spatial mesh raises on image rows that S does not divide, as JAX's
  ``shard_batch`` does, and splits those that a model's pools would split
  later (``tests/test_torch_port_uneven.py`` holds those runs).

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
# The int8 U-Net on the ranks' rows against the whole image: at most one
# int8 step of the output's range (max |Δ| ≤ max |ref| / 127) on at most
# INT8_SHARE of the elements. Its quantized layers alone are exact
# (``int8 chain``), but the CPU's plain float conv (oneDNN) picks its
# kernel by shape and rounds a halo tile's rows differently from the whole
# image's in the last bit; where that moves a value across an int8
# rounding tie, the next quantized layer differs by one step, and the
# layers after it spread the difference (measured: 2.5e-3 of max |ref| on
# up to 2.1% of the elements on 2 and 4 ranks).
INT8_STEP = 1 / 127
INT8_SHARE = 5e-2
JAX_INT8_ATOL = 2e-2     # tests/test_torch_port_quant.py: the int8 bar


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


def _jax_int8_unet(dirs):
  """The JAX int8 U-Net's forward (``child.int8_conf``'s model,
  initialised from PRNG key 0), its variables written as a port state
  dict to ``int8_init.pt`` in each of ``dirs``."""
  import jax
  from csmri_refinement_tpu.models import unet as junet
  from csmri_refinement_tpu_torch.models import construct_model
  from csmri_refinement_tpu_torch.utils.jax_weights import (
      load_flax_variables)
  section = child.int8_conf()['model']
  model = junet.UNET(**{k: v for k, v in section.items() if k != 'name'})
  size = child.INT8_SIZE
  variables = jax.jit(lambda key, x: model.init(key, x, train=False))(
      jax.random.PRNGKey(0), np.zeros((1, size, size, 2), np.float32))
  port = construct_model(dict(section))
  load_flax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
  for d in dirs:
    torch.save(port.state_dict(), os.path.join(d, 'int8_init.pt'))
  apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
  return lambda x: np.asarray(apply(variables, x))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """The JAX spatial run, the two spatial ranks', the four {2, 2} ranks'
  and the one-process runs, with the directories of their states; the JAX
  int8 U-Net's forward."""
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
  jax_int8 = _jax_int8_unet((dirs['two'], dirs['one']))
  port2, port4 = _free_port(), _free_port()
  procs = [_spawn(2, r, port2, dirs['two'],
                  SCENARIOS + JAX_SCENARIOS + ('units', 'validate_cli',
                                               'int8_validate'),
                  SPATIAL, epochs={name: 1 for name in JAX_SCENARIOS})
           for r in range(2)]
  procs += [_spawn(4, r, port4, dirs['four'], ('standard', 'units'),
                   {'data': 2, 'spatial': 2}, threads=1) for r in range(4)]
  procs.append(_spawn(1, 0, 0, dirs['one'], SCENARIOS + ('validate_cli',
                                                         'int8_validate')))
  results = _finish(procs, CHILD_TIMEOUT_S)
  return {'jax': jax_result, 'two': results[:2], 'four': results[2:6],
          'one': results[6], 'dirs': dirs, 'jax_int8': jax_int8}


@pytest.mark.parametrize('ranks', [2, 4])
@pytest.mark.parametrize('case', child.UNIT_CASES)
def test_spatial_layers_match_the_whole_image(runs, ranks, case):
  """Each rank's rows of the layer's output and gradients against the
  whole image's."""
  for rank_result in runs['two' if ranks == 2 else 'four']:
    out, grad_x, grad_params = rank_result['units'][case]
    if case in child.EXACT_CASES:
      assert (out, grad_x, grad_params) == (0.0, 0.0, 0.0), \
          '{} is not bit for bit'.format(case)
      continue
    if case == 'unet int8 eval':
      # grad_x: the share of elements that differ; grad_params: 0.0 when
      # some chain quantized
      assert out <= INT8_STEP and grad_x <= INT8_SHARE, (out, grad_x)
      assert grad_params == 0.0, 'no chain quantized'
      continue
    bar = CONV_ATOL if case.startswith(('same_conv', 'instance_norm')) \
        else NET_ATOL
    assert out <= bar and grad_x <= bar, (out, grad_x)
    assert grad_params <= NET_ATOL, grad_params


@pytest.mark.parametrize('ranks', [2, 4])
def test_distributed_dc_sends_two_all_to_alls(runs, ranks):
  """Per DC each rank sends 2(S − 1)/S² of an image (two all-to-alls of its
  1/S share, of which (S − 1)/S leaves the rank), and no row gather."""
  for rank_result in runs['two' if ranks == 2 else 'four']:
    for case, moved in rank_result['units']['dc_moved'].items():
      assert moved == {'all_to_all': 2 * (ranks - 1) / ranks ** 2}, (case,
                                                                      moved)


@pytest.mark.parametrize('world', [2, 4])
def test_spatial_ranks_hold_kspace_and_mask_columns(runs, world):
  """A rank's batch of 32² images: its 16 rows of ``inp`` and ``target``,
  all 32 rows of its 16 columns of ``kspace`` and ``mask`` (S = 2; the
  batch of 8 whole on one data rank, or split over the two of
  {"data": 2, "spatial": 2})."""
  batch = 8 if world == 2 else 4
  for rank_result in runs['two' if world == 2 else 'four']:
    shapes = rank_result['standard']['shapes']
    assert shapes['inp'] == [batch, 16, 32, 2]
    assert shapes['target'] == [batch, 16, 32, 2]
    assert shapes['kspace'] == [batch, 32, 16, 2]
    assert shapes['mask'] == [batch, 32, 16, 1]


def test_int8_validate_on_two_spatial_ranks_matches_jax(runs):
  """The int8 U-Net validated on two spatial ranks: the gathered
  predictions against the JAX package's one-device int8 forward of the
  same inputs, and against one process's."""
  got = [torch.load(os.path.join(runs['dirs']['two'],
                                 'int8_validate_rank{}.pt'.format(r)))
         for r in range(2)]
  one = torch.load(os.path.join(runs['dirs']['one'],
                                'int8_validate_rank0.pt'))
  assert torch.equal(got[0]['inp'], one['inp'])
  assert torch.equal(got[0]['pred'], got[1]['pred'])
  want = runs['jax_int8'](got[0]['inp'].numpy())
  pred = got[0]['pred'].numpy()
  assert pred.shape == want.shape
  scale = np.abs(want).max()
  assert np.abs(pred - want).max() <= JAX_INT8_ATOL * scale
  diff = (got[0]['pred'] - one['pred']).abs()
  ref = one['pred'].abs().max()
  assert diff.max() <= INT8_STEP * ref
  assert (diff > 1e-5 * ref).float().mean() <= INT8_SHARE
  r0, r1 = (ranks['int8_validate'] for ranks in runs['two'])
  assert r0 == r1 and set(r0) == {'psnr'}


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
  """Image rows must divide by S, as JAX's ``shard_batch`` (an uneven
  ``device_put``) has it; a model's downsampling factor does not matter
  (48 rows split into 24 a rank, which a U-Net's fourth pool splits)."""
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  mesh = mesh_lib.Mesh(2, 1, torch.device('cpu'), spatial=2)
  batch = {'inp': np.zeros((4, 64, 8, 2)), 'mask': np.zeros((4, 64, 8, 1)),
           'index': np.arange(4)}
  got = mesh_lib.split_image_rows(batch, mesh)
  assert got['inp'].shape == (4, 32, 8, 2)
  assert got['mask'].shape == (4, 64, 4, 1)        # the rank's columns
  np.testing.assert_array_equal(got['mask'], batch['mask'][:, :, 4:])
  assert got['index'].shape == (4,)
  inp = np.arange(4 * 48 * 8 * 2).reshape(4, 48, 8, 2)
  np.testing.assert_array_equal(
      mesh_lib.split_image_rows({'inp': inp}, mesh)['inp'], inp[:, 24:])
  with pytest.raises(ValueError, match='spatial=2'):
    mesh_lib.split_image_rows({'inp': np.zeros((4, 51, 8, 2))}, mesh)


def test_dc_passes_compose_the_plain_dc():
  """The plain passes: per-axis ``torch.fft``; on a block of rows or
  columns each gives that block of the whole image's pass bit for bit,
  their composition is ``dc_plain``, within float rounding of the 2D
  ``torch.fft`` formula, and the VJP is the passes on the gradient."""
  from csmri_refinement_tpu_torch.ops import dc_kernel, fft
  gen = torch.Generator().manual_seed(3)
  x, k0, g = (torch.randn(2, 24, 20, 2, generator=gen) for _ in range(3))
  mask = (torch.rand(2, 24, 20, 1, generator=gen) > 0.5).float()
  rows = dc_kernel.dc_rows_fft_plain(x)
  assert torch.equal(dc_kernel.dc_rows_fft_plain(x[:, 6:12]), rows[:, 6:12])
  cols = dc_kernel.dc_cols_plain(rows, k0, mask)
  block = lambda t: t[:, :, 5:10].contiguous()
  assert torch.equal(dc_kernel.dc_cols_plain(block(rows), block(k0),
                                             block(mask)), block(cols))
  y = dc_kernel.dc_rows_ifft_plain(cols)
  assert torch.equal(y, dc_kernel.dc_plain(x, k0, mask))
  want = fft.pack_complex(fft.ifft2(dc_kernel.kspace_merge_reference(
      fft.fft2(fft.unpack_complex(x)), fft.unpack_complex(k0),
      mask[..., 0])))
  torch.testing.assert_close(y, want, atol=1e-6, rtol=0)
  grad_x, grad_k0 = dc_kernel.dc_plain_vjp(g, mask)
  assert torch.equal(grad_x, dc_kernel.dc_rows_ifft_plain(
      dc_kernel.dc_cols_plain(dc_kernel.dc_rows_fft_plain(g), None, mask)))
  torch.testing.assert_close(grad_k0, fft.pack_complex(fft.fft2(
      fft.unpack_complex(g))), atol=1e-6, rtol=0)


@pytest.mark.parametrize('shape', [(2, 16, 16, 2), (1, 24, 20, 2)])
def test_dc_pass_wrappers_take_cuda_tensors_only(shape):
  from csmri_refinement_tpu_torch.ops import dc_kernel
  x = torch.zeros(shape)
  mask = torch.zeros(shape[:3] + (1,))
  for call in (lambda: dc_kernel.dc_rows_fft_cuda(x, shape[1]),
               lambda: dc_kernel.dc_cols_cuda(x, x, mask, shape[2]),
               lambda: dc_kernel.dc_rows_ifft_cuda(x, shape[1]),
               lambda: dc_kernel.dc_bwd_rows_fft_cuda(x, shape[1]),
               lambda: dc_kernel.dc_bwd_cols_cuda(x, mask, shape[2]),
               lambda: dc_kernel.dc_bwd_rows_ifft_cuda(x, shape[1])):
    with pytest.raises(ValueError, match='CUDA'):
      call()


def test_column_pass_block_rule():
  """The radix route's column pass takes a block that divides the width
  in whole 16-column strips at up to 512 rows (or one power-of-two strip
  below 16; 8-column strips above 512 rows,
  ``tests/test_torch_port_dc_large.py``); the
  dense route any block of 1 to W columns (its kernel walks partial
  strips), so uneven column blocks run there."""
  from csmri_refinement_tpu_torch.ops import dc_kernel
  check = dc_kernel.check_cols_block
  for w, width in ((16, 32), (32, 64), (8, 32), (2, 16), (256, 512)):
    check('pass', w, width, 'fft', 256)
  for w, width in ((24, 48), (12, 48), (6, 12)):
    with pytest.raises(ValueError, match='{} of the image'.format(w)):
      check('pass', w, width, 'fft', 256)
  for w, width in ((5, 20), (10, 20), (48, 192), (7, 20), (119, 237)):
    check('pass', w, width, 'dft', 20)
  for w in (0, 21):
    with pytest.raises(ValueError, match='{} of the image'.format(w)):
      check('pass', w, 20, 'dft', 20)


def test_distributed_dc_checks_the_layout():
  from csmri_refinement_tpu_torch.ops import dc_kernel
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  mesh = mesh_lib.Mesh(2, 0, torch.device('cpu'), spatial=2)
  with pytest.raises(ValueError, match='16 rows and 8 columns'):
    dc_kernel.dc_distributed(torch.zeros(1, 8, 16, 2),
                             torch.zeros(1, 16, 16, 2),
                             torch.zeros(1, 16, 16, 1), mesh)
  # 15 columns: rank 0's block is 8 (``mesh.col_bounds``), not 7
  with pytest.raises(ValueError, match='16 rows and 8 columns'):
    dc_kernel.dc_distributed(torch.zeros(1, 8, 15, 2),
                             torch.zeros(1, 16, 7, 2),
                             torch.zeros(1, 16, 7, 1), mesh)
