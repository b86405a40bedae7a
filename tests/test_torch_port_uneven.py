"""The port's spatial mesh on maps whose rows a stride or a pool splits,
against one process and against the JAX package, on the CPU.

JAX's GSPMD shards an image's rows only where S divides them
(``csmri_refinement_tpu/parallel/mesh.py::shard_batch`` raises otherwise)
and reshards inside a network wherever a stride or a pool splits a
device's rows. The port hands such maps on in unequal row blocks
(``parallel/halo.py::Rows``): a stride-2 window's output row o belongs to
the rank holding input row 2·o, and a window that starts off a rank's
rows or reaches past its neighbour is fetched from its owners
(``halo.fetch``).

* The layers on ranks of 9 rows each (``tests/_torch_uneven_child.py``),
  at S = 2 (two gloo ranks) and S = 4 (four): ``same_conv`` at strides 1
  and 2 in every pad mode, ``max_pool2`` and instance norm with outputs
  and input gradients within 1e-6 of max |ref|; 3-scale U-Nets in every
  up-sampling mode (train mode with BN over the group, eval mode through
  the conv chain's plain version on halo tiles), the discriminator
  (PatchGAN, FC and average heads on gathered rows) and VGG19 down to a
  block one rank holds alone, within 4e-6 (BN's all-reduced statistics and
  the convs on halo tiles round otherwise than one process: up to 1.9e-6
  here). Every parameter's gradient within 1e-5 of its own max |ref|; a
  norm layer's scale, whose gradient Σ g·x̂ cancels terms as large as the
  case's largest gradients, gets 1e-6 of that largest on top (its
  rounding). The VGG19 loss and feature matching on such maps: the mean
  of the ranks' losses and its input gradients at the nets' bar. The DC
  on a width that S does not divide (column blocks of 8 and 7, or 4, 4, 4
  and 3) bit for bit against one process, within 1e-6 of the 2D
  ``torch.fft`` formula; the noisy DC bit for bit too. A chain of quantized layers on unequal blocks bit for bit;
  the int8 U-Net whose pool splits 17 rows within one int8 step.
* What moves: each fetch of a U-Net's train step receives exactly the rows
  its window lacks, and every ``all_gather`` is a halo's edge rows (no
  whole map is gathered).
* Two gloo ranks under ``{"data": -1, "spatial": 2}`` against one process:
  the GAN step (``_adversarial_conf``'s widths, pool and dropout) at 36²,
  whose discriminator strides and VGG19 pools split the ranks' rows, at
  the JAX suite's spatial bars (``tests/test_parallel.py:272-308``), the
  same GAN on 36 × 35 images (k-space and mask in column blocks of 18 and
  17, through validation and the metrics' gather, whose batch equals one
  process's bit for bit), and a 2-scale segmentation run at 34² (17 rows
  a rank).
* The two-rank GAN step at 36² against the JAX package's 8-device
  ``{"data": 4, "spatial": 2}`` run of ``_adv_conf`` (its initial
  weights, VGG19 and masks bridged into the port), at the same bars.
* A spatial mesh refuses image rows that S does not divide, as JAX does,
  and takes any width.

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
import _torch_uneven_child as uneven  # noqa: E402
from test_torch_port_parallel import (  # noqa: E402
    _free_port, _spawn, _states)
from test_torch_port_spatial import _close, _finish  # noqa: E402

CHILD_TIMEOUT_S = 150
SPATIAL = {'data': -1, 'spatial': 2}
SCENARIOS = ('adversarial36', 'adversarial36x35', 'segmentation2_34')
JAX_SCENARIO = 'adversarial_jax36'
RANKS_ATOL = 1e-6
LAYER_ATOL = 1e-6
NET_ATOL = 4e-6
# a parameter's gradient: of its own max |ref|; a norm scale's, in addition,
# of the case's largest gradient
PARAM_RTOL, SCALE_ATOL = 1e-5, 1e-6
# the JAX suite's spatial GAN bars (test_parallel.py:292-306): losses,
# generator, discriminator (2·lr and slack for near-zero gradients whose
# sign the summation order flips), BN statistics
GAN_LOSS_ATOL, GEN_ATOL, DISC_ATOL, BN_ATOL = 1e-4, 5e-5, 5e-4, 5e-5
# segmentation: ``chip_smoke.py``'s ``SPATIAL_BARS``: a BN network's first
# Adam step moves a weight whose near-zero gradient the ranks' summation
# order flips by 2·lr = 4e-4 (one weight at 34² does)
SEG_LOSS_ATOL, SEG_PARAM_ATOL = 1e-5, 5e-4
# PSNR in dB; dice, a count of pixels on either side of an argmax
# (``chip_smoke.py``'s ``SPATIAL_METRIC_ATOL``)
METRIC_ATOL = 1e-3
INT8_STEP, INT8_SHARE = 1 / 127, 5e-2
LAYERS = ('same_conv', 'max_pool2', 'instance_norm')


def _jax_gan_run(out_dir):
  """JAX's 8-device ``{"data": 4, "spatial": 2}`` run of
  ``adversarial_jax36``: one update of 8 images at 36². Writes its initial
  generator, discriminator and VGG19 weights as port state dicts
  (``<prefix>_init.pt``), its train masks (``<prefix>.npz``) and its final
  networks (``<prefix>_final.pt``); returns its losses."""
  import jax
  from csmri_refinement_tpu.data import load_dataset as jload_dataset
  from csmri_refinement_tpu.data.loader import DataLoader as JDataLoader
  from csmri_refinement_tpu.ops import dc as jax_dc
  from csmri_refinement_tpu.training import build_runner as jbuild_runner
  from csmri_refinement_tpu.utils.config import Configuration as JConf
  from csmri_refinement_tpu_torch.training.adversarial_runner import (
      AdversarialRunner)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  from csmri_refinement_tpu_torch.utils.jax_weights import (
      load_flax_variables)
  np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  conf_d = child._conf_dict(JAX_SCENARIO, REPO)
  conf = JConf.from_dict(dict(conf_d, mesh={'data': 4, 'spatial': 2}))
  jax_dc.set_spatial_mesh(True)
  try:
    runner = jbuild_runner(conf, 'adversarial', 'train')
    masks, init = [], {}
    prepare_train, get_step = (runner.preparer.prepare_train,
                               runner._get_step_fn)

    def record(rng, host_batch):
      batch = prepare_train(rng, host_batch)
      masks.append(np.asarray(batch['mask'])[..., 0])
      return batch

    def first_states(*args):
      step = get_step(*args)

      def run(gen_state, disc_state, *rest):
        if not init:
          init.update(gen=np_tree(gen_state), disc=np_tree(disc_state))
        return step(gen_state, disc_state, *rest)
      return run
    runner.preparer.prepare_train = record
    runner._get_step_fn = first_states
    loader = JDataLoader(jload_dataset(conf, '/tmp', 'Synthetic', 'train'),
                         conf.batch_size, shuffle=True, seed=conf.seed)
    losses, _ = runner.train_epoch(loader, 1, steps_per_train_summary=10 ** 6)
  finally:
    jax_dc.set_spatial_mesh(False)
  port = AdversarialRunner(Configuration.from_dict(conf_d), 'train', 'cpu')
  vgg = port.gen_criteria['VGG19'].criterion.vgg

  def states(gen, disc):
    for module, state in ((port.gen, gen), (port.disc, disc)):
      load_flax_variables(module, {'params': np_tree(state['params']),
                                   'batch_stats': np_tree(
                                       state['batch_stats'])})
    return {'generator': port.gen.state_dict(),
            'discriminator': port.disc.state_dict()}
  load_flax_variables(vgg, {'params': np_tree(
      runner.gen_criteria['VGG19'].criterion.vgg_params)})
  prefix = os.path.join(out_dir, child.jax_prefix(JAX_SCENARIO))
  torch.save(dict(states(init['gen'], init['disc']), vgg=vgg.state_dict()),
             prefix + '_init.pt')
  np.savez(prefix + '.npz', train=np.stack(masks))
  torch.save(states(runner.gen_state, runner.disc_state), prefix + '_final.pt')
  return {k: float(m.value) for k, m in losses.items()}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """The units on 2 and 4 ranks, the two ranks' and one process's
  scenarios, and the two ranks' replay of JAX's GAN run, with the
  directories of their states and JAX's losses."""
  dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ('two', 'one', 'jax')}
  epochs = {name: 1 for name in SCENARIOS + (JAX_SCENARIO,)}
  port2, port4, port_jax = _free_port(), _free_port(), _free_port()
  procs = [_spawn(2, r, port2, dirs['two'], ('uneven_units',) + SCENARIOS,
                  SPATIAL, threads=1, epochs=epochs) for r in range(2)]
  procs += [_spawn(4, r, port4, dirs['two'], ('uneven_units',),
                   {'data': 1, 'spatial': 4}, threads=1) for r in range(4)]
  procs.append(_spawn(1, 0, 0, dirs['one'], SCENARIOS, threads=1,
                      epochs=epochs))
  try:
    jax_losses = _jax_gan_run(dirs['jax'])
    procs += [_spawn(2, r, port_jax, dirs['jax'], (JAX_SCENARIO,), SPATIAL,
                     threads=1, epochs=epochs) for r in range(2)]
  finally:
    results = _finish(procs, CHILD_TIMEOUT_S)
  return {'two': results[:2], 'four': results[2:6], 'one': results[6],
          'jax_ranks': results[7:9], 'jax': jax_losses, 'dirs': dirs}


def _units(runs, ranks):
  return [r['uneven_units'] for r in runs['two' if ranks == 2 else 'four']]


@pytest.mark.parametrize('ranks', [2, 4])
@pytest.mark.parametrize('case', uneven.UNIT_CASES)
def test_uneven_layers_match_the_whole_image(runs, ranks, case):
  """Each rank's rows of the layer's output and gradients against the
  whole image's, on ranks of 9 rows."""
  for result in _units(runs, ranks):
    out, grad_x, grad_params = result[case]
    if case in uneven.EXACT_CASES:
      assert (out, grad_x, grad_params) == (0.0, 0.0, 0.0), \
          '{} is not bit for bit'.format(case)
    elif case == 'dc noisy':
      assert (out, grad_x, grad_params) == (0.0, 0.0, 0.0), (out, grad_x,
                                                            grad_params)
    elif case == 'unet int8 eval':
      assert out <= INT8_STEP and grad_x <= INT8_SHARE, (out, grad_x)
      assert grad_params == 0.0, 'no chain quantized'
    else:
      bar = LAYER_ATOL if case.startswith(LAYERS) else NET_ATOL
      assert out <= bar and grad_x <= bar, (out, grad_x)
      for name, (diff, own, most, scale) in grad_params.items():
        assert diff <= PARAM_RTOL * own + SCALE_ATOL * most * scale, \
            (name, diff, own, most)


@pytest.mark.parametrize('ranks', [2, 4])
def test_uneven_dc_matches_the_2d_formula(runs, ranks):
  for result in _units(runs, ranks):
    assert result['dc formula'] <= 1e-6


@pytest.mark.parametrize('ranks', [2, 4])
def test_uneven_fetches_move_only_the_rows_a_window_lacks(runs, ranks):
  """In a U-Net's train step each all-to-all of a fetch brings exactly the
  rows of other ranks its window reads (and some do move), and the only
  all_gathers are halo edges of at most 3 rows: nothing is gathered
  whole."""
  for result in _units(runs, ranks):
    assert result['fetched'], 'no fetch moved a row'
    for got, lacking in result['fetched']:
      assert got == lacking
    assert set(result['gathered']) == {'_HaloRows.forward',
                                       '_HaloRows.backward'}
    assert max(result['gathered'].values()) <= 3


def _assert_run_close(got, want, atol, what):
  assert len(got['train']) == len(want['train'])
  for g, w in zip(got['train'], want['train']):
    assert set(g) == set(w)
    for name in w:
      _close(g[name], w[name], atol, '{} train {}'.format(what, name))
  assert set(got['val']) == set(want['val'])
  for name in want['val']:
    _close(got['val'][name], want['val'][name],
           METRIC_ATOL if 'psnr' in name or 'dice' in name else atol,
           '{} val {}'.format(what, name))


def _assert_states_close(got, want, atol, what, keys=None, skip=()):
  for key, value in want.items():
    if key in skip or keys is not None and not any(k in key for k in keys):
      continue
    if value.is_floating_point():
      _close(got[key].double().numpy(), value.double().numpy(), atol,
             '{} {}'.format(what, key))


def _assert_gan_states(got, want, what):
  _assert_states_close(got['generator'], want['generator'], GEN_ATOL, what)
  disc = want['discriminator']
  _assert_states_close(got['discriminator'], disc, DISC_ATOL, what,
                       skip=[k for k in disc if 'running_' in k])
  _assert_states_close(got['discriminator'], disc, BN_ATOL, what,
                       keys=('running_',))


def test_uneven_gan_step_matches_one_process(runs):
  """The GAN at 36² on two ranks: the discriminator's second stride and
  VGG19's third pool split the ranks' rows."""
  r0, r1 = (r['adversarial36'] for r in runs['two'])
  _assert_run_close(r1, r0, RANKS_ATOL, 'ranks')
  _assert_run_close(r0, runs['one']['adversarial36'], GAN_LOSS_ATOL,
                    'one process')
  assert r0['shapes']['inp'] == [8, 18, 36, 2]
  states = [_states(runs['dirs']['two'], 'adversarial36', r)['final']
            for r in (0, 1)]
  one = _states(runs['dirs']['one'], 'adversarial36', 0)['final']
  for net in one:
    _assert_states_close(states[1][net], states[0][net], RANKS_ATOL, net)
  _assert_gan_states(states[0], one, 'one process')


def test_uneven_gan_step_matches_jax_spatial_mesh(runs):
  """The two ranks' replay of JAX's 8-device spatial GAN update at 36²:
  the losses and the networks after it."""
  r0, r1 = (r[JAX_SCENARIO] for r in runs['jax_ranks'])
  _assert_run_close(r1, r0, RANKS_ATOL, 'ranks')
  got = r0['train'][0]
  for name, want in runs['jax'].items():
    _close(got[name], want, GAN_LOSS_ATOL, 'JAX ' + name)
  want = torch.load(os.path.join(runs['dirs']['jax'], '{}_final.pt'.format(
      child.jax_prefix(JAX_SCENARIO))))
  _assert_gan_states(_states(runs['dirs']['jax'], JAX_SCENARIO, 0)['final'],
                     want, 'JAX')


def test_uneven_width_gan_validates_as_one_process(runs):
  """The GAN on 36 × 35 images on two ranks: the k-space and the mask in
  column blocks of 18 and 17 through the train step, validation and the
  metrics' gather, against one process; the gathered validation batch bit
  for bit."""
  name = 'adversarial36x35'
  r0, r1 = (r[name] for r in runs['two'])
  _assert_run_close(r1, r0, RANKS_ATOL, 'ranks')
  _assert_run_close(r0, runs['one'][name], GAN_LOSS_ATOL, 'one process')
  assert r0['shapes']['inp'] == [8, 18, 35, 2]
  assert [r['shapes']['kspace'] for r in (r0, r1)] == [[8, 36, 18, 2],
                                                       [8, 36, 17, 2]]
  assert [r['shapes']['mask'][2] for r in (r0, r1)] == [18, 17]
  one = np.load(os.path.join(runs['dirs']['one'], name + '_val_rank0.npz'))
  assert sorted(one.files) == ['inp', 'kspace', 'mask', 'target']
  assert one['kspace'].shape[1:3] == (36, 35)
  for rank in (0, 1):
    got = np.load(os.path.join(runs['dirs']['two'],
                               '{}_val_rank{}.npz'.format(name, rank)))
    for key in one.files:
      np.testing.assert_array_equal(got[key], one[key], err_msg=key)
  _assert_gan_states(_states(runs['dirs']['two'], name, 0)['final'],
                     _states(runs['dirs']['one'], name, 0)['final'],
                     'one process')


def test_uneven_segmentation_matches_one_process(runs):
  """A 2-scale segmentation U-Net at 34²: its pool splits 17 rows a
  rank."""
  r0, r1 = (r['segmentation2_34'] for r in runs['two'])
  _assert_run_close(r1, r0, RANKS_ATOL, 'ranks')
  _assert_run_close(r0, runs['one']['segmentation2_34'], SEG_LOSS_ATOL,
                    'one process')
  assert r0['shapes']['inp'][1] == 17
  got = _states(runs['dirs']['two'], 'segmentation2_34', 0)['final']['model']
  one = _states(runs['dirs']['one'], 'segmentation2_34', 0)['final']['model']
  _assert_states_close(got, one, SEG_PARAM_ATOL, 'one process')


@pytest.mark.parametrize('height,spatial,rows', [
    (36, 2, (0, 18, 36)), (48, 4, (0, 12, 24, 36, 48)), (34, 2, (0, 17, 34))])
def test_mesh_splits_rows_that_spatial_divides(height, spatial, rows):
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  for s in range(spatial):
    mesh = mesh_lib.Mesh(spatial, s, torch.device('cpu'), spatial=spatial)
    assert mesh.image_rows(height) == slice(rows[s], rows[s + 1])


@pytest.mark.parametrize('height,spatial', [(51, 2), (50, 4), (30, 4)])
def test_mesh_refuses_rows_as_jax_shard_batch_does(height, spatial):
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  mesh = mesh_lib.Mesh(spatial, 0, torch.device('cpu'), spatial=spatial)
  with pytest.raises(ValueError, match='does not divide'):
    mesh.image_rows(height)
  with pytest.raises(ValueError, match='does not divide'):
    mesh_lib.split_image_rows({'inp': np.zeros((2, height, 8, 2))}, mesh)


@pytest.mark.parametrize('width,spatial,blocks', [
    (237, 2, (119, 118)), (15, 4, (4, 4, 4, 3)), (16, 4, (4, 4, 4, 4)),
    (6, 4, (2, 2, 1, 1))])
def test_column_blocks_take_any_width(width, spatial, blocks):
  """``kspace`` and ``mask`` split by ``col_bounds``: W // S columns a
  rank, one more on the first W mod S."""
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  batch = {'mask': np.arange(2 * 8 * width).reshape(2, 8, width, 1)}
  got = []
  for s in range(spatial):
    mesh = mesh_lib.Mesh(spatial, s, torch.device('cpu'), spatial=spatial)
    got.append(mesh_lib.split_image_rows(batch, mesh)['mask'])
  assert tuple(g.shape[2] for g in got) == blocks
  np.testing.assert_array_equal(np.concatenate(got, 2), batch['mask'])


def test_strided_layouts_follow_the_stride_grid():
  """``Rows.strided``: output row o on the rank holding input row 2·o;
  equal blocks of an even count stay equal blocks and a one-hop halo."""
  from csmri_refinement_tpu_torch.parallel import halo
  rows = halo.Rows.equal(9, 2)
  out, windows = rows.strided(4, 2, 1, 1)      # k4 stride 2, pads (1, 1)
  assert out.bounds == (0, 5, 9)
  assert windows == ((-1, 11), (9, 19))
  assert halo.one_hop(rows, windows) is None
  out, windows = rows.strided(2, 2, 0, 0)      # max-pool, 18 rows → 9
  assert out.bounds == (0, 5, 9) and windows == ((0, 10), (10, 18))
  assert out.strided(2, 2, 0, 0)[0].bounds == (0, 3, 4)
  even = halo.Rows.equal(8, 4)
  out, windows = even.strided(4, 2, 1, 1)
  assert out == halo.Rows.equal(4, 4) and windows == even.halo(1, 1)
  assert halo.one_hop(even, windows) == (1, 1)
  assert out.up2() == even


def test_fetch_plan_reads_windows_across_ranks():
  """A window that reaches past its neighbour and a reflected edge read
  their rows from every rank that holds them, each row once."""
  from csmri_refinement_tpu_torch.parallel import halo
  rows = halo.Rows((0, 3, 4, 4, 8))      # ranks of 3, 1, 0 and 4 rows
  windows = rows.halo(2, 2)
  plan = halo._plan(rows, windows, 'reflect', 1)
  assert windows[1] == (1, 6) and windows[2] is None
  assert plan.recv == ((1, 2), (), (), (4, 5))
  assert plan.index == (1, 2, 0, 3, 4)      # table: own row 3, then 1, 2, 4, 5
  plan = halo._plan(rows, windows, 'reflect', 0)
  assert plan.recv == ((), (3,), (), (4,))
  assert plan.index == (2, 1, 0, 1, 2, 3, 4)   # rows -2..4: 2, 1 reflected
  assert plan.moves
