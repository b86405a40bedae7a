"""The port's sampling options against the JAX package's: the radial
masks, radial masks in the batch preparer, ``steps_per_fetch`` with a
preparer that is not device-pure, and the DC on radial masks.

Bars: masks exactly (the same ``RandomState`` draws, the states equal
after); prepared batches within 1e-6 × max |target| (one ortho FFT pair
apart); the DC within 2e-4 abs (``tests/test_dc_pallas.py:26``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.training import prep as jprep
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
from csmri_refinement_tpu_torch.ops import dc, fft, masks
from csmri_refinement_tpu_torch.training import build_runner, prep
from csmri_refinement_tpu_torch.utils.config import Configuration
from test_torch_port_data import gan_conf, recnet_conf

DC_ATOL = 2e-4          # tests/test_dc_pallas.py:26
PREP_REL = 1e-6
SIZE = 32


def _same_mask(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape
  np.testing.assert_array_equal(got, want)


def _states_equal(a, b):
  return all(np.array_equal(x, y)
             for x, y in zip(a.get_state(), b.get_state()))


# (name, call with (module, rng)): radial_sampling_np
MASK_CASES = [
    ('radial_golden', lambda m, r: m.radial_sampling_np(
        (3, 32, 32), 8, rand=True, golden_angle=True, centred=False, rng=r)),
    ('radial_uniform', lambda m, r: m.radial_sampling_np(
        (2, 1, 24, 24), 6, rand=False, golden_angle=False, centred=True,
        rng=r)),
    ('radial_rectangular', lambda m, r: m.radial_sampling_np(
        (2, 28, 32), 10, rand=True, golden_angle=True, rng=r)),
]


@pytest.mark.parametrize('name,call', MASK_CASES,
                         ids=[c[0] for c in MASK_CASES])
def test_numpy_masks_equal_jax(name, call):
  for seed in (0, 11):
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    _same_mask(call(masks, rng), call(jmasks, jrng))
    assert _states_equal(rng, jrng), 'the rng was drawn differently'


@pytest.mark.parametrize('variable', [False, True])
def test_radial_masks_equal_jax_generator(variable):
  """``radial_masks_np`` is the radial path of JAX's
  ``get_mask_generator_np``."""
  for seed in (0, 11):
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    got = masks.radial_masks_np((3, SIZE, SIZE), 8, rng, variable)
    want = jmasks.get_mask_generator_np('radial', (3, SIZE, SIZE), 8,
                                        variable, rng=jrng)()
    _same_mask(got, want)
    assert _states_equal(rng, jrng), 'the rng was drawn differently'


def test_make_masks_takes_cartesian_schemes_only():
  """``make_masks`` draws cartesian masks on the device and (as the JAX
  function does) radial ones on the host, from a ``RandomState`` seeded by
  one draw of the generator; it refuses a scheme it does not draw. The
  batch preparer's radial masks come from ``radial_masks_np``."""
  gen = torch.Generator().manual_seed(0)
  got = masks.make_masks(gen, 2, SIZE, SIZE, 'radial', 4)
  seed = masks.draw_seed(torch.Generator().manual_seed(0))
  want = masks.radial_sampling_np((2, SIZE, SIZE), 4, rand=True,
                                  golden_angle=True, centred=False,
                                  rng=np.random.RandomState(seed))
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), want)
  with pytest.raises(ValueError, match='spiral'):
    masks.make_masks(gen, 2, SIZE, SIZE, 'spiral')


def test_draw_seed_is_one_draw_of_the_generator():
  gen = torch.Generator().manual_seed(5)
  seed = masks.draw_seed(gen)
  want = int(torch.randint(0, 2 ** 31 - 1, (),
                           generator=torch.Generator().manual_seed(5)))
  assert seed == want and 0 <= seed < 2 ** 31 - 1


def _radial_conf(**overrides):
  conf_d = recnet_conf(
      train_dataset='Synthetic', validation_dataset='Synthetic',
      downscale=1,
      synthetic={'image_size': SIZE, 'num_train': 8, 'num_val': 6},
      undersampling={'sampling_scheme': 'radial', 'acceleration_factor': 10,
                     'variable_acceleration': False, 'noise': 0.05})
  conf_d.update(overrides)
  return conf_d


def _assert_batch_close(got, want, keys=('mask', 'target', 'inp', 'kspace')):
  bar = PREP_REL * float(np.abs(np.asarray(want['target'])).max())
  for key in keys:
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=bar, rtol=0, err_msg=key)


def test_radial_validation_batches_equal_jax():
  """Masks from RandomState(VAL_MASK_SEED + index) per slice, cached: the
  JAX package's bit for bit, in any batch order; no noise in validation."""
  conf_d = _radial_conf()
  conf = Configuration.from_dict(conf_d)
  val = load_dataset(conf, None, 'Synthetic', 'val')
  jpreparer = jprep.get_batch_preparer(JConfiguration.from_dict(conf_d))
  preparer = prep.RecBatchPreparer(conf, 'cpu')
  for host in (next(iter(DataLoader(val, 4))),
               next(iter(DataLoader(val, 6, shuffle=True, seed=3)))):
    want = jpreparer.prepare_val(host)
    got = preparer.prepare_val(host)
    _same_mask(got['mask'].numpy(), want['mask'])
    _assert_batch_close(got, want)
    np.testing.assert_array_equal(got['index'].numpy(), host['index'])
  assert sorted(preparer._val_masks) == list(range(6))


@pytest.mark.parametrize('variable', [False, True])
def test_radial_train_batches_equal_jax_without_noise(monkeypatch, variable):
  """The seed JAX draws from its key, handed to the port's draw: the same
  host mask (``radial_masks_np``, which honours variable
  acceleration) and the same inputs, without the config's noise."""
  conf_d = _radial_conf()
  conf_d['undersampling']['variable_acceleration'] = variable
  conf = Configuration.from_dict(conf_d)
  host = next(iter(DataLoader(load_dataset(conf, None, 'Synthetic',
                                           'train'), 4)))
  key = jax.random.PRNGKey(7)
  jpreparer = jprep.get_batch_preparer(JConfiguration.from_dict(conf_d))
  assert not jpreparer.device_pure
  want = jpreparer.prepare_train(key, host)
  seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
  monkeypatch.setattr(masks, 'draw_seed', lambda generator, device: seed)
  preparer = prep.RecBatchPreparer(conf, 'cpu')
  assert not preparer.device_pure
  got = preparer.prepare_train(torch.Generator().manual_seed(0), host)
  _same_mask(got['mask'].numpy(), want['mask'])
  _assert_batch_close(got, want)
  # no noise: the sampled k-space is the target's, masked
  k = fft.fft2(fft.unpack_complex(got['target'])) * got['mask'][..., 0]
  np.testing.assert_allclose(fft.pack_complex(k).numpy(),
                             got['kspace'].numpy(), atol=1e-5)


def test_cartesian_preparer_stays_device_pure():
  assert prep.RecBatchPreparer(Configuration.from_dict(recnet_conf()),
                               'cpu').device_pure
  assert prep.SegBatchPreparer('cpu').device_pure
  with pytest.raises(ValueError, match='spiral'):
    prep.RecBatchPreparer(Configuration.from_dict(recnet_conf(
        undersampling={'sampling_scheme': 'spiral'})), 'cpu')


@pytest.mark.parametrize('scheme', ['radial', 'varden'])
@pytest.mark.parametrize('runner_type', ['standard', 'adversarial'])
def test_steps_per_fetch_with_radial_is_one_update_per_fetch(runner_type,
                                                             scheme):
  """``steps_per_fetch`` 4 takes 4 updates per fetch with a device-pure
  preparer and one with radial masks (JAX ``runner.py:309-310``,
  ``adversarial_runner.py:543``), whose step then keeps its data for the
  train metrics."""
  conf_d = _radial_conf(steps_per_fetch=4, batch_size=2)
  conf_d['undersampling']['sampling_scheme'] = scheme
  if runner_type == 'adversarial':
    conf_d = gan_conf(**{k: conf_d[k] for k in (
        'train_dataset', 'validation_dataset', 'downscale', 'synthetic',
        'undersampling', 'steps_per_fetch', 'batch_size')})
  conf = Configuration.from_dict(conf_d)
  runner = build_runner(conf, runner_type, 'train', 'cpu')
  hosts = list(DataLoader(load_dataset(conf, None, 'Synthetic', 'train'), 2))
  assert len(hosts) == 4
  consumed, losses, data = runner._train_step(iter(hosts))
  radial = scheme == 'radial'
  assert consumed == runner.step == (1 if radial else 4)
  assert (data is not None) == radial
  assert all(np.isfinite(m.value) for m in losses.values())


def _dc_inputs(seed, b=2, n=32):
  rng = np.random.RandomState(seed)
  mask = jmasks.radial_sampling_np((b, n, n), 8, rand=True,
                                   golden_angle=True, centred=False,
                                   rng=rng).astype(np.float32)[..., None]
  x = rng.randn(b, n, n, 2).astype(np.float32)
  k0 = (rng.randn(b, n, n, 2) * mask).astype(np.float32)
  return x, k0, mask


@pytest.mark.parametrize('seed', [3, 4])
def test_dc_on_radial_masks_equals_jax(seed):
  """Radial masks are not line-structured: the port's DC (the dense K1's
  plain version here) on them, against JAX's."""
  x, k0, mask = _dc_inputs(seed)
  want = np.asarray(jdc.data_consistency(jnp.asarray(x), jnp.asarray(k0),
                                         jnp.asarray(mask)))
  got = dc.data_consistency(torch.from_numpy(x), torch.from_numpy(k0),
                            torch.from_numpy(mask)).numpy()
  np.testing.assert_allclose(got, want, atol=DC_ATOL, rtol=0)
