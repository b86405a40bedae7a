"""The port's remaining host and k-space utilities against the JAX package,
on the CPU: the mask generators no config reaches, ``make_masks``' radial
branch, the centred FFTs, the k-space crop, the noisy DC and its complex
and numpy forms, the four augmentations no transform calls,
``RecSegHostTransform``'s input options, ``get_input_batch_transform`` and
the batch preparer's refusal of an unknown application.

Bars, with their reasons:

* masks and augmentations: equal, bit for bit (the same numpy and scipy
  code drawing from equal ``RandomState``s);
* ``fft2c``/``ifft2c``/``center_crop_in_kspace``: 1e-5 (cuFFT/pocketfft
  against XLA's FFT, f32);
* the DCs: 2e-4 (``tests/test_dc_pallas.py:26``), their gradient 2e-3
  (``:46``);
* ``RecSegHostTransform``: 1e-6 (the same numpy arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from csmri_refinement_tpu.data import augment as jaug
from csmri_refinement_tpu.data import transform_wrappers as jtw
from csmri_refinement_tpu.data import transforms as jtransforms
from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu.ops import fft as jfft
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu.training import prep as jprep
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch.data import augment as taug
from csmri_refinement_tpu_torch.data import transform_wrappers as ttw
from csmri_refinement_tpu_torch.data import transforms as ttransforms
from csmri_refinement_tpu_torch.ops import dc as tdc
from csmri_refinement_tpu_torch.ops import fft as tfft
from csmri_refinement_tpu_torch.ops import masks as tmasks
from csmri_refinement_tpu_torch.ops import undersample as tus
from csmri_refinement_tpu_torch.training import prep as tprep
from csmri_refinement_tpu_torch.utils.config import Configuration

FFT_ATOL = 1e-5
DC_ATOL = 2e-4
DC_GRAD_ATOL = 2e-3
TRANSFORM_ATOL = 1e-6

# name → (function name, args, kwargs): each called in both packages with
# a RandomState(seed) as ``rng``
MASK_CASES = {
    'var_dens_2d': ('var_dens_mask_2d', ((24, 20), 1e-3), {}),
    'var_dens_3d_low_freq_only': ('var_dens_mask_2d', ((3, 16, 16), 5e-3),
                                  dict(sample_high_freq=False, sample_n=5)),
    'nlines': ('nlines_mask', ((3, 16, 12), 6), dict(sample_n=2)),
    'nlines_centred_no_centre': ('nlines_mask', ((2, 16, 8), 5),
                                 dict(centred=True, sample_centre=False)),
    'lowres_skip': ('lowres_mask', ((3, 16, 8), 4), {}),
    'lowres_centred': ('lowres_mask', ((2, 16, 8), 5),
                       dict(skip=False, centred=True)),
    'shear_grid': ('shear_grid_mask', ((4, 24, 8), 4), {}),
    'shear_grid_centred_perturbed': ('shear_grid_mask', ((4, 24, 8), 3),
                                     dict(centred=True, perturb=True,
                                          sample_n=5)),
}


def _t(a):
  return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('case', sorted(MASK_CASES))
def test_host_masks_equal_jax(case):
  name, args, kwargs = MASK_CASES[case]
  want = getattr(jmasks, name)(*args, rng=np.random.RandomState(3), **kwargs)
  got = getattr(tmasks, name)(*args, rng=np.random.RandomState(3), **kwargs)
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  assert tmasks.undersampling_rate(got) == jmasks.undersampling_rate(want)
  assert 0 < tmasks.undersampling_rate(got) < 1


def test_undersampling_sensitivity_equals_jax():
  want = jmasks.get_undersampling_sensitivity(
      (32, 32), 4, num_trials=4, rng=np.random.RandomState(1))
  got = tmasks.get_undersampling_sensitivity(
      (32, 32), 4, num_trials=4, rng=np.random.RandomState(1))
  assert got == want
  rate = tmasks.var_dens_mask_2d((8, 32, 32), got, rng=np.random.RandomState(
      2)).mean()
  assert abs(rate - 0.25) < 0.05
  with pytest.raises(ValueError, match='Cannot reach'):
    tmasks.get_undersampling_sensitivity((32, 32), 1.05, num_trials=2)


@pytest.mark.parametrize('variable', [False, True], ids=['fixed', 'variable'])
@pytest.mark.parametrize('scheme', ['radial', 'cartesian'])
def test_mask_generator_np_equals_jax(scheme, variable):
  """Two masks of each generator from one RandomState each side."""
  # a variable cartesian mask keeps 64 // 6 ≥ 8 centre lines
  shape, acc = ((3, 32, 32), 8) if scheme == 'radial' else ((3, 64, 64), 4)
  want_gen = jmasks.get_mask_generator_np(scheme, shape, acc, variable,
                                          rng=np.random.RandomState(5))
  got_gen = tmasks.get_mask_generator_np(scheme, shape, acc, variable,
                                         rng=np.random.RandomState(5))
  for _ in range(2):
    want, got = want_gen(), got_gen()
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


def test_make_masks_radial_equals_jax():
  """The same seed gives the same (B, n, n) f32 masks: JAX draws it from
  its key, the port from its generator (``draw_seed``)."""
  key = jax.random.PRNGKey(7)
  seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
  want = np.asarray(jmasks.make_masks(key, 3, 32, 32, 'radial', 8))
  with mock.patch.object(tmasks, 'draw_seed', return_value=seed) as draw:
    got = tmasks.make_masks(torch.Generator().manual_seed(0), 3, 32, 32,
                            'radial', 8, device='cpu')
  draw.assert_called_once()
  assert got.dtype == torch.float32 and got.device.type == 'cpu'
  np.testing.assert_array_equal(got.numpy(), want)
  # without the patch: a seed from the generator, the same for equal states
  a, b = (tmasks.make_masks(torch.Generator().manual_seed(1), 2, 16, 16,
                            'radial', 4) for _ in range(2))
  assert torch.equal(a, b) and 0 < float(a.mean()) < 1


@pytest.mark.parametrize('shape', [(2, 16, 16), (3, 9, 12)],
                         ids=['even', 'odd'])
def test_centred_ffts_equal_jax(shape):
  rng = np.random.RandomState(sum(shape))
  x = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
  for name in ('fft2c', 'ifft2c'):
    np.testing.assert_allclose(getattr(tfft, name)(_t(x)).numpy(),
                               np.asarray(getattr(jfft, name)(x)),
                               atol=FFT_ATOL, err_msg=name)
  xt = np.moveaxis(x, 0, -1)       # over axes (0, 1)
  np.testing.assert_allclose(tfft.fft2c(_t(xt), axes=(0, 1)).numpy(),
                             np.asarray(jfft.fft2c(xt, axes=(0, 1))),
                             atol=FFT_ATOL)


@pytest.mark.parametrize('size', [16, (12, 10)], ids=['square', 'rect'])
def test_center_crop_in_kspace_equals_jax(size):
  img = np.random.RandomState(0).rand(32, 28).astype(np.float32)
  want = np.asarray(jus.center_crop_in_kspace(jnp.asarray(img), size))
  got = tus.center_crop_in_kspace(_t(img), size)
  assert got.dtype == torch.float32 and got.shape == want.shape
  np.testing.assert_allclose(got.numpy(), want, atol=FFT_ATOL)
  np.testing.assert_allclose(
      got.numpy(), ttransforms.center_crop_in_kspace_np(img, size),
      atol=FFT_ATOL)


def _dc_inputs(seed=0, b=2, h=16, w=16):
  rng = np.random.RandomState(seed)
  x = rng.randn(b, h, w, 2).astype(np.float32)
  mask = (rng.rand(b, h, w, 1) < 0.4).astype(np.float32)
  k0 = (rng.randn(b, h, w, 2) * mask).astype(np.float32)
  return x, k0, mask


@pytest.mark.parametrize('noise_lvl', [None, 0.0, 0.05, 0.5])
def test_noisy_data_consistency_equals_jax(noise_lvl):
  """Forward and input gradient; ``None`` is the DC kernel's plain
  version, a level (0 too) the torch.fft composition."""
  x, k0, mask = _dc_inputs()
  g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

  def jfn(x):
    return jnp.sum(jdc.data_consistency(x, jnp.asarray(k0), jnp.asarray(mask),
                                        noise_lvl=noise_lvl) * g)
  want = np.asarray(jdc.data_consistency(jnp.asarray(x), jnp.asarray(k0),
                                         jnp.asarray(mask),
                                         noise_lvl=noise_lvl))
  want_grad = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
  xt = _t(x).requires_grad_()
  got = tdc.data_consistency(xt, _t(k0), _t(mask), noise_lvl=noise_lvl)
  (got * _t(g)).sum().backward()
  np.testing.assert_allclose(got.detach().numpy(), want, atol=DC_ATOL)
  np.testing.assert_allclose(xt.grad.numpy(), want_grad, atol=DC_GRAD_ATOL)


@pytest.mark.parametrize('noise_lvl', [None, 0.1])
def test_kspace_merge_and_complex_dc_equal_jax(noise_lvl):
  x, k0, mask = _dc_inputs(2)
  xc = x[..., 0] + 1j * x[..., 1]
  k0c = (k0[..., 0] + 1j * k0[..., 1]).astype(np.complex64)
  m = mask[..., 0]
  want = np.asarray(jdc.data_consistency_complex(
      jnp.asarray(xc, jnp.complex64), jnp.asarray(k0c), jnp.asarray(m),
      noise_lvl))
  got = tdc.data_consistency_complex(_t(xc.astype(np.complex64)), _t(k0c),
                                     _t(m), noise_lvl)
  assert got.dtype == torch.complex64
  np.testing.assert_allclose(got.numpy(), want, atol=DC_ATOL)
  k = np.fft.fft2(xc).astype(np.complex64)
  np.testing.assert_allclose(
      tdc.kspace_merge_reference(_t(k), _t(k0c), _t(m), noise_lvl).numpy(),
      np.asarray(jdc.kspace_merge_reference(k, k0c, m, noise_lvl)),
      atol=DC_ATOL)


def test_data_consistency_np_equals_jax():
  x, k0, mask = _dc_inputs(3)
  xc = x[..., 0] + 1j * x[..., 1]
  y = k0[..., 0] + 1j * k0[..., 1]
  m = mask[..., 0]
  want = jdc.data_consistency_np(xc, y, m)
  got = tdc.data_consistency_np(xc, y, m)
  np.testing.assert_allclose(got, want, atol=DC_ATOL)
  np.testing.assert_allclose(
      got, tdc.data_consistency_complex(_t(xc.astype(np.complex64)),
                                        _t(y.astype(np.complex64)),
                                        _t(m)).numpy(), atol=DC_ATOL)


AUGMENT_CASES = {
    'gaussian_noise': lambda mod, img: mod.gaussian_noise(
        img, 0.1, np.random.RandomState(4)),
    'gaussian_blur': lambda mod, img: mod.gaussian_blur(img, 1.5),
    'center_crop': lambda mod, img: mod.center_crop(img, (9, 12)),
    'random_crop': lambda mod, img: mod.random_crop(
        img, 10, np.random.RandomState(4)),
}


@pytest.mark.parametrize('case', sorted(AUGMENT_CASES))
def test_augmentations_equal_jax(case):
  img = np.random.RandomState(0).rand(21, 17, 2).astype(np.float32)
  want = AUGMENT_CASES[case](jaug, img)
  got = AUGMENT_CASES[case](taug, img)
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('normalize,scale_by_max',
                         [(True, False), (False, True), (True, True)])
def test_rec_seg_transform_input_options_equal_jax(normalize, scale_by_max):
  rng = np.random.RandomState(6)
  image = rng.rand(32, 32).astype(np.float32)
  label = (rng.rand(32, 32) > 0.7).astype(np.float32)
  aug = {'shift': 3, 'rotate': 10, 'scale': [0.9, 1.1]}
  want = jtransforms.RecSegHostTransform(
      32, 2, aug, np.random.RandomState(1), normalize=normalize,
      scale_by_max=scale_by_max)(image, label)
  got = ttransforms.RecSegHostTransform(
      32, 2, aug, np.random.RandomState(1), normalize=normalize,
      scale_by_max=scale_by_max)(image, label)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_allclose(g, w, atol=TRANSFORM_ATOL)
  if normalize and not scale_by_max:
    assert abs(got[0].mean()) < 1e-5 and abs(got[0].std() - 1) < 1e-4
  else:
    assert 0 <= got[0].min() and got[0].max() <= 1


@pytest.mark.parametrize('application',
                         ['reconstruction', 'segmentation', 'none', 'foo'])
def test_input_batch_transform_as_jax(application):
  """None for the three applications in both packages; an unknown one
  raises in both (JAX asserts)."""
  if application == 'foo':
    with pytest.raises(AssertionError, match='Unknown application'):
      jtw.get_input_batch_transform(None, application, 'test')
    with pytest.raises(ValueError, match='Unknown application'):
      ttw.get_input_batch_transform(None, application, 'test')
  else:
    assert jtw.get_input_batch_transform(None, application, 'test') is None
    assert ttw.get_input_batch_transform(None, application, 'test') is None


def test_batch_preparer_refuses_an_unknown_application_as_jax():
  """``get_batch_preparer`` raises ValueError for an application it has no
  preparer for, in both packages."""
  conf = {'application': 'foo', 'undersampling': {}}
  with pytest.raises(ValueError, match='Unknown application foo'):
    jprep.get_batch_preparer(JConfiguration.from_dict(conf))
  with pytest.raises(ValueError, match='Unknown application foo'):
    tprep.get_batch_preparer(Configuration.from_dict(conf), 'cpu')


@pytest.mark.parametrize('kind', ['rec', 'seg'])
def test_output_transform_factories_match_jax(kind):
  rng = np.random.RandomState(9)
  pred = rng.randn(2, 8, 8, 2).astype(np.float32)
  target = rng.randn(2, 8, 8, 2).astype(np.float32) if kind == 'rec' else \
      rng.randint(0, 2, (2, 8, 8)).astype(np.int64)
  name = 'get_{}_output_transform'.format(kind)
  want = getattr(jtw, name)(None, 'test')(pred, target)
  got = getattr(ttw, name)(None, 'test')(_t(pred), _t(target))
  for g, w in zip(got, want):
    assert tuple(g.shape) == tuple(w.shape)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
