"""The port's host augmentation, transforms and augmented datasets against
the JAX package's.

Every function draws from a ``RandomState``; from equal states the port and
the JAX package give equal arrays, bit for bit (bar: exact equality, and the
states equal after the call). Datasets are read with ``num_data_workers``
0, since threads sharing one ``RandomState`` draw in no fixed order (in
both packages).
"""

import numpy as np
import pytest

from csmri_refinement_tpu.data import DataLoader as JDataLoader
from csmri_refinement_tpu.data import augment as jaugment
from csmri_refinement_tpu.data import datasets as jdatasets
from csmri_refinement_tpu.data import transforms as jtransforms
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch.data import DataLoader, augment, datasets
from csmri_refinement_tpu_torch.data import transforms
from csmri_refinement_tpu_torch.utils.config import Configuration

AUGMENTATION = {'elastic_transform_alpha': 6.0, 'elastic_transform_sigma': 3.0,
                'shift': 4, 'rotate': 15, 'scale': [0.85, 1.15]}
SEG_AUGMENTATION = {'shift': 4, 'rotate': 15, 'scale': [0.85, 1.15]}


def _image(seed, shape=(48, 40, 1)):
  return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _label(seed, shape=(48, 40, 1)):
  return (np.random.RandomState(seed).rand(*shape) > 0.7).astype(np.float32)


def _assert_same(got, want):
  if isinstance(want, tuple):
    assert len(got) == len(want)
    for g, w in zip(got, want):
      _assert_same(g, w)
    return
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)


def _states_equal(a, b):
  sa, sb = a.get_state(), b.get_state()
  return all(np.array_equal(x, y) for x, y in zip(sa, sb))


# (name, call with (module, rng)): every function of data/augment.py
CASES = [
    ('elastic', lambda m, r: m.elastic_transform(_image(1), 6.0, 3.0, r)),
    ('elastic_order3', lambda m, r: m.elastic_transform(
        _image(1, (32, 32, 2)), 20.0, 2.0, r, spline_order=3,
        mode='reflect')),
    ('translate', lambda m, r: m.random_translate(_image(2), 5, r)),
    ('translate_h_only', lambda m, r: m.random_translate(_image(2), (3, 0),
                                                         r)),
    ('translate_none', lambda m, r: m.random_translate(_image(2), 0, r)),
    ('rotate', lambda m, r: m.random_rotate(_image(3), (-20, 20), r)),
    ('rotate_order1', lambda m, r: m.random_rotate(_image(3), (-90, 90), r,
                                                   mode='constant',
                                                   order=1)),
    ('rotate_pair', lambda m, r: m.random_rotate_pair(_image(4), _label(5),
                                                      (-30, 30), r)),
    ('zoom_in', lambda m, r: m.random_zoom(_image(6), (1.1, 1.3), r)),
    ('zoom_out', lambda m, r: m.random_zoom(_image(6), (0.7, 0.9), r)),
    ('zoom_pair', lambda m, r: m.random_zoom_pair(_image(7), _label(8),
                                                  (0.8, 1.2), r)),
    ('clipped_zoom_one', lambda m, r: m.clipped_zoom(_image(9), 1.0)),
]


@pytest.mark.parametrize('name,call', CASES, ids=[c[0] for c in CASES])
def test_augmentation_equals_jax(name, call):
  for seed in (0, 7):
    jrng, rng = np.random.RandomState(seed), np.random.RandomState(seed)
    _assert_same(call(augment, rng), call(jaugment, jrng))
    assert _states_equal(rng, jrng), 'the rng was drawn differently'


def test_translate_draws_width_before_height():
  """Offsets (th, tw) = (5, 6): the first draw is the width's."""
  img = _image(2, (16, 16, 1))
  draws = np.random.RandomState(3)
  tw, th = draws.randint(-6, 6), draws.randint(-5, 5)
  got = augment.random_translate(img, (5, 6), np.random.RandomState(3))
  want = np.zeros_like(img)
  x1, x2 = max(0, tw), min(16 + tw, 16)
  y1, y2 = max(0, th), min(16 + th, 16)
  want[:y2 - y1, :x2 - x1] = img[y1:y2, x1:x2]
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('downscale', [1, 2], ids=['same_size', 'crop'])
@pytest.mark.parametrize('aug', [None, AUGMENTATION,
                                 {'shift': 3}, {'rotate': 10},
                                 {'scale': [0.9, 1.1]}],
                         ids=['none', 'all', 'shift', 'rotate', 'scale'])
def test_rec_host_transform_equals_jax(aug, downscale):
  raw = (200 * np.random.RandomState(1).rand(32, 32)).astype(np.int16)
  got_t = transforms.RecHostTransform(32, downscale, aug,
                                      np.random.RandomState(4))
  want_t = jtransforms.RecHostTransform(32, downscale, aug,
                                        np.random.RandomState(4))
  for _ in range(3):   # the transform's rng carries over between items
    _assert_same(got_t(raw), want_t(raw))


@pytest.mark.parametrize('aug', [None, SEG_AUGMENTATION, {'rotate': 10}],
                         ids=['none', 'all', 'rotate_only'])
@pytest.mark.parametrize('downscale', [1, 2], ids=['same_size', 'crop'])
def test_recseg_host_transform_equals_jax(aug, downscale):
  raw = (200 * np.random.RandomState(1).rand(32, 32)).astype(np.int16)
  label = (np.random.RandomState(2).rand(32, 32) > 0.6).astype(np.uint8)
  got_t = transforms.RecSegHostTransform(32, downscale, aug,
                                         np.random.RandomState(5))
  want_t = jtransforms.RecSegHostTransform(32, downscale, aug,
                                           np.random.RandomState(5))
  for _ in range(3):
    _assert_same(got_t(raw, label), want_t(raw, label))


@pytest.fixture(scope='module')
def scarseg_64(tmp_path_factory):
  """A ScarSeg-format tree at 64² (2 slices per case): at ``downscale`` 8
  the slices need no k-space crop, at 16 they are cropped to 32²."""
  root = str(tmp_path_factory.mktemp('scarseg_64'))
  datasets.write_scarseg_phantoms(root, 64, 2, seed=4)
  return root


def _items_equal(got, want, n):
  for i in range(n):
    a, b = got[i], want[i]
    assert set(a) == set(b)
    for key in a:
      _assert_same(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize('mode,downscale,aug', [
    ('reconstruction', 8, AUGMENTATION),
    ('reconstruction', 16, AUGMENTATION),
    ('segmentation', 8, SEG_AUGMENTATION),
    ('segmentation', 16, SEG_AUGMENTATION),
])
@pytest.mark.parametrize('fold', ['train', 'val'])
def test_scarseg_items_with_augmentation_equal_jax(scarseg_64, mode,
                                                   downscale, aug, fold):
  """The training fold augments, the others do not; items in order, then
  through each package's loader (shuffled, num_data_workers 0)."""
  conf_d = {'seed': 3, 'downscale': downscale, 'dataset_mode': mode,
            'augmentation': aug}
  got = datasets.load_dataset(Configuration.from_dict(conf_d), scarseg_64,
                              'ScarSeg', fold)
  want = jdatasets.load_dataset(JConfiguration.from_dict(conf_d), scarseg_64,
                                'ScarSeg', fold)
  assert (got.augmentation is None) == (fold != 'train')
  _items_equal(got, want, 6)
  got_b = list(DataLoader(got, 4, shuffle=True, seed=1, num_workers=0))
  want_b = list(JDataLoader(want, 4, shuffle=True, seed=1, num_workers=0))
  assert len(got_b) == len(want_b)
  for a, b in zip(got_b[:3], want_b[:3]):
    for key in b:
      _assert_same(a[key], b[key])


@pytest.mark.parametrize('mode,aug', [('reconstruction', AUGMENTATION),
                                      ('segmentation', SEG_AUGMENTATION)])
def test_synthetic_items_with_augmentation_equal_jax(mode, aug):
  conf_d = {'seed': 2, 'dataset_mode': mode, 'augmentation': aug,
            'synthetic': {'image_size': 32, 'num_train': 6, 'num_val': 2}}
  for fold in ('train', 'val'):
    got = datasets.load_dataset(Configuration.from_dict(conf_d), None,
                                'Synthetic', fold)
    want = jdatasets.load_dataset(JConfiguration.from_dict(conf_d), None,
                                  'Synthetic', fold)
    _items_equal(got, want, len(want))
