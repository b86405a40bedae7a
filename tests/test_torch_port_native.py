"""The port's host library (``csrc/csmri_host.cc``, built by
``data/native.py``) against the JAX package's (``native/``, built by its
Makefile), and the native batch path through both loaders.

Both libraries are the same source compiled with the same flags on this
machine, so every output is held to the JAX package's bit for bit (bar:
exact equality). The port builds its own copy into ``_build/`` and raises
where the JAX package would fall back to numpy.
"""

import os

import numpy as np
import pytest

from csmri_refinement_tpu.data import DataLoader as JDataLoader
from csmri_refinement_tpu.data import datasets as jdatasets
from csmri_refinement_tpu.data import native as jnative
from csmri_refinement_tpu.utils.config import Configuration as JConfiguration
from csmri_refinement_tpu_torch.data import DataLoader, datasets, native
from csmri_refinement_tpu_torch.utils.config import Configuration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_library():
  if not jnative.available():
    pytest.fail('the JAX package could not build native/libcsmri_host.so')


def test_library_builds_from_the_ports_copy_into_build():
  path = native.library()._name
  assert os.path.dirname(path) == native.BUILD_DIR
  assert os.path.basename(path).startswith('libcsmri_host-')
  assert native.SOURCE == os.path.join(
      REPO, 'csmri_refinement_tpu_torch', 'csrc', 'csmri_host.cc')
  assert native.build() == path    # built once, then found by its name


def test_library_name_follows_the_source(tmp_path, monkeypatch):
  """An edited source gets another file name, so a stale library is never
  loaded."""
  before = native.lib_path()
  src = tmp_path / 'csmri_host.cc'
  with open(native.SOURCE) as f:
    src.write_text(f.read() + '\n// edited\n')
  monkeypatch.setattr(native, 'SOURCE', str(src))
  assert native.lib_path() != before


def test_library_is_loaded_once_per_process(tmp_path, monkeypatch):
  """Later calls return the library already loaded: an edit of the source
  during a run neither rebuilds nor loads another library."""
  lib = native.library()
  src = tmp_path / 'csmri_host.cc'
  src.write_text('this is not C++\n')
  monkeypatch.setattr(native, 'SOURCE', str(src))
  monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
  assert native.library() is lib
  assert not os.path.exists(native.BUILD_DIR)


@pytest.mark.parametrize('aug', [
    dict(), dict(shift=3), dict(max_rotate=20.0),
    dict(zoom_range=(0.8, 1.2)),
    dict(shift=4, max_rotate=15.0, zoom_range=(0.9, 1.1))],
                         ids=['none', 'shift', 'rotate', 'zoom', 'all'])
@pytest.mark.parametrize('seed', [0, 12345678901234])
def test_prepare_batch_equals_jax(jax_library, aug, seed):
  slices = (50 * np.random.RandomState(0).randn(6, 24, 20)).astype(np.float32)
  indices = np.array([3, 0, 5, 3], np.int32)
  got = native.prepare_batch(slices, indices, seed=seed, **aug)
  want = jnative.prepare_batch(slices, indices, seed=seed, **aug)
  assert got.dtype == want.dtype == np.float32
  np.testing.assert_array_equal(got, want)


def test_prepare_batch_refuses_an_index_out_of_range():
  slices = np.zeros((2, 4, 4), np.float32)
  with pytest.raises(IndexError):
    native.prepare_batch(slices, np.array([0, 2]))


def test_normalize_equals_jax(jax_library):
  data = (10 * np.random.RandomState(1).randn(5, 12, 9)).astype(np.float32)
  got = native.normalize(data.copy(), num_threads=3)
  want = jnative.normalize(data.copy(), num_threads=3)
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('scale', [0.0, 1.0, 2.5])
def test_extract_slices_i16_equals_jax(jax_library, scale):
  vol = np.random.RandomState(2).randint(-3000, 3000, (7, 5, 3)).astype(
      np.int16)
  vol = np.asfortranarray(vol)
  got = native.extract_slices_i16(vol, scale)
  want = jnative.extract_slices_i16(vol, scale)
  assert got.shape == (3, 7, 5)
  np.testing.assert_array_equal(got, want)


@pytest.fixture(scope='module')
def scarseg_32(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('scarseg_32'))
  datasets.write_scarseg_phantoms(root, 32, 2, seed=6)
  return root


@pytest.mark.parametrize('prefetch', [1, 2])
@pytest.mark.parametrize('aug', [None, {'shift': 3, 'rotate': 10,
                                        'scale': [0.9, 1.1]}],
                         ids=['plain', 'augmented'])
def test_loader_native_batches_equal_jax(jax_library, scarseg_32, aug,
                                         prefetch):
  """The training fold at downscale 16 (32², no k-space crop): every batch
  comes from the library (the producer thread's too with prefetch 2), each
  seeded ``seed * 1000003 + counter``, equal to the JAX loader's."""
  conf_d = {'seed': 5, 'downscale': 16, 'native_pipeline': True,
            'augmentation': aug}
  got_set = datasets.load_dataset(Configuration.from_dict(conf_d),
                                  scarseg_32, 'ScarSeg', 'train')
  want_set = jdatasets.load_dataset(JConfiguration.from_dict(conf_d),
                                    scarseg_32, 'ScarSeg', 'train')
  assert want_set._native is not None
  got = list(DataLoader(got_set, 10, shuffle=True, seed=2, num_workers=2,
                        prefetch=prefetch))
  want = list(JDataLoader(want_set, 10, shuffle=True, seed=2, num_workers=2,
                          prefetch=prefetch))
  assert len(got) == len(want) == 5
  for a, b in zip(got, want):
    assert set(a) == set(b) == {'gt', 'index'}
    np.testing.assert_array_equal(a['index'], b['index'])
    np.testing.assert_array_equal(a['gt'], b['gt'])
  assert got_set._native_counter == 5


def test_native_pipeline_off_its_path_takes_the_numpy_path(scarseg_32):
  """A k-space crop, labels or segmentation items keep the per-item path,
  as in the JAX package."""
  for extra in ({'downscale': 32}, {'downscale': 16, 'include_labels': True},
                {'downscale': 16, 'dataset_mode': 'segmentation'}):
    conf = Configuration.from_dict(dict(seed=0, native_pipeline=True,
                                        **extra))
    ds = datasets.load_dataset(conf, scarseg_32, 'ScarSeg', 'train')
    assert ds.native_batch([0, 1]) is None


def test_native_pipeline_raises_when_the_library_cannot_be_built(
    scarseg_32, tmp_path, monkeypatch):
  """Where the JAX package falls back to the numpy path, the port raises:
  the config asked for the native augmentation."""
  src = tmp_path / 'csmri_host.cc'
  src.write_text('this is not C++\n')
  monkeypatch.setattr(native, 'SOURCE', str(src))
  monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
  monkeypatch.setattr(native, '_LIB', None)   # as in a new process
  conf = Configuration.from_dict({'seed': 0, 'downscale': 16,
                                  'native_pipeline': True})
  with pytest.raises(RuntimeError, match='csmri_host.cc'):
    datasets.load_dataset(conf, scarseg_32, 'ScarSeg', 'train')
  conf = Configuration.from_dict({'seed': 0, 'downscale': 16})
  assert datasets.load_dataset(conf, scarseg_32, 'ScarSeg',
                               'train').native_batch([0]) is None
  monkeypatch.setattr(native, 'CXX', str(tmp_path / 'no-such-compiler'))
  with pytest.raises(RuntimeError, match='no-such-compiler'):
    native.build()
