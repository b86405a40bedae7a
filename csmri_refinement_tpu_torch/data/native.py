"""ctypes bindings of the native host-pipeline library (``csrc/csmri_host.cc``).

Port of ``csmri_refinement_tpu/data/native.py``: the multithreaded C++ path
of batch preparation (slice gather, geometric augmentation, max-abs
normalisation) behind ``native_pipeline: true``, and two helpers
(``normalize``, ``extract_slices_i16``), with the JAX module's ctypes
signatures. The source is the port's own copy of the JAX package's
``native/csmri_host.cc``.

The library is built at first use by ``g++`` with the JAX package's
``native/Makefile`` flags (``-march=native`` where the compiler accepts it)
into ``_build/`` inside the package (listed in ``.gitignore``). Its file
name carries a hash of the source, the flags and the CPU target they
resolve to, so an edited source is rebuilt and a stale library, or one
built for another CPU, is never loaded; each build writes a file of
its own and renames it into place, so concurrent processes never load a
half-written library.

One deliberate difference: where the JAX package falls back to the per-item
numpy path when the library is missing, ``library`` raises. A config that
asks for the native path gets it or an error, never another augmentation.

The native augmentation samples bilinearly with reflect borders through
one combined rotate + zoom + translate map; the scipy path applies the
transforms one after another with order-2 splines. The two are the same
augmentation in distribution, not bit for bit.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, 'csrc', 'csmri_host.cc')
BUILD_DIR = os.path.join(_PKG, '_build')
CXX = 'g++'
CXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-pthread', '-Wall')

_LIB = None
_LOCK = threading.Lock()


def _run(cmd):
  """(return code, stdout) of ``cmd``; (None, '') if it cannot start."""
  try:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.DEVNULL, text=True, timeout=60)
  except (OSError, subprocess.TimeoutExpired):
    return None, ''
  return proc.returncode, proc.stdout


@functools.lru_cache(maxsize=None)
def _arch(cxx):
  """(('-march=native',) where ``cxx`` accepts it, as the Makefile asks;
  the target it resolves to on this machine, as ``cxx`` describes it)."""
  rc, _ = _run([cxx, '-march=native', '-E', '-x', 'c++', os.devnull])
  if rc != 0:
    return (), ''
  _, target = _run([cxx, '-march=native', '-Q', '--help=target'])
  return ('-march=native',), target


def _flags():
  return CXX_FLAGS + _arch(CXX)[0] + ('-shared',)


def lib_path():
  """The library's path in ``BUILD_DIR``, named by a hash of the source,
  the flags and the target ``-march=native`` resolves to (a library built
  for another CPU is never loaded)."""
  digest = hashlib.sha256(' '.join((CXX,) + _flags()).encode())
  digest.update(_arch(CXX)[1].encode())
  with open(SOURCE, 'rb') as f:
    digest.update(f.read())
  return os.path.join(BUILD_DIR, 'libcsmri_host-{}.so'.format(
      digest.hexdigest()[:16]))


def build():
  """Compile the library unless it is built; returns its path. Raises
  RuntimeError with the compiler's output when the build fails."""
  out = lib_path()
  if os.path.exists(out):
    return out
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = '{}.{}.{}.tmp'.format(out, os.getpid(), threading.get_ident())
  cmd = [CXX, *_flags(), '-o', tmp, SOURCE]
  try:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
  except OSError as e:
    raise RuntimeError('cannot run {}: {}'.format(CXX, e)) from e
  if proc.returncode != 0:
    if os.path.exists(tmp):
      os.remove(tmp)
    raise RuntimeError('{} failed for {}:\n{}'.format(
        CXX, os.path.basename(SOURCE), proc.stdout))
  os.replace(tmp, out)
  return out


def library():
  """The loaded ctypes library, built at the first call of the process and
  kept: an edit of the source during a run loads nothing new. Raises
  RuntimeError when it cannot be built or loaded."""
  global _LIB
  if _LIB is None:
    with _LOCK:
      if _LIB is None:
        _LIB = _load()
  return _LIB


def _load():
  path = build()
  try:
    lib = ctypes.CDLL(path)
  except OSError as e:
    raise RuntimeError('cannot load {}: {}'.format(path, e)) from e
  lib.csmri_prepare_batch.argtypes = [
      ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
      ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
      ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
      ctypes.c_float, ctypes.c_uint64, ctypes.c_int32]
  lib.csmri_prepare_batch.restype = None
  lib.csmri_normalize.argtypes = [
      ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
      ctypes.c_int32]
  lib.csmri_normalize.restype = None
  lib.csmri_extract_slices_i16.argtypes = [
      ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float]
  lib.csmri_extract_slices_i16.restype = None
  return lib


def _fptr(arr):
  return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def prepare_batch(slices, indices, shift=0, max_rotate=0.0,
                  zoom_range=(1.0, 1.0), seed=0, num_threads=0):
  """Gather + augment + normalise a batch of ground-truth slices.

  slices: (N, H, W) float32 pool; indices: (B,) ints in [0, N).
  Returns (B, H, W) float32.
  """
  lib = library()
  slices = np.ascontiguousarray(slices, np.float32)
  indices = np.ascontiguousarray(indices, np.int32)
  if slices.ndim != 3 or indices.ndim != 1:
    raise ValueError('prepare_batch takes (N, H, W) slices and (B,) indices')
  if len(indices) and not 0 <= indices.min() <= indices.max() < len(slices):
    raise IndexError('slice index out of range')
  b = len(indices)
  h, w = slices.shape[1], slices.shape[2]
  out = np.empty((b, h, w), np.float32)
  lib.csmri_prepare_batch(
      _fptr(slices), indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
      _fptr(out), b, h, w, int(shift), float(max_rotate),
      float(zoom_range[0]), float(zoom_range[1]), int(seed) & (2**64 - 1),
      int(num_threads))
  return out


def normalize(data, num_threads=0):
  """Per-slice max-abs normalisation of an (N, H, W) f32 array, in place
  when ``data`` is a C-contiguous float32 array; returns the result."""
  lib = library()
  data = np.ascontiguousarray(data, np.float32)
  n = data.shape[0]
  hw = int(np.prod(data.shape[1:]))
  lib.csmri_normalize(_fptr(data), n, hw, int(num_threads))
  return data


def extract_slices_i16(volume_f_order, scale=1.0):
  """Fortran-ordered (dim1, dim2, nz) int16 volume → (nz, dim1, dim2) f32."""
  lib = library()
  vol = np.asfortranarray(volume_f_order, np.int16)
  if vol.ndim != 3:
    raise ValueError('extract_slices_i16 takes a (dim1, dim2, nz) volume')
  dim1, dim2, nz = vol.shape
  out = np.empty((nz, dim1, dim2), np.float32)
  lib.csmri_extract_slices_i16(
      vol.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fptr(out),
      dim1, dim2, nz, float(scale))
  return out
