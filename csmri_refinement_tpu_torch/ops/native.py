"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library, loaded with ``ctypes``. The
build runs at first use, into ``_build/`` inside the package (listed in
``.gitignore``); the library's file name carries a hash of its source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or header
is rebuilt and a stale library is never loaded.
``build`` compiles several sources at once, one ``nvcc`` process each.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
KERNELS = ('dc', 'conv_chain', 'conv_f32', 'conv_int8', 'probes')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')
# Flags of one source: dc.cu's kernels optimised in parallel threads (its
# line kernels inline a stage function per radix four times over): built
# alone on an H100 machine's 8 cores in 55.3 s instead of 122.9
# (chip_smoke.py --dc-routes-only), its kernels no slower.
SOURCE_FLAGS = {'dc': ('--split-compile=0',)}

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc():
  cands = [os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc')
           if os.environ.get('CUDA_HOME') else None,
           '/usr/local/cuda/bin/nvcc', shutil.which('nvcc')]
  for cand in cands:
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                     'machine with the CUDA toolkit')


def _flags(name):
  return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _lib_path(name):
  src = os.path.join(CSRC_DIR, name + '.cu')
  digest = hashlib.sha256(' '.join(_flags(name)).encode())
  for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh'))):
    with open(path, 'rb') as f:
      digest.update(f.read())
  return src, os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(
      name, digest.hexdigest()[:16]))


def build(names=KERNELS):
  """Compile the named kernels that are not built yet, in parallel.

  Returns {name: (seconds, compiler log)}; an empty log means the library
  was already built. Raises RuntimeError with nvcc's output on failure.
  """
  os.makedirs(BUILD_DIR, exist_ok=True)
  procs = {}
  report = {}
  for name in names:
    src, out = _lib_path(name)
    if os.path.exists(out):
      report[name] = (0.0, '')
      continue
    tmp = '{}.{}.tmp'.format(out, os.getpid())
    cmd = [_nvcc(), *_flags(name), '-o', tmp, src]
    procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   tmp, out, time.perf_counter())
  for name, (proc, tmp, out, t0) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
      raise RuntimeError('nvcc failed for csrc/{}.cu:\n{}'.format(name, log))
    os.replace(tmp, out)
    report[name] = (time.perf_counter() - t0, log)
  return report


def library(name):
  """The loaded ctypes library of ``csrc/<name>.cu``, built if needed."""
  with _LOCK:
    if name not in _LIBS:
      build((name,))
      _LIBS[name] = ctypes.CDLL(_lib_path(name)[1])
    return _LIBS[name]


def check(status, what):
  """Raise if a kernel's C entry point returned a CUDA error code."""
  if status != 0:
    raise RuntimeError('{} failed: CUDA error {}'.format(what, status))


def ptr(t):
  return ctypes.c_void_p(t.data_ptr())


def stream_of(t):
  return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
