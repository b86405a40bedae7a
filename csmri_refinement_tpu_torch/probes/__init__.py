"""Primitive probes: the Hopper counterparts of the TPU probes K4 and K5.

``probes/mosaic_prims.py`` (K4, ``scripts/probe_mosaic_prims.py``) and
``probes/int8_prims.py`` (K5, ``scripts/probe_int8_prims.py``) each launch
one kernel of ``csrc/probes.cu`` per probe, on the probe's fixed tile, and
compare it with a plain PyTorch version of the same function. The kernels
run as one wave of small blocks with 16-byte accesses; the MMA probes issue
``wgmma`` through shared-memory descriptors whose layout fields are decided
here (``descriptor``) and checked by the kernel. Each prints
``name OK``, ``name WRONG NUMERICS`` or ``name FAIL: <reason>`` per probe
and exits non-zero unless every probe is OK:

    python -m csmri_refinement_tpu_torch.probes.mosaic_prims [--device cpu]
    python -m csmri_refinement_tpu_torch.probes.int8_prims [--device cpu]

On the CPU (``--device cpu``) each wrapper runs its plain version, so the
run checks only the control flow; the probes are of the card.
"""

import argparse
import ctypes
import functools
import sys
from typing import NamedTuple

import torch

from csmri_refinement_tpu_torch.ops import native

R, L = 256, 128      # the TPU probes' tile: rows (sublanes) x lanes
SWIZZLE_MODES = {0: 0, 128: 1}   # swizzle bytes: descriptor mode


class Result(NamedTuple):
  name: str
  status: str          # 'OK', 'WRONG NUMERICS' or 'FAIL: <reason>'
  max_abs_err: float   # max |kernel - plain|, or nan when the probe failed


@functools.lru_cache(maxsize=None)
def lib():
  out = native.library('probes')
  descs = [ctypes.c_uint64] * 2
  out.probe_bf16.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, *descs, ctypes.c_void_p]
  out.probe_bf16.restype = ctypes.c_int
  out.probe_int8.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
      ctypes.c_int, *descs, ctypes.c_void_p]
  out.probe_int8.restype = ctypes.c_int
  return out


def descriptor(lbo, sbo, swizzle=0):
  """The layout fields of a ``wgmma`` shared-memory matrix descriptor, its
  start address left 0: the leading and stride byte offsets (LBO, SBO; in
  16-byte units at bits 16-29 and 32-45) and the swizzle mode (bits
  62-63) for ``swizzle`` bytes."""
  return (lbo >> 4) << 16 | (sbo >> 4) << 32 | SWIZZLE_MODES[swizzle] << 62


def check(name, got, want, atol):
  """Compare a probe's output with its plain version."""
  if got.shape != want.shape or got.dtype != want.dtype:
    return Result(name, 'WRONG NUMERICS', float('nan'))
  err = (got.double() - want.double()).abs().max().item()
  return Result(name, 'OK' if err <= atol else 'WRONG NUMERICS', err)


def run_probe(name, kernel, plain, inputs, atol):
  """Run one probe: ``kernel(*inputs)`` (the wrapper) against
  ``plain(*inputs)``. An exception is reported as a FAIL result."""
  try:
    got = kernel(*inputs)
    if got.is_cuda:
      torch.cuda.synchronize(got.device)
    return check(name, got, plain(*inputs), atol)
  except Exception as e:      # reported; main() and chip_smoke.py fail on it
    return Result(name, 'FAIL: ' + str(e).split('\n')[0][:110],
                  float('nan'))


def print_results(results):
  for r in results:
    print('{:38s} {}'.format(r.name, r.status), flush=True)


def main(run_all, description, argv=None, on_card=None):
  """CLI of a probe module: run every probe, print, exit 1 unless all OK;
  then, on the card, call ``on_card()``."""
  parser = argparse.ArgumentParser(description=description)
  parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
  args = parser.parse_args(argv)
  if args.device == 'cuda' and not torch.cuda.is_available():
    sys.exit('no CUDA device: the probes are of the card (--device cpu '
             'runs the plain versions)')
  if args.device == 'cuda':
    print(torch.cuda.get_device_name(0), flush=True)
  results = run_all(args.device)
  print_results(results)
  if not all(r.status == 'OK' for r in results):
    sys.exit(1)
  if args.device == 'cuda' and on_card is not None:
    on_card()
  return results
