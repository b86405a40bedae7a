"""The primitive probes' plain versions (K4, K5) against numpy, on the CPU.

Each probe's plain PyTorch version is the oracle its kernel is held to on
the card (``chip_smoke.py``, ``tests/test_torch_port_cuda.py``); here it is
held to a numpy statement of the TPU probe's reference
(``scripts/probe_mosaic_prims.py``, ``scripts/probe_int8_prims.py``),
exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from csmri_refinement_tpu_torch.probes import int8_prims
from csmri_refinement_tpu_torch.probes import mosaic_prims

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, L = 256, 128


def _scratch_chain(x):
  s = np.zeros((R + 16, L), np.float32)
  s[8:8 + R] = x
  s[0:8] = s[8:16]
  return s[1:1 + R] * 2


MOSAIC_REFS = {   # the TPU probe's numpy/jnp reference of each
    'lane roll bf16 by 32': lambda x: np.roll(x, 32, axis=1),
    'lane roll bf16 as 32-bit pairs': lambda x: np.roll(x, 32, axis=1),
    'row roll bf16 by 1': lambda x: np.roll(x, 1, axis=0),
    'unaligned row read': lambda x: x[1:R - 15],
    'unaligned row write': lambda x: np.pad(x[:R - 16], ((1, 15), (0, 0))),
    'bf16 where(iota) select': lambda x: np.where(np.arange(L)[None] < 32,
                                                  x * 2, x),
    'strided mid-dim read': lambda x: x[:, 3, :],
    'scratch write+unaligned read': _scratch_chain,
    'pair roll by 64 on 250-row tile': lambda x: np.roll(x, 64, axis=1),
    'wgmma bf16 A descriptor at odd pixel': lambda x: x.reshape(-1, 16)[1:-15],
}


@pytest.mark.parametrize('name', sorted(MOSAIC_REFS))
def test_mosaic_probe_plain_matches_numpy(name):
  _, in_shape, out_shape, out_dtype, _ = mosaic_prims.PROBES[name]
  x = mosaic_prims.probe_input(in_shape, 'cpu')
  got = mosaic_prims.plain(name, x)
  assert tuple(got.shape) == out_shape and got.dtype == out_dtype
  want = MOSAIC_REFS[name](x.float().numpy())
  np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                             atol=mosaic_prims.ATOL)


def _requant(f):
  s = np.float32(127.0) / np.maximum(np.abs(f).max(), np.float32(1e-8))
  return np.clip(np.round(f * s), -127, 127)


INT8_REFS = {
    's8 x s8 -> s32 mma': lambda a, b: a.astype(np.int64) @ b,
    'int8 lane roll via 32-bit words': lambda a: np.roll(a, 32, axis=1),
    'int8 where(iota) select': lambda a: np.where(np.arange(L)[None] < 32,
                                                  a, 0),
    'f32 -> int8 dynamic requant': _requant,
    's8 mma + f32 dequant': lambda a, b: (a.astype(np.int64) @ b).astype(
        np.float32) * np.float32(0.01),
}


@pytest.mark.parametrize('name', sorted(INT8_REFS))
def test_int8_probe_plain_matches_numpy(name):
  _, out_dtype, keys, _ = int8_prims.PROBES[name]
  data = int8_prims.probe_inputs('cpu')
  inputs = [data[k] for k in keys]
  got = int8_prims.plain(name, *inputs)
  assert tuple(got.shape) == (R, L) and got.dtype == out_dtype
  want = INT8_REFS[name](*[t.numpy() for t in inputs])
  np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                             atol=int8_prims.ATOL)


def test_int8_probe_inputs_cover_the_range():
  """The TPU probe's draw: int8 in -127..127 (never -128), f32 randn·3."""
  data = int8_prims.probe_inputs('cpu')
  assert data['a'].min().item() == -127 and data['a'].max().item() == 127
  assert data['b'].min().item() >= -127
  assert 2.5 < data['f'].std().item() < 3.5


@pytest.mark.parametrize('module', [mosaic_prims, int8_prims],
                         ids=['mosaic', 'int8'])
def test_probes_run_all_on_cpu(module):
  results = module.run_all('cpu')
  assert len(results) == len(module.PROBES)
  assert all(r.status == 'OK' and r.max_abs_err == 0 for r in results)
  assert module.probe_cuda.launches == 0


def test_probe_reports_failure_and_wrong_numerics():
  from csmri_refinement_tpu_torch import probes
  x = torch.zeros(4)

  def boom(t):
    raise RuntimeError('refused\nsecond line')
  assert probes.run_probe('p', boom, lambda t: t, [x], 0).status == \
      'FAIL: refused'
  wrong = probes.run_probe('p', lambda t: t + 1, lambda t: t, [x], 1e-6)
  assert wrong.status == 'WRONG NUMERICS' and wrong.max_abs_err == 1


def test_probe_cli_exit_codes():
  env = dict(os.environ, PYTHONPATH=REPO)
  ok = subprocess.run([sys.executable, '-m',
                       'csmri_refinement_tpu_torch.probes.int8_prims',
                       '--device', 'cpu'], cwd=REPO, env=env,
                      capture_output=True, text=True, timeout=120)
  assert ok.returncode == 0, ok.stderr
  assert ok.stdout.count(' OK') == len(int8_prims.PROBES)
  if not torch.cuda.is_available():
    card = subprocess.run([sys.executable, '-m',
                           'csmri_refinement_tpu_torch.probes.mosaic_prims'],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert card.returncode != 0 and ' OK' not in card.stdout
