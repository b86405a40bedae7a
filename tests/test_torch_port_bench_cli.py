"""The port's benchmark command, ``python -m
csmri_refinement_tpu_torch.bench``, on the CPU.

* Its output contract, as ``tests/test_cli.py`` holds the JAX tool to it:
  one JSON line on stdout, one bare JSON line in stdout and stderr merged,
  ``extra:`` rows without errors, ``budget_exceeded`` past the budget; with
  no card (and no ``--platform cpu``) an error record of stage
  ``preflight``, and a failed headline an error record of stage
  ``measure``, both with a non-zero exit and no fallback.
* Its watchdog parent imports no torch.
* The training rows' functions each write their two rows.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from csmri_refinement_tpu_torch import bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, '-m', 'csmri_refinement_tpu_torch.bench']


def _json_lines(text):
  out = []
  for line in text.strip().splitlines():
    try:
      out.append(json.loads(line))
    except ValueError:
      pass
  return out


def _run(args, timeout=240):
  return subprocess.run(CLI + args, capture_output=True, text=True, cwd=REPO,
                        timeout=timeout)


def test_bench_stdout_contract():
  out = _run(['--platform', 'cpu', '--batch-size', '2', '--image-size', '32',
              '--iters', '2', '--warmup', '1', '--extra-sizes', '48',
              '--latency', '--components'])
  assert out.returncode == 0, out.stderr[-3000:]
  lines = [l for l in out.stdout.strip().splitlines() if l.strip()]
  assert len(lines) == 1, out.stdout
  rec = json.loads(lines[0])
  assert rec == {'metric': '32x32 recon slices/sec/chip (cascade+refine '
                           'inference, bf16 compute)',
                 'value': rec['value'], 'unit': 'slices/s'}
  assert rec['value'] > 0
  # stdout and stderr merged hold exactly one bare JSON line: the headline
  assert _json_lines(out.stdout + '\n' + out.stderr) == [rec]
  rows = [json.loads(l[len('extra: '):]) for l in out.stderr.splitlines()
          if l.startswith('extra: ')]
  assert [r['metric'] for r in rows] == [
      '32x32 recon batch-1 serving latency (bf16 compute)',
      '48x48 recon batch-1 serving latency (bf16 compute)',
      '48x48 recon slices/sec/chip (cascade+refine inference, bf16 '
      'compute)']
  for row in rows:
    assert 'error' not in row and row['value'] > 0, row
  assert [r['unit'] for r in rows] == ['ms/slice', 'ms/slice', 'slices/s']
  components = [l.split()[1] for l in out.stderr.splitlines()
                if l.startswith('component ')]
  assert components == ['recnet', 'refinement', 'dc'], out.stderr

  # past the budget: still one line, a structured error record
  out = _run(['--platform', 'cpu', '--budget', '2'], timeout=120)
  lines = [l for l in out.stdout.strip().splitlines() if l.strip()]
  assert len(lines) == 1, out.stdout
  rec = json.loads(lines[0])
  assert out.returncode != 0
  assert rec['error'] == 'budget_exceeded'
  assert 'stage' in rec and 'metric' in rec


def test_bench_without_card_is_a_preflight_error():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  out = _run(['--batch-size', '2', '--image-size', '32', '--iters', '2',
              '--warmup', '1', '--extra-sizes'], timeout=120)
  assert out.returncode != 0
  lines = [l for l in out.stdout.strip().splitlines() if l.strip()]
  assert len(lines) == 1, out.stdout
  rec = json.loads(lines[0])
  assert set(rec) == {'metric', 'error', 'stage', 'unit'}
  assert rec['stage'] == 'preflight' and 'CUDA' in rec['error']
  assert _json_lines(out.stdout + '\n' + out.stderr) == [rec]


def test_failed_headline_has_no_fallback():
  # 30 is no side of the flagship: the headline fails, in its own dtype
  # and batch, and nothing else is measured
  out = _run(['--platform', 'cpu', '--batch-size', '2', '--image-size', '30',
              '--dtype', 'int8', '--latency', '--extra-sizes', '32'],
             timeout=120)
  assert out.returncode != 0
  rec = json.loads(out.stdout.strip())
  assert rec['stage'] == 'measure'
  assert rec['metric'] == ('30x30 recon slices/sec/chip (cascade+refine '
                           'inference, int8 compute)')
  assert 'multiple of 4' in rec['error']
  assert 'vs_baseline' not in rec and 'value' not in rec
  assert 'extra: ' not in out.stderr


def test_parent_imports_no_torch():
  code = ('import sys; import csmri_refinement_tpu_torch.bench; '
          'bad = [m for m in sys.modules if m.split(".")[0] in ("torch", '
          '"numpy", "jax")]; assert not bad, bad')
  subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                 timeout=60)


def _rows(text):
  return [json.loads(l[len('extra: '):]) for l in text.splitlines()
          if l.startswith('extra: ')]


def test_training_rows(capsys):
  bench.run_standard_train_bench(32, 2, 1, device='cpu', steps_per_fetch=2)
  # the discriminator's 4×4 head needs a side of 128
  bench.run_train_bench(128, 1, 1, device='cpu', steps_per_fetch=2)
  rows = _rows(capsys.readouterr().err)
  assert [r['metric'] for r in rows] == [
      '32x32 RecNet train samples/sec/chip (configs/1 recipe, per-step '
      'fetch)',
      '32x32 RecNet train samples/sec/chip (steps_per_fetch=2 scan)',
      '128x128 GAN train samples/sec/chip (flagship recipe, D-then-G step)',
      '128x128 GAN train samples/sec/chip (steps_per_fetch=2 scan)']
  for row in rows:
    assert row['value'] > 0 and row['unit'] == 'samples/s', row
