"""The port's ``summarize_results`` CLI and its statistics against the
JAX package's, on seeded CSVs.

The port reads the CSVs without pandas; every output must be the JAX
CLI's string for string, numbers within 1e-12 (numpy's and pandas'
means may part in the last bit): each ``--format``, ``--order``,
``--filter``, ``--no-name``, ``-v``, both tests, ``--pvalues``, the SIS
normalisation and the two-group difference row.
"""

import contextlib
import io
import re

import numpy as np
import pytest

import summarize_results as jsummarize
from csmri_refinement_tpu.data import statistics as jstatistics
from csmri_refinement_tpu_torch import summarize_results as tsummarize
from csmri_refinement_tpu_torch.data import statistics as tstatistics

NUMBER = re.compile(r'-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+e[-+]?\d+|\bnan\b')
RUNS = ('eval_base_2024-01-01', 'eval_base_2024-01-02',
        'eval_ours_2024-01-01', 'eval_other_2024-02-01', 'single')
SLICES = 24


@pytest.fixture(scope='module')
def csvs(tmp_path_factory):
  """Five seeded per-slice CSVs in the eval_results layout (an unnamed
  index column first), a few missing values in ``ssim``."""
  root = tmp_path_factory.mktemp('summaries')
  rng = np.random.RandomState(0)
  paths = []
  for k, run in enumerate(RUNS):
    shift = 0.02 * k
    cols = {'psnr': 30 + 2 * rng.randn(SLICES) + 10 * shift,
            'ssim': 0.8 + 0.05 * rng.randn(SLICES) + shift,
            'segscore': 0.6 + 0.1 * rng.rand(SLICES) + shift,
            'dice_avg': 0.7 + 0.1 * rng.rand(SLICES) - shift}
    path = root / (run + '.csv')
    with open(path, 'w') as f:
      f.write(',' + ','.join(cols) + '\n')
      for i in range(SLICES):
        cells = ['case{}_{:02d}'.format(i // 4, i % 4)]
        for name, values in cols.items():
          missing = name == 'ssim' and i % 7 == 3 and k == 4
          cells.append('' if missing else repr(float(values[i])))
        f.write(','.join(cells) + '\n')
    paths.append(str(path))
  return paths


def _run(main, argv):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    main(argv)
  return out.getvalue()


def _assert_same_output(got, want):
  assert NUMBER.sub('#', got) == NUMBER.sub('#', want), (got, want)
  np.testing.assert_allclose(
      [float(x) for x in NUMBER.findall(got)],
      [float(x) for x in NUMBER.findall(want)], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('args', [
    [],
    ['--metric-name', 'psnr,ssim', '--format', 'latex'],
    ['--metric-name', 'psnr,ssim,dice_avg', '--format', 'csv'],
    ['--metric-name', 'psnr', '--format', 'csv', '--diff', '-o',
     'ours,base', '--stest', 'wilcoxon'],
    ['--metric-name', 'dice_avg', '--stest', 'ttest', '--pvalues',
     '--percentiles'],
    ['--metric-name', 'psnr', '--stest', 'wilcoxon', '--pvalues', '--no-std',
     '-p', '4'],
    ['--metric-name', 'dice_avg', '-o', 'ours,base', '--stest', 'wilcoxon'],
    ['--metric-name', 'psnr', '-o', 'single,ours', '--format', 'latex',
     '--stest', 'ttest', '--slvl', '0.5'],
    ['--metric-name', 'ssim', '-f', 'other,single', '--no-name'],
    ['--metric-name', 'segscore', '--percentiles'],
    ['--metric-name', 'segscore', '--sis-gt-perf', '0.8', '--format', 'csv',
     '--stest', 'ttest'],
    ['-v', '--metric-name', 'psnr', '-f', 'single'],
], ids=lambda a: ' '.join(a) or 'defaults')
def test_cli_output_equals_jax(csvs, args):
  argv = csvs + args
  _assert_same_output(_run(tsummarize.main, argv),
                      _run(jsummarize.main, argv))


def test_cli_refuses_a_missing_column_as_jax(csvs):
  for main in (tsummarize.main, jsummarize.main):
    with pytest.raises(KeyError, match='no column'):
      _run(main, csvs + ['--metric-name', 'hfen'])


def test_complex_psnr_and_wilcoxon_equal_jax():
  rng = np.random.RandomState(3)
  x = rng.randn(8, 8) + 1j * rng.randn(8, 8)
  y = x + 0.05 * (rng.randn(8, 8) + 1j * rng.randn(8, 8))
  for peak in ('normalized', 'max'):
    assert tstatistics.complex_psnr(x, y, peak) == pytest.approx(
        jstatistics.complex_psnr(x, y, peak), rel=1e-12)
  a, b = rng.rand(20), rng.rand(20)
  want = jstatistics.compute_wilcoxon(a, b)
  for got in (tstatistics.compute_wilcoxon(a, b),
              tstatistics.compute_wilcoxon(dict(enumerate(a)),
                                           dict(enumerate(b)))):
    assert got.statistic == want.statistic
    assert got.pvalue == pytest.approx(want.pvalue, rel=1e-12)
