"""Summarize per-slice metric CSVs across runs (the port's CLI).

    python -m csmri_refinement_tpu_torch.summarize_results CSV [CSV ...]
        [--metric-name NAMES] [--format plain|latex|csv] [-p N] [--no-std]
        [--percentiles] [--stest wilcoxon|ttest] [--slvl P] [--diff]
        [--pvalues] [--sis-gt-perf X] [-o KEYS] [-f KEYS] [--no-name] [-v]

Port of the JAX package's ``summarize_results.py`` (``:51-291``) without
pandas, which the port does not import: the CSVs are read with ``csv``,
the tables are rows of numbers, and every output is the JAX CLI's, string
for string. The last step of the evaluation funnel after
``eval_results``:

* repeat runs of one experiment (``<prefix>_<name>_<date>.csv``) form a
  group, every other file a group of its own;
* per group: the mean over its runs' means, the mean of their standard
  deviations, the run and slice counts and the percentiles of the per-slice
  mean over the runs;
* ``--stest``: the pairwise Wilcoxon or paired-t p-values between groups;
  a group is significant (``*``) when it beats every other at ``--slvl``;
  ``--pvalues`` prints the matrix;
* ``segscore`` metrics are divided by ``REC_DICE_GT`` (SIS);
* plain text, LaTeX (the best group bold) or CSV; with two groups the
  difference row (in CSV only with ``--diff``);
* ``--order`` keeps, for each key in turn, the first group containing it;
  ``--filter`` drops every group containing one of its keys; ``--no-name``
  leaves out the group names; ``-v`` lists each CSV's columns and each
  group's runs.
"""

import argparse
import csv
import math
import os
import re
import sys
from collections import OrderedDict

import numpy as np
from scipy.stats import ttest_rel, wilcoxon

# Dice of the segmentation network on ground-truth reconstructions: the SIS
# normalizer (JAX ``summarize_results.py:47``).
REC_DICE_GT = 0.7964832518779061

_RUN_NAME = re.compile(r'.+_(.+)_\d\d\d\d.+')
_HIGHER_IS_BETTER = ('dice', 'psnr', 'ssim', 'segscore', 'accuracy')
# The strings pandas' read_csv reads as missing values
_NA = {'', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
       '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None',
       'n/a', 'nan', 'null'}
DIFF = 'diff'


def higher_is_better(metric):
  return any(m in metric.lower() for m in _HIGHER_IS_BETTER)


def _read_csv(path):
  """(column names as pandas names them, rows)."""
  with open(path, newline='') as f:
    rows = list(csv.reader(f))
  header = [name or 'Unnamed: {}'.format(i)
            for i, name in enumerate(rows[0])] if rows else []
  return header, rows[1:]


def load_metric_samples(csv_paths, metric):
  """One metric column per CSV, missing values dropped →
  OrderedDict{basename: float64 array}."""
  samples = OrderedDict()
  for path in csv_paths:
    header, rows = _read_csv(path)
    if metric not in header:
      raise KeyError('{} has no column {!r} (has: {})'.format(
          path, metric, ', '.join(header)))
    col = header.index(metric)
    values = [float(row[col]) for row in rows
              if col < len(row) and row[col].strip() not in _NA]
    samples[os.path.basename(path)] = np.asarray(
        [v for v in values if not math.isnan(v)], np.float64)
  return samples


def group_runs(run_names):
  """Repeat runs grouped by experiment name → OrderedDict{group: [runs]}."""
  groups = OrderedDict()
  for run in run_names:
    m = _RUN_NAME.match(run)
    key = m.group(1) if m else os.path.splitext(run)[0]
    groups.setdefault(key, []).append(run)
  return groups


def _group_samples(samples, groups):
  """Per-slice metric averaged over a group's repeat runs."""
  out = OrderedDict()
  for name, runs in groups.items():
    arrays = [samples[r] for r in runs]
    lengths = {len(a) for a in arrays}
    if len(lengths) != 1:
      raise ValueError('Repeat runs of {} have differing slice counts '
                       '{}'.format(name, sorted(lengths)))
    out[name] = np.mean(arrays, axis=0)
  return out


def significance_matrix(grouped, mode='wilcoxon'):
  """Pairwise paired-test p-values → (group names, symmetric matrix with
  ones on the diagonal)."""
  test = {'wilcoxon': wilcoxon, 'ttest': ttest_rel}[mode]
  names = list(grouped)
  mat = np.ones((len(names), len(names)))
  for i, a in enumerate(names):
    for j in range(i + 1, len(names)):
      mat[i, j] = mat[j, i] = test(grouped[a], grouped[names[j]]).pvalue
  return names, mat


def apply_group_selection(groups, order=None, exclude=None):
  """``exclude`` drops groups whose name contains any of its substrings;
  ``order`` keeps, for each key, the first group containing it."""
  if exclude:
    groups = OrderedDict((n, r) for n, r in groups.items()
                         if not any(key in n for key in exclude))
  if order:
    picked = OrderedDict()
    for key in order:
      for name in groups:
        if key in name and name not in picked:
          picked[name] = groups[name]
          break
    groups = picked
  return groups


class Table:
  """The summary: ``columns`` and ``rows`` (OrderedDict{group: {column:
  value}}); a value missing from a row is NaN."""

  def __init__(self, columns, rows):
    self.columns = columns
    self.rows = rows

  def value(self, name, column):
    return self.rows[name].get(column, float('nan'))

  def to_csv(self):
    """pandas' ``DataFrame.to_csv``: floats by ``repr``, NaN empty; a
    column that has a NaN (the diff row) shows its numbers as floats."""
    def cell(value, as_float):
      if isinstance(value, float) and math.isnan(value):
        return ''
      if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
      return repr(float(value)) if as_float else str(value)

    missing = {c for c in self.columns
               if any(c not in row for row in self.rows.values())}
    lines = [','.join(['group'] + self.columns)]
    for name, row in self.rows.items():
      lines.append(','.join([name] + [
          cell(self.value(name, c),
               c in missing or isinstance(self.value(name, c), float))
          for c in self.columns]))
    return '\n'.join(lines) + '\n'


def summarize(csv_paths, metric, percentiles=(0, 25, 50, 75, 100),
              sis_gt_perf=REC_DICE_GT, stest_mode=None,
              significance_level=0.05, with_diff=True, order=None,
              exclude=None):
  """The summary ``Table`` of one metric: per group ``mean, std, n_runs,
  n_slices, p<percentiles...`` and ``significant`` under a test mode."""
  samples = load_metric_samples(csv_paths, metric)
  groups = apply_group_selection(group_runs(samples), order, exclude)
  grouped = _group_samples(samples, groups)
  pcols = ['p{:g}'.format(p) for p in percentiles]
  columns = ['mean', 'std', 'n_runs', 'n_slices'] + pcols
  rows = OrderedDict()
  for name, values in grouped.items():
    runs = groups[name]
    row = {'mean': float(np.mean([samples[r].mean() for r in runs])),
           'std': float(np.mean([samples[r].std() for r in runs])),
           'n_runs': len(runs), 'n_slices': len(values)}
    row.update(zip(pcols, (float(v) for v in
                           np.percentile(values, percentiles))))
    rows[name] = row

  if 'segscore' in metric.lower():
    for row in rows.values():
      for col in ['mean', 'std'] + pcols:
        row[col] = row[col] / sis_gt_perf

  if stest_mode and len(grouped) > 1:
    names, pvals = significance_matrix(grouped, stest_mode)
    columns.append('significant')
    for i, name in enumerate(names):
      rows[name]['significant'] = bool(
          (np.delete(pvals[i], i) < significance_level).all())

  if len(grouped) == 2 and with_diff:
    first, second = rows.values()
    rows[DIFF] = {c: first[c] - second[c] for c in ['mean', 'std'] + pcols}
  return Table(columns, rows)


def format_table(table, metric, fmt='plain', precision=None, show_std=True,
                 show_percentiles=False, show_name=True):
  """Plain text, LaTeX (best group bold, * = significant) or CSV."""
  if precision is None:
    precision = 3 if higher_is_better(metric) and 'psnr' not in metric \
        else 2
  if fmt == 'csv':
    return table.to_csv()
  means = [(name, row['mean']) for name, row in table.rows.items()
           if name != DIFF]
  pick = max if higher_is_better(metric) else min
  best = pick(means, key=lambda item: item[1])[0]
  num = '{{:.{}f}}'.format(precision).format
  width = max(len(str(name)) for name in table.rows) + 2
  percs = [c for c in table.columns if c.startswith('p')]
  lines = []
  for name in table.rows:
    # the diff row's NaN is true, as in the pandas row it mirrors
    significant = table.value(name, 'significant') \
        if 'significant' in table.columns else False
    star = '*' if significant else ''
    value = num(table.value(name, 'mean')) + star
    if show_std:
      value += (r' \pm ' if fmt == 'latex' else ' +- ') + \
          num(table.value(name, 'std'))
    if fmt == 'latex':
      if name == best:
        value = r'\mathbf{{{}}}'.format(value)
      value = '${}$'.format(value)
    line = '{:{w}}{}'.format(name, value, w=width) if show_name else value
    if show_percentiles:
      line += '   [' + '/'.join(num(table.value(name, c))
                                for c in percs) + ']'
    lines.append(line)
  return '\n'.join(lines)


def _float_column(values):
  """A float column as pandas prints it: 6 decimals, the zeros every value
  ends in trimmed (one decimal kept), NaN as 'NaN'."""
  texts = ['{:.6f}'.format(v) for v in values if not math.isnan(v)]
  trim = min((len(t) - len(t.rstrip('0')) for t in texts), default=0)
  trim = min(trim, 5)
  return ['NaN' if math.isnan(v) else '{:.6f}'.format(v)[:len(
      '{:.6f}'.format(v)) - trim] for v in values]


def format_matrix(names, mat):
  """A square float matrix as pandas prints a DataFrame."""
  cols = [_float_column(mat[:, j]) for j in range(len(names))]
  index_w = max(len(n) for n in names)
  widths = [max(len(name), max(len(v) for v in col))
            for name, col in zip(names, cols)]
  lines = [' ' * index_w + ''.join('  ' + name.rjust(w)
                                   for name, w in zip(names, widths))]
  for i, name in enumerate(names):
    lines.append(name.ljust(index_w) + ''.join(
        '  ' + col[i].rjust(w) for col, w in zip(cols, widths)))
  return '\n'.join(lines)


def build_parser():
  parser = argparse.ArgumentParser(
      description='Summarize per-slice metric CSVs across runs')
  parser.add_argument('inputs', nargs='+', help='metric CSV files')
  parser.add_argument('--metric-name', default='dice_avg',
                      help='comma-separated metric column(s)')
  parser.add_argument('--format', choices=('plain', 'latex', 'csv'),
                      default='plain')
  parser.add_argument('-p', '--precision', type=int, default=None)
  parser.add_argument('--no-std', action='store_true')
  parser.add_argument('--percentiles', action='store_true',
                      help='append percentile columns to the output')
  parser.add_argument('--stest', choices=('wilcoxon', 'ttest'), default=None,
                      help='pairwise significance test between groups')
  parser.add_argument('--slvl', type=float, default=0.05,
                      help='significance level')
  parser.add_argument('--diff', action='store_true',
                      help='include the two-group difference row in csv '
                           'output (always on for plain/latex; the row '
                           'leaves n_runs/n_slices/significant empty)')
  parser.add_argument('--pvalues', action='store_true',
                      help='also print the pairwise p-value matrix')
  parser.add_argument('--sis-gt-perf', type=float, default=REC_DICE_GT,
                      help='GT-reconstruction dice used to normalize '
                           'segscore into SIS')
  parser.add_argument('-o', '--order', default=None,
                      help='comma-separated keys; output keeps the first '
                           'group containing each key, in key order')
  parser.add_argument('-f', '--filter', default=None, dest='filter_keys',
                      help='comma-separated substrings; groups containing '
                           'any are EXCLUDED (reference semantics)')
  parser.add_argument('--no-name', action='store_true',
                      help='do not print leading group names')
  parser.add_argument('-v', '--verbose', action='store_true',
                      help='list CSV columns and per-group run membership')
  return parser


def main(argv):
  args = build_parser().parse_args(argv)
  csvs = [p for p in args.inputs if p.endswith('.csv')]
  order = args.order.split(',') if args.order else None
  exclude = args.filter_keys.split(',') if args.filter_keys else None

  if args.verbose:
    for path in csvs:
      print('Available columns in {}'.format(path))
      print(_read_csv(path)[0])
    groups = apply_group_selection(
        group_runs([os.path.basename(p) for p in csvs]), order, exclude)
    for name, runs in groups.items():
      print('{}: {}'.format(name, ', '.join(runs)))
    print()

  for metric in args.metric_name.split(','):
    print(metric)
    table = summarize(csvs, metric, sis_gt_perf=args.sis_gt_perf,
                      stest_mode=args.stest,
                      significance_level=args.slvl,
                      with_diff=args.format != 'csv' or args.diff,
                      order=order, exclude=exclude)
    print(format_table(table, metric, fmt=args.format,
                       precision=args.precision,
                       show_std=not args.no_std,
                       show_percentiles=args.percentiles,
                       show_name=not args.no_name))
    if args.pvalues and args.stest:
      samples = load_metric_samples(csvs, metric)
      names, mat = significance_matrix(
          _group_samples(samples, group_runs(samples)), args.stest)
      print('\npairwise {} p-values:'.format(args.stest))
      print(format_matrix(names, np.round(mat, 4)))
    print()


if __name__ == '__main__':
  main(sys.argv[1:])
