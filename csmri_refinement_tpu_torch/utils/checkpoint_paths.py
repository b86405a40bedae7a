"""Timestamped run-dir and checkpoint path builders.

Port (a copy: pure Python) of ``csmri_refinement_tpu/utils/
checkpoint_paths.py``: run dirs ``{run_name}_{time}``, periodic checkpoints
``periodic-chkpt_{time}_{epoch}.ckpt``, best checkpoints
``best-chkpt_{time}_{epoch}_{metric:.4f}.ckpt``, config snapshots
``config_{time}.json``, with a numeric suffix when a path exists.
"""

import os
import re
from datetime import datetime

CHKPT_EXT = 'ckpt'
CHKPT_REGEXP = re.compile(r'.+\.{}(\.[\d]+)?$'.format(CHKPT_EXT))

_FMT_RUN_DIR = '{run_name}_{time}'
_FMT_PERIODIC_CHKPT = 'periodic-chkpt_{time}_{epoch}.' + CHKPT_EXT
_FMT_BEST_CHKPT = 'best-chkpt_{time}_{epoch}_{metric:.4f}.' + CHKPT_EXT
_FMT_CONFIG = 'config_{time}.json'


def get_time_string(now=None):
  now = now or datetime.now()
  return '{:04d}-{:02d}-{:02d}-{:02d}-{:02d}-{:02d}'.format(
      now.year, now.month, now.day, now.hour, now.minute, now.second)


def _get_path(base_dir, format_str, **kwargs):
  kwargs.setdefault('time', get_time_string())
  base_path = os.path.join(base_dir, format_str.format(**kwargs))

  # Ensure uniqueness with a numeric suffix.
  path, idx = base_path, 2
  while os.path.exists(path):
    path = '{}.{}'.format(base_path, idx)
    idx += 1
  return path


def get_run_dir(base_dir, run_name):
  return _get_path(base_dir, _FMT_RUN_DIR, run_name=run_name)


def get_config_path(run_dir):
  return _get_path(run_dir, _FMT_CONFIG)


def get_periodic_checkpoint_path(run_dir, epoch):
  return _get_path(run_dir, _FMT_PERIODIC_CHKPT, epoch=epoch)


def get_best_checkpoint_path(best_dir, epoch, metric):
  return _get_path(best_dir, _FMT_BEST_CHKPT, epoch=epoch, metric=metric)


def is_checkpoint_path(path):
  return CHKPT_REGEXP.match(path) is not None
