"""Console and run-dir file logging.

Port (a copy) of ``csmri_refinement_tpu/utils/logging.py``: the root
logger gets a stream handler on stdout and, given a directory, a file
``log_{mode}.txt`` (``log_{mode}_{time}.txt`` with ``time_string``) there.
Handlers set up before are removed, so a second call does not log twice.
"""

import logging
import os
import sys


def setup_logging(run_dir=None, mode='train', time_string=None,
                  verbose=False):
  root = logging.getLogger()
  root.setLevel(logging.DEBUG if verbose else logging.INFO)
  for handler in list(root.handlers):
    root.removeHandler(handler)
    handler.close()

  fmt = logging.Formatter('%(asctime)s %(levelname)s: %(message)s',
                          datefmt='%Y-%m-%d %H:%M:%S')
  stream = logging.StreamHandler(sys.stdout)
  stream.setFormatter(fmt)
  root.addHandler(stream)

  if run_dir is not None:
    os.makedirs(run_dir, exist_ok=True)
    name = 'log_{}_{}.txt'.format(mode, time_string) if time_string \
        else 'log_{}.txt'.format(mode)
    file_handler = logging.FileHandler(os.path.join(run_dir, name))
    file_handler.setFormatter(fmt)
    root.addHandler(file_handler)
  return root
