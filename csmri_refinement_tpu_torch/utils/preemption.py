"""Cooperative preemption: SIGTERM → checkpoint at the epoch boundary → exit.

Port (a copy) of ``csmri_refinement_tpu/utils/preemption.py``. A cluster
scheduler sends SIGTERM with a grace window before it takes a card away;
the handler only sets a flag (a save from inside the handler could capture
a step's update half done), and ``train.py::train_net`` checks the flag at
each epoch boundary, saves a periodic checkpoint for the next epoch and
returns, so the process exits 0. ``--resume`` with that checkpoint
continues at the next epoch as after a planned stop. SIGINT stays a
``KeyboardInterrupt`` (an immediate stop).
"""

import logging
import signal
import threading

_requested = threading.Event()

#: Signals treated as a preemption notice.
SIGNALS = (signal.SIGTERM,)


def requested():
  """True once a preemption signal arrived."""
  return _requested.is_set()


def request(signum=None, frame=None):
  """Flag a preemption (the signal handler; callable directly)."""
  logging.warning('Preemption requested (signal %s): will checkpoint and '
                  'stop at the next epoch boundary', signum)
  _requested.set()


def reset():
  _requested.clear()


def install():
  """Install the handler; returns {signal: previous handler}.

  Installs nothing (returns {}) off the main thread, where CPython forbids
  ``signal.signal``.
  """
  previous = {}
  for sig in SIGNALS:
    try:
      previous[sig] = signal.signal(sig, request)
    except ValueError:  # not the main thread
      logging.debug('Not installing preemption handler for %s '
                    '(non-main thread)', sig)
  return previous
