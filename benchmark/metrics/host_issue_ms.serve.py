"""Host time of a request from its call to its return, before the
synchronize: the mean over the traced run's first half, which runs
without the profiler, in milliseconds."""

import statistics


def read(run):
  if not run.record.issue:
    return None
  return statistics.fmean(run.record.issue) * 1e3
