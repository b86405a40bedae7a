"""Time a request waited between when it was due and when the server began
it: the mean over the traced run's first half, which runs without the
profiler, in milliseconds."""

import statistics


def read(run):
  if not run.record.wait:
    return None
  return statistics.fmean(run.record.wait) * 1e3
