"""The 95th percentile of every request's latency in the window, from when
it was due to the synchronize that ends it, in milliseconds (of a window
with one request, its latency)."""

import statistics


def read(run):
  latency = run.record.latency
  if not latency:
    return None
  if len(latency) == 1:
    return latency[0] * 1e3
  return statistics.quantiles(latency, n=20)[18] * 1e3
