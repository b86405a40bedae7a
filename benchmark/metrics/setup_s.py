"""Set-up: from the process's start to the first timed call, in seconds
(imports, the kernels' build or load, weights, the pool, the warm-up)."""


def read(run):
  return run.setup_s
