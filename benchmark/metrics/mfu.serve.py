"""The served forward's operations a request times the requests completed
in the traced run's first half (without the profiler), over that
window's seconds and the configuration's peak (bf16), in %."""


def read(run):
  return run.mfu()
