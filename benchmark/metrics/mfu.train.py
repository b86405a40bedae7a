"""The train step's operations times the steps completed in the traced
run's first half (without the profiler), over that window's seconds and
the configuration's peak (TF32), in %."""


def read(run):
  return run.mfu()
