"""Slices returned in the window over the window's seconds."""


def read(run):
  return run.record.units / run.record.window_s
