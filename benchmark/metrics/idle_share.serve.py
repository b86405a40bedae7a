"""The traced window's share in which no operation ran on the device, in %:
1 − (the union of the device operations' intervals) / (the window)."""


def read(run):
  return run.idle_share()
