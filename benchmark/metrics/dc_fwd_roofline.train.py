"""The train step's forward data-consistency steps' share of their
roofline, in %: the least time of a DC (28 bytes a pixel at the memory's peak, or its FFTs'
operations at the f32 peak, the larger) over the device time of the
operations launched inside the ``bench.dc`` ranges around each call."""


def read(run):
  return run.roofline('dc', run.work['dc_flops'], run.work['dc_bytes'], 'f32')
