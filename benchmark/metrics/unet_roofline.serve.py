"""The refinement U-Net's share of its roofline, in %: the least time of
its conv operations (at the configuration's peak) and bytes, over the
device time of the operations launched inside the ``bench.unet`` ranges
around its forward."""


def read(run):
  return run.roofline('unet', run.work['unet_flops'], run.work['unet_bytes'],
                      run.conf['bench']['peak'])
