"""Operations and bytes of the layers a cell runs, from the configuration's
widths and the cell's shapes: the same work whatever implements it.

The rules:

* a convolution is 2 operations a multiply-accumulate, and a SAME k × k
  conv of ``cin`` to ``cout`` channels on an h × w map is h·w·cin·cout·k²
  of them;
* a nearest-up-2 followed by a SAME k × k conv (``nn-resize-conv``) counts
  the products that reach distinct source pixels: in each output phase
  the taps that read one pixel of the low-resolution map are one product
  (k = 4: 3 taps of a row for even outputs, 2 for odd ones, so 6.25 of 16
  a pixel on average);
* a 1-D complex FFT of n points is 5·n·log2(n) operations, so a 2-D one of
  an h × w image is 5·h·w·log2(h·w);
* a data-consistency step (DC) is two 2-D FFTs and reads or writes at
  least 28 bytes a pixel: the image and the sampled k-space read and the
  result written as complex float32, the mask read as float32;
* in a train step a layer whose weights train costs 3 times its forward
  (forward, weight gradient, input gradient), the network's first conv 2
  times (its input takes no gradient), and each DC twice (its adjoint is
  the same two FFTs).
"""

import math

DC_BYTES_PER_PIXEL = 28


def conv_macs(h, w, cin, cout, k):
  return h * w * cin * cout * k * k


def resize_conv_macs(h_out, w_out, cin, cout, k):
  """Products of nearest-up-2 then a SAME k × k conv, to an h_out × w_out
  map: the distinct source taps of each output phase."""
  before = (k - 1) // 2
  taps = [len({(r - before + t) // 2 for t in range(k)}) for r in (0, 1)]
  per_axis = sum(taps) / 2
  return h_out * w_out * cin * cout * per_axis * per_axis


def fft2_flops(h, w):
  return 5 * h * w * math.log2(h * w)


def dc(h, w):
  """(operations, least bytes) of one DC of one h × w slice."""
  return 2 * fft2_flops(h, w), DC_BYTES_PER_PIXEL * h * w


def recnet_convs(conf, h, w):
  """MACs of each conv of a RecNet cascade on one slice, in order."""
  out = []
  for block in range(conf['num_blocks']):
    cin = 2
    for j in range(conf['num_convs']):
      cout = 2 if j == conf['num_convs'] - 1 else conf['num_filters']
      out.append(conv_macs(h, w, cin, cout, conf['kernel_size']))
      cin = cout
  return out


def unet_macs(conf, h, w):
  """MACs of the refinement U-Net's forward on one slice: the encoders'
  chains (the last without pooling), each decoder's resize conv and chain
  on the skip-concatenated map, the 1 × 1 head."""
  k, layers = conf['kernel_size'], conf['num_layers_per_scale']
  enc, dec = conf['encode_filters'], conf['decode_filters']
  if len(dec) != len(enc) - 1 or conf['upsampling_mode'] != 'nn-resize-conv':
    raise ValueError('counted for one decoder a skip, nn-resize-conv')
  total, cin, sides = 0, conf['num_inputs'], []
  for scale, f in enumerate(enc):
    sh, sw = h >> scale, w >> scale
    sides.append((sh, sw))
    for _ in range(layers):
      total += conv_macs(sh, sw, cin, f, k)
      cin = f
  for scale, f in enumerate(dec):
    sh, sw = sides[-(scale + 2)]
    total += resize_conv_macs(sh, sw, cin, f, k)
    cin = f + enc[-(scale + 2)]
    for _ in range(layers):
      total += conv_macs(sh, sw, cin, f, k)
      cin = f
  return total + h * w * cin * conf['num_outputs']


def weight_count(conf_unet):
  """Parameters of the U-Net's convs (for its least bytes)."""
  k, layers = conf_unet['kernel_size'], conf_unet['num_layers_per_scale']
  enc, dec = conf_unet['encode_filters'], conf_unet['decode_filters']
  total, cin = 0, conf_unet['num_inputs']
  for f in enc:
    for _ in range(layers):
      total += cin * f * k * k
      cin = f
  for scale, f in enumerate(dec):
    total += cin * f * k * k
    cin = f + enc[-(scale + 2)]
    for _ in range(layers):
      total += cin * f * k * k
      cin = f
  return total + cin * conf_unet['num_outputs']
