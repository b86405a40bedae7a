"""Shared model building blocks: SAME padding, activations, norm layers.

Port of ``csmri_refinement_tpu/models/layers.py``. The helpers here work
on NCHW tensors (torch's conv layout; a permuted NHWC tensor is an NCHW
tensor in ``channels_last`` memory). ``same_conv`` keeps the semantics of
the JAX ``same_conv`` — an exact SAME-padded conv — not its TPU
border-strip lowering.

Under a spatial mesh (``parallel/halo.py::sharded_rows``) ``pad``,
``same_pad`` and ``same_conv`` are the choke point of every training conv:
the H padding at an edge between two ranks becomes halo rows of the
neighbour, and the zero, reflect or replicate padding applies at the
image's top and bottom only (a reflection there reads the pad + 1 rows the
rank's tile starts or ends with, as on the whole image). Each takes the
map's row layout (``rows``, a ``halo.Rows``; None: equal blocks, an
image's). A stride-2 conv and ``max_pool2`` give output row o to the rank
holding input row 2·o (``halo.Rows.strided``): where a rank's rows start
off the stride grid or its window reaches past a neighbour, it fetches
its window from the owners (``halo.fetch``), and a rank whose window is
empty holds no output rows. ``InstanceNorm`` takes its statistics and its
count over the spatial group, and ``channel_dropout`` draws the same
decisions on every rank of an image's spatial group (they share the
generator's state and the batch shard).
"""

import torch
import torch.nn.functional as F
from torch import nn

from csmri_refinement_tpu_torch.parallel import halo

_PAD_MODES = {
    'zero': 'constant',
    'reflection': 'reflect',
    'replication': 'replicate',
}


def pad_sizes(kernel_size, dilation=1, stride=1):
  """(before, after) SAME padding: the total ceil((k_eff − 1) / stride)
  splits evenly, an odd pixel going to the bottom/right, so k4 pads (1, 2)
  at stride 1 and (1, 1) at stride 2, k3 (0, 1) at stride 2."""
  if stride not in (1, 2):
    raise ValueError('SAME padding is defined for stride 1 or 2')
  effective = kernel_size + (kernel_size - 1) * (dilation - 1)
  total = -(-(effective - 1) // stride)
  side = total // 2
  return (side, side) if total % 2 == 0 else (side, side + 1)


def _fold(grad, dim, before, after, mode):
  """The gradient of a reflect or replicate pad of ``before`` and
  ``after`` along ``dim``, summed back onto the unpadded tensor."""
  n = grad.shape[dim] - before - after
  out = grad.narrow(dim, before, n).clone()
  lead, tail = grad.narrow(dim, 0, before), grad.narrow(dim, before + n, after)
  if mode == 'reflect':
    out.narrow(dim, 1, before).add_(lead.flip(dim))
    out.narrow(dim, n - 1 - after, after).add_(tail.flip(dim))
  else:
    out.narrow(dim, 0, 1).add_(lead.sum(dim, keepdim=True))
    out.narrow(dim, n - 1, 1).add_(tail.sum(dim, keepdim=True))
  return out


class _Pad(torch.autograd.Function):
  """``F.pad`` forward; a backward that folds the border's gradient back
  by slices, in a fixed order. F.pad's own CUDA backward for reflect and
  replicate accumulates with atomics, in no fixed order: two runs of one
  step would differ, and ``torch.use_deterministic_algorithms`` refuses
  it."""

  @staticmethod
  def forward(ctx, x, pads, mode):
    ctx.pads, ctx.mode = pads, mode
    return F.pad(x, pads, mode=mode)

  @staticmethod
  def backward(ctx, grad):
    (left, right, top, bottom), mode = ctx.pads, ctx.mode
    grad = _fold(grad, -1, left, right, mode)
    return _fold(grad, -2, top, bottom, mode), None, None


def local_pad(x, pads, mode):
  """``F.pad`` of an NCHW tensor by (left, right, top, bottom), ``mode``
  'constant', 'reflect' or 'replicate'; the last two with a deterministic
  backward (``_Pad``). The tensor is padded as it is, under a spatial mesh
  too."""
  if mode == 'constant':
    return F.pad(x, pads)
  return _Pad.apply(x, tuple(pads), mode)


def pad(x, pads, mode, rows=None):
  """``local_pad`` of the image ``x`` holds rows of: under a spatial mesh,
  the rows above and below come from the ranks that hold them (``halo``;
  ``rows`` the map's layout, None: equal blocks) and ``mode`` pads the
  image's top and bottom edges only."""
  mesh = halo.current()
  if mesh is None:
    return local_pad(x, pads, mode)
  left, right, top, bottom = pads
  rows = rows or halo.equal_rows(x, mesh, 2)
  windows = rows.halo(top, bottom)
  if halo.one_hop(rows, windows) is None:
    x = halo.fetch(x, mesh, rows, windows, mode)
    if not x.shape[2]:
      return halo.no_rows(x.shape[:3] + (x.shape[3] + left + right,), x)
    return local_pad(x, (left, right, 0, 0), mode)
  x = halo.halo_rows(x, top, bottom, mesh)
  above, below = halo.taken(mesh, top, bottom)
  return local_pad(x, (left, right, top - above, bottom - below), mode)


def same_pad(x, kernel_size, mode='zero', dilation=1, stride=1, rows=None):
  """Explicit SAME padding of an NCHW tensor before a VALID conv."""
  p1, p2 = pad_sizes(kernel_size, dilation, stride)
  return pad(x, (p1, p2, p1, p2), _PAD_MODES[mode], rows)


def tile_pad(x, kernel_size, mode='zero'):
  """SAME padding of an NCHW tensor as it stands (``local_pad``), under a
  spatial mesh too: how the conv kernels pad a halo tile's edges, which
  the plain versions follow."""
  p1, p2 = pad_sizes(kernel_size)
  return local_pad(x, (p1, p2, p1, p2), _PAD_MODES[mode])


def conv_rows(rows, kernel_size, dilation=1, stride=1):
  """The row layout of ``same_conv``'s output on a map of layout
  ``rows`` (None without one)."""
  if rows is None:
    return None
  p1, p2 = pad_sizes(kernel_size, dilation, stride)
  return rows.strided(kernel_size + (kernel_size - 1) * (dilation - 1),
                      stride, p1, p2)[0]


def same_conv(x, weight, bias=None, mode='zero', dilation=1, stride=1,
              rows=None):
  """SAME conv of NCHW ``x`` with OIHW ``weight``; under a spatial mesh on
  the rank's rows of a map of layout ``rows`` (None: equal blocks)."""
  k = weight.shape[-1]
  span = k + (k - 1) * (dilation - 1)
  p1, p2 = pad_sizes(k, dilation, stride)
  mesh = halo.current()
  if mode == 'zero' and p1 == p2 and mesh is None:
    return F.conv2d(x, weight, bias, stride=stride, padding=p1,
                    dilation=dilation)
  if mesh is None:
    return F.conv2d(same_pad(x, k, mode, dilation, stride), weight, bias,
                    stride=stride, dilation=dilation)
  rows = rows or halo.equal_rows(x, mesh, 2)
  out, windows = rows.strided(span, stride, p1, p2)
  if windows == rows.halo(p1, p2):
    tile = same_pad(x, k, mode, dilation, stride, rows)
  else:     # a stride-2 conv whose rows start off the stride grid
    tile = halo.fetch(x, mesh, rows, windows, _PAD_MODES[mode])
    if tile.shape[2]:
      tile = local_pad(tile, (p1, p2, 0, 0), _PAD_MODES[mode])
  if not out.count(mesh.s):
    return halo.no_rows((x.shape[0], weight.shape[0], 0,
                         (x.shape[3] + p1 + p2 - span) // stride + 1), tile,
                        weight, bias)
  return F.conv2d(tile, weight, bias, stride=stride, dilation=dilation)


def max_pool2(x, rows=None):
  """2×2 max-pool at stride 2 of an NCHW map (floor); under a spatial mesh
  on the rank's rows of a map of layout ``rows`` (None: equal blocks),
  output row o on the rank holding input row 2·o."""
  mesh = halo.current()
  if mesh is None:
    return F.max_pool2d(x, 2, 2)
  rows = rows or halo.equal_rows(x, mesh, 2)
  out, windows = rows.strided(2, 2, 0, 0)
  if windows != rows.halo(0, 0):
    x = halo.fetch(x, mesh, rows, windows)
  if not out.count(mesh.s):
    return halo.no_rows(x.shape[:2] + (0, x.shape[3] // 2), x)
  return F.max_pool2d(x, 2, 2)


def pool_rows(rows):
  """The row layout of ``max_pool2``'s output (None without one)."""
  return None if rows is None else rows.strided(2, 2, 0, 0)[0]


class _LeakyReLU(torch.autograd.Function):
  """``F.leaky_relu`` whose gradient at 0 is 1, as JAX's ``leaky_relu``
  (``where(x >= 0, ...)``) has it; torch's is the slope there. Inputs of
  exactly 0 are common (a conv with zero bias on the zero background of an
  image), and the choice then moves every gradient upstream."""

  @staticmethod
  def forward(ctx, x, negative_slope):
    ctx.save_for_backward(x)
    ctx.negative_slope = negative_slope
    return F.leaky_relu(x, negative_slope)

  @staticmethod
  def backward(ctx, grad):
    x, = ctx.saved_tensors
    return torch.where(x >= 0, grad, grad * ctx.negative_slope), None


def leaky_relu(x, negative_slope):
  """LeakyReLU: x where x >= 0, else negative_slope·x; gradient 1 at 0."""
  return _LeakyReLU.apply(x, negative_slope)


class PReLU(nn.Module):
  """Parametric ReLU with a learned ``slope`` per channel (dim 1 of an NCHW
  map or of a (B, F) feature vector)."""

  def __init__(self, num_channels, init_slope=0.25):
    super().__init__()
    self.slope = nn.Parameter(torch.full((num_channels,), float(init_slope)))

  def forward(self, x):
    slope = self.slope.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, slope * x)


class InstanceNorm(nn.Module):
  """Instance normalisation over the spatial dims of an NCHW map (biased
  variance, eps 1e-5), optionally with a per-channel ``scale`` and
  ``bias``."""

  def __init__(self, num_channels, affine=False, eps=1e-5):
    super().__init__()
    self.eps = eps
    if affine:
      self.scale = nn.Parameter(torch.ones(num_channels))
      self.bias = nn.Parameter(torch.zeros(num_channels))
    else:
      self.scale = self.bias = None

  def forward(self, x):
    mesh = halo.current()
    if mesh is None:
      var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    else:     # two passes over the spatial group's rows, whose count the
      # first sums too (the ranks may hold unequal rows)
      c = x.shape[1]
      count = x.new_full(x.shape[:1] + (1, 1, 1), x.shape[2] * x.shape[3])
      stats = halo.sum_rows(torch.cat([x.sum((2, 3), keepdim=True), count],
                                      1), mesh)
      n = stats[:, c:]
      mean = stats[:, :c] / n
      var = halo.sum_rows(((x - mean) ** 2).sum((2, 3), keepdim=True),
                          mesh) / n
    y = (x - mean) * torch.rsqrt(var + self.eps)
    if self.scale is not None:
      y = y * self.scale.reshape(1, -1, 1, 1) + self.bias.reshape(1, -1, 1, 1)
    return y


def get_activation(name, leakiness=None, num_channels=None):
  """Activation by name: a function, or a ``PReLU`` module for 'prelu'."""
  if name == 'relu':
    return F.relu
  if name == 'lrelu':
    if leakiness is None:
      raise ValueError('lrelu needs a leakiness')
    return lambda x: leaky_relu(x, leakiness)
  if name == 'tanh':
    return torch.tanh
  if name == 'softmax':
    return lambda x: torch.softmax(x, dim=1)
  if name == 'prelu':
    if leakiness is None or num_channels is None:
      raise ValueError('prelu needs a leakiness and a channel count')
    return PReLU(num_channels, leakiness)
  raise ValueError('Unknown activation function {}'.format(name))


def need_bias(use_norm_layers, norm_layer):
  """Whether a conv needs a bias given the norm layer after it."""
  return (not use_norm_layers or use_norm_layers == 'not-first' or
          norm_layer == 'instance')


def channel_dropout(x, rate, training, generator=None, shard=None):
  """``nn.Dropout2d`` on an NCHW map: whole channels of each example are
  zeroed with probability ``rate``, the rest scaled by 1/(1 − rate). The
  keep decisions come from ``generator`` (on ``x``'s device). With
  ``shard=(rank, world)`` (a data-parallel run) the decisions of the
  global batch are drawn and the rank's rows kept, so that they do not
  depend on the world; the ranks of a spatial group pass the same shard and
  generator state, and draw the same decisions for their image rows."""
  if not training or rate == 0.0:
    return x
  b = x.shape[0]
  rank, world = shard or (0, 1)
  u = torch.rand((b * world, x.shape[1], 1, 1), generator=generator,
                 device=x.device)[rank * b:(rank + 1) * b]
  keep = u < 1.0 - rate
  return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
