"""Configurable U-Net on NHWC tensors.

Port of ``csmri_refinement_tpu/models/unet.py``:

* ``ConvEncodeUnit`` (``:269-362``): ``num_layers`` SAME convs + BN +
  LeakyReLU, with 2×2 max-pool downsampling. In eval mode (and k ∈ {3, 4})
  BN's running stats fold into the conv weights and bias in f32 (eps 1e-5)
  and the chain runs through ``ops/conv_chain.chain_forward`` — the conv
  kernel on the card (``unet.py:286-318``) — or, with
  ``quantize_inference``, through ``ops/quantize.chain_forward_int8`` (the
  int8 serving mode). In train mode it is a plain conv + batch-stat BN, and
  the flag is ignored (``unet.py:324``). BN in train mode updates its
  running variance with the biased batch variance, as flax's ``BatchNorm``
  does (``BatchNorm2d`` below; ``nn.BatchNorm2d`` takes the unbiased one).
* ``ConvDecodeUnit`` (``:365-471``) with ``act_upsampling_only`` and the
  up-sampling modes
  - ``transposed`` (the ``UNET`` default, ``:393-406``): a k×k stride-2
    VALID transposed conv, cropped by k − 2 at the bottom/right. Its
    ``up_conv`` is an ``nn.ConvTranspose2d``; flax's ``ConvTranspose``
    applies its kernel unflipped, so the weight bridge flips it
    (``utils/jax_weights.py``);
  - ``pixelshuffle`` (``:409-415``): a SAME k×k conv to 4·Cout channels at
    the low resolution, then depth-to-space in torch ``PixelShuffle``'s
    channel order;
  - ``nn`` and ``nn-resize-conv``: nearest-up2, then (``nn-resize-conv``)
    a SAME pad of the upsampled image and a conv; for k = 4 that runs as
    ``SubpixelNNResizeConv`` (``:87-169``, chosen at ``:416-421``), in
    train and eval mode: one 3×3 conv to 4·Cout phase channels on the
    low-resolution image, then depth-to-space, without the upsampled
    intermediate. Other k keep the explicit path (``:422-430``);
  - ``bilinear`` and ``nn-biresize-conv`` (``:407-408``, ``:422-429``):
    the 2× bilinear up-sample of ``jax.image.resize`` (half-pixel centres,
    edge rows repeated), written as its two-tap stencil (``_bilinear_up2``)
    rather than ``F.interpolate``, whose CUDA backward adds with atomics in
    no fixed order; then (``nn-biresize-conv``) a SAME k×k conv.
  Without ``act_upsampling_only`` BN and LeakyReLU act on the
  skip-concatenated tensor (``merge_bn``) before the decode chain, and do
  not fold into it.
* ``UNET`` (``:474-594``): encoders, skip concat with pad-to-target,
  decoders, 1×1 head, output activation; ``use_refinement`` adds the input
  to the prediction, and ``encoder_features`` (indices into each
  downsampling scale's pre-pool features, then the last encoder's output)
  makes the forward return ``{'pred': ..., 'features': [...]}``.

``remat`` (``:490``, ``:519-520``) recomputes every encode and decode
unit in the backward of a train-mode forward (``models/remat.py``; the BN
statistics move once). Under a bf16 ``dtype`` the parameters and BN
statistics stay f32: each conv casts its weights, and BN normalises in f32
and returns the compute dtype, as flax's ``BatchNorm`` does. Submodule
names follow the flax tree (``encode_{s}.conv_{i}``, ``bn_{i}``,
``decode_{s}.up_conv``, ``decode_{s}.merge_bn``,
``decode_{s}.decode.conv_{i}``, ``head``) so the weight bridge is a 1:1
walk.

Under a spatial mesh (``parallel/halo.py``) each rank holds its rows of
every map, by the layout the forward derives for each scale from the
input's equal blocks (``halo.Rows``): a pool gives output row o to the
rank holding input row 2·o, so a scale whose rows a pool splits (61 rows
a rank, say) is held unequally, and each up-sampling doubles its input's
layout. The SAME convs take halo rows (``layers.same_conv``), the
max-pool fetches the row its last pair lacks (``layers.max_pool2``), the
1×1 head is local, a ``transposed`` up-conv of k > 2 takes the (k − 1) //
2 rows above whose overhang reaches its rows, ``pixelshuffle`` and the
subpixel k4 up-conv are convs on the low-resolution grid (the latter
recomputes the image's last row on the rank that holds it), the bilinear
up-sample reads one halo row per side (its edge rows repeated at the
image's top and bottom only), ``_pad_to_target`` re-lays the up-sampled
map onto its skip's rows (and reflects the row an odd skip has more),
BN takes the world's statistics, and the encoder features are the rank's
rows (``parallel/mesh.py::gather_to_replicated`` exchanges their lengths).
An eval chain through the conv kernel
runs on its rows with a halo of L·pad rows per side (L layers), and drops
the halo rows of its output, which hold every row the tile's own edges
made wrong; the kernel is unchanged. The int8 mode runs its float prefix
so, and its quantized layers one at a time on halo tiles, with the whole
image's activation scales (``ops/quantize.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.models import remat as remat_lib
from csmri_refinement_tpu_torch.models.layers import (
    leaky_relu, local_pad, max_pool2, pad, pad_sizes, pool_rows, same_conv,
    same_pad)
from csmri_refinement_tpu_torch.ops import conv_chain
from csmri_refinement_tpu_torch.ops import quantize
from csmri_refinement_tpu_torch.parallel import halo
from csmri_refinement_tpu_torch.utils import profiling

DEFAULT_RELU_LEAKINESS = 0.1
UPSAMPLING_MODES = ('transposed', 'nn', 'bilinear', 'pixelshuffle',
                    'nn-resize-conv', 'nn-biresize-conv')


def _nchw(x):
  return x.permute(0, 3, 1, 2)


def _nhwc(x):
  return x.permute(0, 2, 3, 1)


def _up2_axis(p, dim):
  """2× linear up-sampling with half-pixel centres along ``dim`` of ``p``,
  which holds one extra row at each end: output 2i is 0.75·x[i] +
  0.25·x[i − 1], output 2i + 1 is 0.75·x[i] + 0.25·x[i + 1] (one ``lerp``
  each)."""
  n = p.shape[dim] - 2
  mid = p.narrow(dim, 1, n)
  even = torch.lerp(mid, p.narrow(dim, 0, n), 0.25)
  odd = torch.lerp(mid, p.narrow(dim, 2, n), 0.25)
  return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def _bilinear_up2(x, rows=None):
  """``jax.image.resize(x, (B, 2H, 2W, C), 'bilinear')`` of an NHWC
  tensor, as slices and ``lerp``s (a backward without atomics), NHWC
  throughout. The edge rows and columns repeat (``layers.pad``,
  'replicate'); under a spatial mesh the rows above and below a rank's
  tile are the neighbours' halo rows instead (``rows``: the layout), so
  each rank computes exactly twice its rows."""
  p = _nhwc(pad(_nchw(x), (1, 1, 1, 1), 'replicate', rows))
  if not x.shape[1]:
    return halo.no_rows((x.shape[0], 0, 2 * x.shape[2], x.shape[3]), p)
  return _up2_axis(_up2_axis(p, 1), 2)


def _nearest_up2(x):
  """Nearest 2× up-sampling of an NCHW map (a rank's block of no rows
  gives none)."""
  if not x.shape[2]:
    return halo.no_rows(x.shape[:2] + (0, 2 * x.shape[3]), x)
  return F.interpolate(x, scale_factor=2, mode='nearest')


def _bn_act(x, bn, leak, dt):
  """BN module (if any; computed in f32) then LeakyReLU (if ``leak`` is not
  None) on an NHWC tensor, returned in ``dt``."""
  if bn is not None:
    x = _nhwc(bn(_nchw(x).float())).to(dt)
  if leak is not None:
    x = leaky_relu(x, leak)
  return x


class BatchNorm2d(nn.BatchNorm2d):
  """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` takes
  the biased batch variance, as flax's ``BatchNorm`` does (torch takes
  the unbiased one, N/(N−1) times larger). The output is unchanged: both
  normalise with the biased variance. A backward's recompute
  (``models/remat.py``) leaves the statistics alone.

  With a ``process_group`` (``parallel/mesh.py::sync_batchnorm``) the
  train-mode statistics are the global batch's, as GSPMD gives the JAX
  package one logical batch: the per-channel sum, sum of squares and count
  are all-reduced with autograd (``parallel/mesh.py::all_reduce_sum``), so the
  gradients reach every rank's rows; the variance is flax's
  ``E[x²] − E[x]²`` (biased). ``nn.SyncBatchNorm`` would update the
  running variance with the unbiased one.
  """

  process_group = None

  def forward(self, x):
    if not self.training:
      return super().forward(x)
    if self.process_group is not None:
      return self._synced(x)
    if not remat_lib.recomputing():
      with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked += 1
    return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                        self.eps)

  def _synced(self, x):
    from csmri_refinement_tpu_torch.parallel.mesh import all_reduce_sum
    count = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype,
                       device=x.device)
    stats = all_reduce_sum(torch.cat([x.sum((0, 2, 3)),
                                      (x * x).sum((0, 2, 3)), count]),
                           self.process_group)
    c = x.shape[1]
    mean = stats[:c] / stats[-1]
    var = (stats[c:2 * c] / stats[-1] - mean * mean).clamp_min(0.0)
    if not remat_lib.recomputing():
      with torch.no_grad():
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked += 1
    view = lambda t: t[None, :, None, None]
    mul = torch.rsqrt(var + self.eps) * self.weight
    return (x - view(mean)) * view(mul) + view(self.bias)


# Per-axis tap-collapse matrices of the k4 up-conv on the nearest-upsampled
# grid (SAME pads 1 before, 2 after): tap t of output phase r ∈ {0, 1} at
# low-res i reads source pixel i + floor((r − 1 + t) / 2), which is row
# 1 + floor((r − 1 + t) / 2) of a 3×3 kernel on the low-res image padded by
# one; so the 4 taps sum into 3 (JAX ``unet.py:127-131``).
_PHASE_TAPS = ((
    (1, 0, 0, 0), (0, 1, 1, 0), (0, 0, 0, 1)), (
    (0, 0, 0, 0), (1, 1, 0, 0), (0, 0, 1, 1)))


class SubpixelNNResizeConv(nn.Conv2d):
  """``nearest-up2 → SAME k4 conv`` without the upsampled image.

  The parameters are the plain k4 conv's (``weight`` (Cout, Cin, 4, 4),
  ``bias``), so checkpoints and the weight bridge are unchanged. The
  forward derives four 3×3 phase kernels from them, runs one conv to
  4·Cout channels on the low-resolution image padded ``replicate`` (or
  ``zero``), and moves the phase blocks, ordered (ry, rx) row-major then
  channel as in JAX, to pixels (2i + ry, 2j + rx). Zero and replicate
  padding of the upsampled image are exact this way; reflection reaches
  one more source pixel at the bottom/right edge, so the last output row
  and column are recomputed from thin upsampled slabs (JAX
  ``unet.py:148-165``). The bias goes into each conv.
  """

  def __init__(self, in_channels, out_channels, bias=True, padding='zero'):
    super().__init__(in_channels, out_channels, 4, bias=bias)
    self.pad_mode = padding
    # On the module's device, so that a forward copies nothing from the
    # host (a CUDA graph can capture it).
    self.register_buffer('taps', torch.tensor(_PHASE_TAPS,
                                              dtype=torch.float32),
                         persistent=False)

  def phase_weight(self, dtype):
    """(4·Cout, Cin, 3, 3) phase kernels, summed in f32 (or wider); in
    the span ``csmri.unet.prepare``."""
    with profiling.span('csmri.unet.prepare'):
      weight = self.weight.to(torch.promote_types(self.weight.dtype,
                                                  torch.float32))
      taps = self.taps.to(weight.dtype)
      ksub = torch.einsum('yat,xbu,oitu->yxoiab', taps, taps, weight)
      cout, cin = self.weight.shape[:2]
      return ksub.reshape(4 * cout, cin, 3, 3).to(dtype)

  def forward(self, x, rows=None):
    """x: NCHW (B, Cin, H, W) → NHWC (B, 2H, 2W, Cout), in x's dtype;
    under a spatial mesh the rank's rows of a map of layout ``rows``. In
    the span ``csmri.unet.upconv``."""
    with profiling.span('csmri.unet.upconv'):
      dt = x.dtype
      bias = None if self.bias is None else self.bias.to(dt)
      low_pad = 'zero' if self.pad_mode == 'zero' else 'replication'
      tile = same_pad(x, 3, low_pad, rows=rows)
      phase_bias = None if bias is None else bias.repeat(4)
      if x.shape[2]:
        y4 = F.conv2d(tile, self.phase_weight(dt), phase_bias)
      else:
        y4 = halo.no_rows((x.shape[0], 4 * self.out_channels, 0, x.shape[3]),
                          tile, self.weight, self.bias)
      b, c4, h, w = y4.shape
      cout = c4 // 4
      y = _nhwc(y4).reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5) \
          .reshape(b, 2 * h, 2 * w, cout)
      if self.pad_mode == 'reflection':
        weight = self.weight.to(dt)
        mesh = halo.current()
        tail, fetched = x[:, :, -2:], False
        if mesh is not None:     # the rank holding the image's last row
          rows = rows or halo.equal_rows(x, mesh, 2)
          last = max(r for r in range(mesh.spatial) if rows.count(r))
          if rows.count(last) < 2:
            tail, fetched = halo.fetch(x, mesh, rows, tuple(
                (rows.height - 2, rows.height) if r == last else None
                for r in range(mesh.spatial))), True
        if mesh is None or mesh.s == last:
          # Rows 2H-4..2H-1 of the upsampled image, padded inside the slab
          # (which holds every row the reflection reaches): output row 2H-1.
          row = local_pad(_nearest_up2(tail), (1, 2, 0, 2), 'reflect')
          y[:, -1:] = _nhwc(F.conv2d(row, weight, bias)[:, :, 2:3])
        elif fetched:
          # an empty fetch of the rows the last rank lacked: every rank runs
          # its backward's exchange
          y = y + tail.sum() * 0
        col = pad(_nearest_up2(x[:, :, :, -2:]), (0, 2, 1, 2), 'reflect',
                  None if rows is None else rows.up2())
        if y.shape[1]:
          y[:, :, -1:] = _nhwc(F.conv2d(col, weight, bias)[:, :, :, 2:3])
        else:
          y = y + col.sum() * 0
      return y


def _pad_to_target(x, target, rows=None, target_rows=None):
  """Reflect-pad bottom/right so x's spatial dims match target's; under a
  spatial mesh x of layout ``rows`` is re-laid onto ``target_rows``, the
  target's (``halo.fetch``; the rows past x's last reflected)."""
  if rows is None or rows == target_rows:
    pad_bottom = target.shape[1] - x.shape[1]
    pad_right = target.shape[2] - x.shape[2]
    if pad_bottom or pad_right:
      x = _nhwc(pad(_nchw(x), (0, pad_right, 0, pad_bottom), 'reflect'))
    return x
  pad_right = target.shape[2] - x.shape[2]
  if pad_right and x.shape[1]:
    x = _nhwc(local_pad(_nchw(x), (0, pad_right, 0, 0), 'reflect'))
  elif pad_right:
    x = halo.no_rows(x.shape[:2] + (target.shape[2], x.shape[3]), x)
  return halo.fetch(x, halo.current(), rows, target_rows.halo(0, 0),
                    'reflect', dim=1)


class ConvEncodeUnit(nn.Module):

  def __init__(self, in_channels, num_layers, num_filters, kernel_size,
               relu_leakiness, use_bn, downsample, use_act=True,
               padding='zero', dtype=None, quantize_inference=False):
    super().__init__()
    self.quantize_inference = quantize_inference
    self.num_layers = num_layers
    self.kernel_size = kernel_size
    self.leak = relu_leakiness if use_act else None
    self.use_bn = use_bn
    self.downsample = downsample
    self.padding = padding
    self.dtype = dtype
    cin = in_channels
    for i in range(num_layers):
      self.add_module('conv_{}'.format(i), nn.Conv2d(
          cin, num_filters, kernel_size, bias=not use_bn))
      if use_bn:
        self.add_module('bn_{}'.format(i),
                        BatchNorm2d(num_filters, eps=1e-5, momentum=0.1))
      cin = num_filters

  def _layer(self, i):
    return (getattr(self, 'conv_{}'.format(i)),
            getattr(self, 'bn_{}'.format(i)) if self.use_bn else None)

  def chain_layers(self):
    """The unit's convs as ``ChainLayer``s, eval-mode BN folded into the
    weights and bias in f32; in the span ``csmri.unet.prepare``."""
    with profiling.span('csmri.unet.prepare'):
      chain = []
      for i in range(self.num_layers):
        conv, bn = self._layer(i)
        kernel = conv.weight.float().permute(2, 3, 1, 0)    # OIHW → HWIO
        bias = None if conv.bias is None else conv.bias.float()
        if bn is not None:
          s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + 1e-5)
          kernel = kernel * s
          bias = bn.bias.float() - bn.running_mean.float() * s
        chain.append(conv_chain.ChainLayer(kernel, bias, self.leak))
      return chain

  def _fused_chain(self, x, rows=None):
    """Eval-mode chain through the conv kernel (``ops/conv_chain.py``),
    or its int8 mode with ``quantize_inference``; under a spatial mesh on
    the rank's rows (layout ``rows``), the float chain with a halo of
    L·pad rows per side (the int8 mode: ``ops/quantize.py``)."""
    dt = self.dtype or x.dtype
    mesh = halo.current()
    if self.quantize_inference:
      return quantize.chain_forward_int8(x.to(dt).contiguous(),
                                         self.chain_layers(),
                                         pad_mode=self.padding, mesh=mesh,
                                         rows=rows)
    if mesh is None:
      return conv_chain.chain_forward(x.to(dt).contiguous(),
                                      self.chain_layers(),
                                      pad_mode=self.padding)
    p1, p2 = pad_sizes(self.kernel_size)
    tile, above = halo.tile(x.to(dt), mesh, rows or halo.equal_rows(x, mesh, 1),
                            self.num_layers * p1, self.num_layers * p2, 1)
    chain = self.chain_layers()
    if not x.shape[1]:
      return x.new_zeros(x.shape[:3] + (chain[-1].kernel.shape[-1],),
                         dtype=dt)
    y = conv_chain.chain_forward(tile.contiguous(), chain,
                                 pad_mode=self.padding)
    return y.narrow(1, above, x.shape[1])

  def _plain(self, x, rows=None):
    dt = self.dtype or x.dtype
    for i in range(self.num_layers):
      conv, bn = self._layer(i)
      bias = None if conv.bias is None else conv.bias.to(dt)
      x = _nhwc(same_conv(_nchw(x.to(dt)), conv.weight.to(dt), bias,
                          self.padding, rows=rows))
      x = _bn_act(x, bn, self.leak, dt)
    return x

  def forward(self, x, rows=None):
    """x: (B, H, W, C), under a spatial mesh the rank's rows of a map of
    layout ``rows``. Returns (pooled, features) when downsampling."""
    if not self.training and self.kernel_size in (3, 4):
      x = self._fused_chain(x, rows)
    else:
      x = self._plain(x, rows)
    if self.downsample:
      return _nhwc(max_pool2(_nchw(x), rows)), x
    return x


class ConvDecodeUnit(nn.Module):

  def __init__(self, in_channels, encoder_channels, num_filters,
               relu_leakiness, use_bn, use_act=True, kernel_size=3,
               transposed_kernel_size=2, num_layers=0, mode='transposed',
               padding='zero', act_upsampling_only=False, dtype=None,
               quantize_inference=False):
    super().__init__()
    if mode not in UPSAMPLING_MODES:
      raise ValueError('Unknown upsampling mode {!r}'.format(mode))
    self.mode = mode
    self.leak = relu_leakiness if use_act else None
    self.padding = padding
    self.act_upsampling_only = act_upsampling_only
    self.dtype = dtype
    self.num_layers = num_layers
    self.subpixel = mode == 'nn-resize-conv' and kernel_size == 4
    up_channels = num_filters
    use_bias = not use_bn or encoder_channels == 0
    if mode == 'transposed':
      self.up_conv = nn.ConvTranspose2d(in_channels, num_filters,
                                        transposed_kernel_size, stride=2,
                                        bias=use_bias)
    elif mode == 'pixelshuffle':
      self.up_conv = nn.Conv2d(in_channels, 4 * num_filters, kernel_size,
                               bias=use_bias)
    elif self.subpixel:
      self.up_conv = SubpixelNNResizeConv(in_channels, num_filters, use_bias,
                                          padding)
    elif mode in ('nn-resize-conv', 'nn-biresize-conv'):
      self.up_conv = nn.Conv2d(in_channels, num_filters, kernel_size,
                               bias=use_bias)
    else:
      up_channels = in_channels
    if use_bn and act_upsampling_only:
      self.up_bn = BatchNorm2d(up_channels, eps=1e-5, momentum=0.1)
    merged = encoder_channels + up_channels
    if use_bn and not act_upsampling_only:
      self.merge_bn = BatchNorm2d(merged, eps=1e-5, momentum=0.1)
    self.out_channels = merged
    if num_layers > 0:
      self.decode = ConvEncodeUnit(
          merged, num_layers, num_filters, kernel_size, relu_leakiness,
          use_bn, downsample=False, use_act=use_act, padding=padding,
          dtype=dtype, quantize_inference=quantize_inference)
      self.out_channels = num_filters

  def forward(self, decode_path, encode_path=None, rows=None,
              skip_rows=None):
    """Under a spatial mesh ``rows`` is the layout of ``decode_path`` and
    ``skip_rows`` that of ``encode_path``, onto whose rows the up-sampled
    map is re-laid."""
    dt = self.dtype or decode_path.dtype
    x = _nchw(decode_path.to(dt))
    conv = getattr(self, 'up_conv', None)
    bias = None if conv is None or conv.bias is None else conv.bias.to(dt)
    up_rows = None if rows is None else rows.up2()
    if self.subpixel:
      x = self.up_conv(x, rows)
    elif self.mode == 'transposed':
      b, _, h, w = x.shape
      mesh = halo.current()
      above = 0
      if mesh is not None:     # the overhang of the rows above
        reach = (conv.kernel_size[0] - 1) // 2
        x, above = halo.tile(x, mesh, rows or halo.equal_rows(x, mesh, 2), reach,
                             0, 2)
      if h:
        x = F.conv_transpose2d(x, conv.weight.to(dt), bias, stride=2)
        # VALID gives 2H + k − 2: crop the overhang at the bottom/right
        x = _nhwc(x[:, :, 2 * above:2 * (above + h), :2 * w])
      else:
        x = _nhwc(halo.no_rows((b, conv.weight.shape[1], 0, 2 * w), x,
                               conv.weight, bias))
    elif self.mode == 'pixelshuffle':
      x = _nhwc(F.pixel_shuffle(
          same_conv(x, conv.weight.to(dt), bias, self.padding, rows=rows), 2))
    else:
      if self.mode in ('nn', 'nn-resize-conv'):
        x = _nearest_up2(x)
      else:
        x = _nchw(_bilinear_up2(_nhwc(x), rows))
      if conv is not None:
        x = same_conv(x, conv.weight.to(dt), bias, self.padding, rows=up_rows)
      x = _nhwc(x)
    if self.act_upsampling_only:
      x = _bn_act(x, getattr(self, 'up_bn', None), self.leak, dt)
    if encode_path is not None:
      x = _pad_to_target(x, encode_path, up_rows, skip_rows)
      x = torch.cat([encode_path.to(dt), x], dim=-1)
      up_rows = skip_rows
    if not self.act_upsampling_only:
      x = _bn_act(x, getattr(self, 'merge_bn', None), self.leak, dt)
    if self.num_layers > 0:
      x = self.decode(x, up_rows)
    return x


class UNET(nn.Module):
  """``forward(inp)``: (B, H, W, num_inputs) → (B, H, W, num_outputs).

  ``fused_inference`` is accepted for config parity and has no effect: the
  JAX package fuses eval chains only when it is set, the port always does.
  """

  def __init__(self, num_inputs, num_outputs, num_layers_per_scale,
               encode_filters, decode_filters, output_activation,
               kernel_size=3, transposed_kernel_size=2,
               relu_leakiness=DEFAULT_RELU_LEAKINESS, use_bn=True,
               upsampling_mode='transposed', padding='zero',
               decoder_act_upsampling_only=False, fused_inference=False,
               quantize_inference=False, weight_init=None, dtype=None,
               use_refinement=False, encoder_features=None, remat=False):
    super().__init__()
    if output_activation not in ('softmax', 'tanh', 'none'):
      raise ValueError('Unknown output activation {}'.format(
          output_activation))
    if isinstance(relu_leakiness, (int, float)):
      relu_leakiness = (relu_leakiness, relu_leakiness)
    self.output_activation = output_activation
    self.weight_init = weight_init or {}
    self.dtype = dtype
    self.remat = remat
    self.use_refinement = use_refinement
    self.encoder_features = encoder_features
    n_enc = len(encode_filters)
    self.n_enc = n_enc
    self.n_dec = len(decode_filters)

    cin = num_inputs
    for scale, f in enumerate(encode_filters):
      self.add_module('encode_{}'.format(scale), ConvEncodeUnit(
          cin, num_layers_per_scale, f, kernel_size, relu_leakiness[0],
          use_bn, downsample=scale != n_enc - 1, padding=padding,
          dtype=dtype, quantize_inference=quantize_inference))
      cin = f
    for scale, f in enumerate(decode_filters):
      skip = scale < n_enc - 1
      name = 'decode_{}' if skip else 'up_decode_{}'
      unit = ConvDecodeUnit(
          cin, encode_filters[-(scale + 2)] if skip else 0, f,
          relu_leakiness[1], use_bn, kernel_size=kernel_size,
          transposed_kernel_size=transposed_kernel_size,
          num_layers=num_layers_per_scale, mode=upsampling_mode,
          padding=padding, act_upsampling_only=decoder_act_upsampling_only,
          dtype=dtype, quantize_inference=quantize_inference)
      self.add_module(name.format(scale if skip else scale - (n_enc - 1)),
                      unit)
      cin = unit.out_channels
    self.head = nn.Conv2d(cin, num_outputs, 1, bias=True)

  def _decoders(self):
    names = ['decode_{}'.format(s) for s in range(min(self.n_dec,
                                                       self.n_enc - 1))]
    names += ['up_decode_{}'.format(s)
              for s in range(self.n_dec - len(names))]
    return [getattr(self, n) for n in names]

  def init_weights(self, generator):
    """Seeded init: he_normal(0.1) convs and transposed convs and BN weight
    U(0.98, 1.02) unless the config overrides them. A transposed conv's
    weight (Cin, Cout, k, k) is drawn in the flax kernel's law, fan_in
    Cin·k·k, through its (Cout, Cin, k, k) view; its bias takes the conv
    bias init, as in JAX."""
    inits = weight_inits.resolve_inits(
        {'conv_weight': ('he_normal', DEFAULT_RELU_LEAKINESS),
         'conv_transposed_weight': ('he_normal', DEFAULT_RELU_LEAKINESS),
         'batchnorm_weight': ('uniform', 0.98, 1.02)}, self.weight_init)
    for module in self.modules():
      if isinstance(module, nn.ConvTranspose2d):
        weight_inits.init_(module.weight.data.transpose(0, 1),
                           inits['conv_transposed_weight'], generator)
        if module.bias is not None:
          weight_inits.init_(module.bias, inits['conv_bias'], generator)
      elif isinstance(module, nn.Conv2d):
        weight_inits.init_(module.weight, inits['conv_weight'], generator)
        if module.bias is not None:
          weight_inits.init_(module.bias, inits['conv_bias'], generator)
      elif isinstance(module, nn.BatchNorm2d):
        weight_inits.init_(module.weight, weight_inits.direct_spec(
            inits['batchnorm_weight'], 'batchnorm_weight'), generator)
        weight_inits.init_(module.bias, inits['batchnorm_bias'], generator)
        module.reset_running_stats()

  def _run(self, unit, *args):
    if self.remat and self.training and torch.is_grad_enabled():
      return remat_lib.checkpoint(unit, *args)
    return unit(*args)

  def forward(self, inp):
    x = inp
    # each scale's row layout under a spatial mesh (None without one)
    rows = halo.equal_rows(inp, halo.current(), 1)
    features, feature_rows = [], []
    for scale in range(self.n_enc):
      unit = getattr(self, 'encode_{}'.format(scale))
      if unit.downsample:
        x, feat = self._run(unit, x, rows)
        features.append(feat)
        feature_rows.append(rows)
        rows = pool_rows(rows)
      else:
        x = self._run(unit, x, rows)
        last = x
    for scale, unit in enumerate(self._decoders()):
      if scale < self.n_enc - 1:
        skip_rows = feature_rows[-(scale + 1)]
        x = self._run(unit, x, features[-(scale + 1)], rows, skip_rows)
        rows = skip_rows
      else:
        x = self._run(unit, x, None, rows, None)
        rows = None if rows is None else rows.up2()
    dt = self.dtype or x.dtype
    pred = _nhwc(F.conv2d(_nchw(x.to(dt)), self.head.weight.to(dt),
                          self.head.bias.to(dt)))
    if self.output_activation == 'softmax':
      pred = torch.softmax(pred, dim=-1)
    elif self.output_activation == 'tanh':
      pred = torch.tanh(pred)
    if self.use_refinement:
      pred = inp + pred
    if self.encoder_features is not None:
      encoded = features + [last]
      return {'pred': pred,
              'features': [encoded[i] for i in self.encoder_features]}
    return pred
