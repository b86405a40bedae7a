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
    intermediate. Other k keep the explicit path (``:422-430``).
  Without ``act_upsampling_only`` BN and LeakyReLU act on the
  skip-concatenated tensor (``merge_bn``) before the decode chain, and do
  not fold into it.
* ``UNET`` (``:474-594``): encoders, skip concat with pad-to-target,
  decoders, 1×1 head, output activation.

The modes ``bilinear`` and ``nn-biresize-conv`` and the options
``use_refinement``, ``encoder_features`` and ``remat`` are not ported yet
and raise. Submodule names follow the flax tree (``encode_{s}.conv_{i}``,
``bn_{i}``, ``decode_{s}.up_conv``, ``decode_{s}.merge_bn``,
``decode_{s}.decode.conv_{i}``, ``head``) so the weight bridge is a 1:1
walk.
"""

import torch
import torch.nn.functional as F
from torch import nn

from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.models.layers import (leaky_relu, same_conv,
                                                      same_pad)
from csmri_refinement_tpu_torch.ops import conv_chain
from csmri_refinement_tpu_torch.ops import quantize

DEFAULT_RELU_LEAKINESS = 0.1
PORTED_UPSAMPLING_MODES = ('transposed', 'pixelshuffle', 'nn',
                           'nn-resize-conv')


def _nchw(x):
  return x.permute(0, 3, 1, 2)


def _nhwc(x):
  return x.permute(0, 2, 3, 1)


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
  normalise with the biased variance."""

  def forward(self, x):
    if not self.training:
      return super().forward(x)
    with torch.no_grad():
      var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
      self.running_mean.lerp_(mean, self.momentum)
      self.running_var.lerp_(var, self.momentum)
      self.num_batches_tracked += 1
    return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                        self.eps)


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
    """(4·Cout, Cin, 3, 3) phase kernels, summed in f32 (or wider)."""
    weight = self.weight.to(torch.promote_types(self.weight.dtype,
                                                torch.float32))
    taps = self.taps.to(weight.dtype)
    ksub = torch.einsum('yat,xbu,oitu->yxoiab', taps, taps, weight)
    cout, cin = self.weight.shape[:2]
    return ksub.reshape(4 * cout, cin, 3, 3).to(dtype)

  def forward(self, x):
    """x: NCHW (B, Cin, H, W) → NHWC (B, 2H, 2W, Cout), in x's dtype."""
    dt = x.dtype
    bias = None if self.bias is None else self.bias.to(dt)
    low_pad = 'zero' if self.pad_mode == 'zero' else 'replication'
    y4 = F.conv2d(same_pad(x, 3, low_pad), self.phase_weight(dt),
                  None if bias is None else bias.repeat(4))
    b, c4, h, w = y4.shape
    cout = c4 // 4
    y = _nhwc(y4).reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, 2 * h, 2 * w, cout)
    if self.pad_mode == 'reflection':
      weight = self.weight.to(dt)
      up = lambda v: F.interpolate(v, scale_factor=2, mode='nearest')
      # Rows 2H-4..2H-1 of the upsampled image, padded inside the slab
      # (which holds every row the reflection reaches): output row 2H-1.
      row = F.pad(up(x[:, :, -2:]), (1, 2, 0, 2), mode='reflect')
      y[:, -1:] = _nhwc(F.conv2d(row, weight, bias)[:, :, 2:3])
      col = F.pad(up(x[:, :, :, -2:]), (0, 2, 1, 2), mode='reflect')
      y[:, :, -1:] = _nhwc(F.conv2d(col, weight, bias)[:, :, :, 2:3])
    return y


def _pad_to_target(x, target):
  """Reflect-pad bottom/right so x's spatial dims match target's."""
  pad_bottom = target.shape[1] - x.shape[1]
  pad_right = target.shape[2] - x.shape[2]
  if pad_bottom or pad_right:
    x = _nhwc(F.pad(_nchw(x), (0, pad_right, 0, pad_bottom), mode='reflect'))
  return x


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
    weights and bias in f32."""
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

  def _fused_chain(self, x):
    """Eval-mode chain through the conv kernel (``ops/conv_chain.py``),
    or its int8 mode with ``quantize_inference``."""
    dt = self.dtype or x.dtype
    forward = quantize.chain_forward_int8 if self.quantize_inference else \
        conv_chain.chain_forward
    return forward(x.to(dt).contiguous(), self.chain_layers(),
                   pad_mode=self.padding)

  def _plain(self, x):
    dt = self.dtype or x.dtype
    for i in range(self.num_layers):
      conv, bn = self._layer(i)
      bias = None if conv.bias is None else conv.bias.to(dt)
      x = _nhwc(same_conv(_nchw(x.to(dt)), conv.weight.to(dt), bias,
                          self.padding))
      x = _bn_act(x, bn, self.leak, dt)
    return x

  def forward(self, x):
    """x: (B, H, W, C). Returns (pooled, features) when downsampling."""
    if not self.training and self.kernel_size in (3, 4):
      x = self._fused_chain(x)
    else:
      x = self._plain(x)
    if self.downsample:
      return _nhwc(F.max_pool2d(_nchw(x), 2, 2)), x
    return x


class ConvDecodeUnit(nn.Module):

  def __init__(self, in_channels, encoder_channels, num_filters,
               relu_leakiness, use_bn, use_act=True, kernel_size=3,
               transposed_kernel_size=2, num_layers=0, mode='transposed',
               padding='zero', act_upsampling_only=False, dtype=None,
               quantize_inference=False):
    super().__init__()
    if mode not in PORTED_UPSAMPLING_MODES:
      raise NotImplementedError(
          'upsampling mode {!r} is not ported yet'.format(mode))
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
    elif mode == 'nn-resize-conv':
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

  def forward(self, decode_path, encode_path=None):
    dt = self.dtype or decode_path.dtype
    x = _nchw(decode_path.to(dt))
    conv = getattr(self, 'up_conv', None)
    bias = None if conv is None or conv.bias is None else conv.bias.to(dt)
    if self.subpixel:
      x = self.up_conv(x)
    elif self.mode == 'transposed':
      x = F.conv_transpose2d(x, conv.weight.to(dt), bias, stride=2)
      extra = conv.kernel_size[0] - 2        # VALID gives 2H + k − 2
      if extra > 0:
        x = x[:, :, :x.shape[2] - extra, :x.shape[3] - extra]
      x = _nhwc(x)
    elif self.mode == 'pixelshuffle':
      x = _nhwc(F.pixel_shuffle(
          same_conv(x, conv.weight.to(dt), bias, self.padding), 2))
    else:
      x = F.interpolate(x, scale_factor=2, mode='nearest')
      if self.mode == 'nn-resize-conv':
        x = same_conv(x, conv.weight.to(dt), bias, self.padding)
      x = _nhwc(x)
    if self.act_upsampling_only:
      x = _bn_act(x, getattr(self, 'up_bn', None), self.leak, dt)
    if encode_path is not None:
      x = _pad_to_target(x, encode_path)
      x = torch.cat([encode_path.to(dt), x], dim=-1)
    if not self.act_upsampling_only:
      x = _bn_act(x, getattr(self, 'merge_bn', None), self.leak, dt)
    if self.num_layers > 0:
      x = self.decode(x)
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
    for name, value in (('use_refinement', use_refinement),
                        ('encoder_features', encoder_features),
                        ('remat', remat)):
      if value:
        raise NotImplementedError('UNET {} is not ported yet'.format(name))
    if isinstance(relu_leakiness, (int, float)):
      relu_leakiness = (relu_leakiness, relu_leakiness)
    self.output_activation = output_activation
    self.weight_init = weight_init or {}
    self.dtype = dtype
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
        weight_inits.init_(module.weight, inits['batchnorm_weight'],
                           generator)
        weight_inits.init_(module.bias, inits['batchnorm_bias'], generator)
        module.reset_running_stats()

  def forward(self, inp):
    x = inp
    features = []
    for scale in range(self.n_enc):
      unit = getattr(self, 'encode_{}'.format(scale))
      if unit.downsample:
        x, feat = unit(x)
        features.append(feat)
      else:
        x = unit(x)
    for scale, unit in enumerate(self._decoders()):
      x = unit(x, features[-(scale + 1)] if scale < self.n_enc - 1 else None)
    dt = self.dtype or x.dtype
    pred = _nhwc(F.conv2d(_nchw(x.to(dt)), self.head.weight.to(dt),
                          self.head.bias.to(dt)))
    if self.output_activation == 'softmax':
      pred = torch.softmax(pred, dim=-1)
    elif self.output_activation == 'tanh':
      pred = torch.tanh(pred)
    return pred
