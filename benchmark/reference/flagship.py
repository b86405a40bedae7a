"""Plain reference of the ``flagship`` configuration: the serving forward of
``generator_model`` in ``configs/2-refinement.json`` of csmri-refinement,
in float32 with TF32 off.

* The frozen RecNet cascade with data consistency (``reference/recnet.py``).
* The refinement U-Net on the cascade's output (``input_mode`` 'output'):
  per scale ``num_layers_per_scale`` SAME k × k convs with reflection
  padding (k = 4 pads 1 before and 2 after), each followed by eval-mode
  BatchNorm (running statistics, eps 1e-5) and LeakyReLU(0.1), a 2 × 2
  max-pool between scales; each decoder up-samples by nearest × 2, runs a
  SAME k × k conv with reflection padding (no bias), BatchNorm and
  LeakyReLU, concatenates the encoder's features of that scale before it,
  and runs its chain; a 1 × 1 head.
* The ``real-penalty-add`` wrapper: the cascade's real channel min-max
  scaled per slice to (−1, 1), ``scale`` times the U-Net's output added,
  scaled back; the imaginary channel passes through.

It imports nothing of the program, and is given the weights by the names
of the program's module tree.
"""

import torch
import torch.nn.functional as F

from benchmark.reference import recnet

LEAK = 0.1
EPS = 1e-5


def _same_reflect(h, k):
  before = (k - 1) // 2
  after = k - 1 - before
  return F.pad(h, (before, after, before, after), mode='reflect')


def _bn_act(h, weights, name, fit=False):
  if fit:
    var, mean = torch.var_mean(h, dim=(0, 2, 3), correction=0)
    weights[name + '.running_mean'].copy_(mean)
    weights[name + '.running_var'].copy_(var)
  mean = weights[name + '.running_mean'][None, :, None, None]
  var = weights[name + '.running_var'][None, :, None, None]
  h = (h - mean) * torch.rsqrt(var + EPS) * \
      weights[name + '.weight'][None, :, None, None] + \
      weights[name + '.bias'][None, :, None, None]
  return F.leaky_relu(h, LEAK)


def _chain(h, weights, prefix, layers, k, fit, fp8):
  for i in range(layers):
    h = recnet.conv(_same_reflect(h, k), weights['{}conv_{}.weight'.format(
        prefix, i)], fp8=fp8)
    h = _bn_act(h, weights, '{}bn_{}'.format(prefix, i), fit)
  return h


def unet(section, weights, x, prefix='learnable_model.', fit=False,
         fp8=False):
  """The U-Net on (B, H, W, C): (the output (B, H, W, num_outputs), the
  magnitude its head sums: |head weight| · |features| + |head bias|).
  With ``fit`` each BatchNorm first takes its input's statistics as its
  running statistics, written into ``weights``; with ``fp8`` every conv
  runs in the control's precision."""
  k, layers = section['kernel_size'], section['num_layers_per_scale']
  enc, dec = section['encode_filters'], section['decode_filters']
  h = x.permute(0, 3, 1, 2)
  features = []
  for scale in range(len(enc)):
    h = _chain(h, weights, '{}encode_{}.'.format(prefix, scale), layers, k,
               fit, fp8)
    if scale < len(enc) - 1:
      features.append(h)
      h = F.max_pool2d(h, 2, 2)
  for scale in range(len(dec)):
    name = '{}decode_{}.'.format(prefix, scale)
    skip = features[-(scale + 1)]
    up = F.interpolate(h, scale_factor=2, mode='nearest')
    up = recnet.conv(_same_reflect(up, k), weights[name + 'up_conv.weight'],
                     fp8=fp8)
    up = _bn_act(up, weights, name + 'up_bn', fit)
    dy, dx = skip.shape[2] - up.shape[2], skip.shape[3] - up.shape[3]
    if dy or dx:
      up = F.pad(up, (0, dx, 0, dy), mode='reflect')
    h = _chain(torch.cat([skip, up], dim=1), weights, name + 'decode.',
               layers, k, fit, fp8)
  w, b = weights[prefix + 'head.weight'], weights[prefix + 'head.bias']
  out = recnet.conv(h, w, b, fp8=fp8).permute(0, 2, 3, 1)
  return out, F.conv2d(h.abs(), w.abs(), b.abs()).permute(0, 2, 3, 1)


def param_shapes(conf):
  """{name: shape} of the U-Net's convs and the cascade's parameters."""
  section = conf['generator_model']
  shapes = recnet.param_shapes(section['pretrained_model'],
                               'pretrained_model.')
  u = section['learnable_model']
  k, layers = u['kernel_size'], u['num_layers_per_scale']
  enc, dec = u['encode_filters'], u['decode_filters']
  cin = u['num_inputs']
  for scale, f in enumerate(enc):
    for i in range(layers):
      shapes['learnable_model.encode_{}.conv_{}.weight'.format(scale, i)] = \
          (f, cin, k, k)
      cin = f
  for scale, f in enumerate(dec):
    name = 'learnable_model.decode_{}.'.format(scale)
    shapes[name + 'up_conv.weight'] = (f, cin, k, k)
    cin = f + enc[-(scale + 2)]
    for i in range(layers):
      shapes[name + 'decode.conv_{}.weight'.format(i)] = (f, cin, k, k)
      cin = f
  shapes['learnable_model.head.weight'] = (u['num_outputs'], cin, 1, 1)
  return shapes


def refine(conf, weights, pre):
  """The U-Net alone on a cascade's output (B, H, W, 2), float32: (its
  output, the magnitude its head sums)."""
  with recnet.exact_f32():
    return unet(conf['generator_model']['learnable_model'], weights,
                pre.float())


def fit_batchnorm(conf, weights, inp, kspace, mask):
  """Set every BatchNorm's running statistics in ``weights`` to those of
  its input on these slices, through the reference cascade and U-Net: the
  statistics of a trained network, under which each layer's output is
  normalised (a random network's drawn statistics leave its gain, and so
  its rounding, to the seed)."""
  section = conf['generator_model']
  with torch.no_grad(), recnet.exact_f32():
    pre = recnet.forward(section['pretrained_model'], weights, inp, kspace,
                         mask, prefix='pretrained_model.')
    unet(section['learnable_model'], weights, pre, fit=True)


def forward(conf, weights, inp, kspace, mask, fp8=False):
  """{'pretrained', 'refinement', 'pred'} of the served forward, float32
  (``fp8``: every conv in the control's precision, the DC in f32)."""
  section = conf['generator_model']
  with recnet.exact_f32():
    pre = recnet.forward(section['pretrained_model'], weights, inp, kspace,
                         mask, prefix='pretrained_model.', fp8=fp8)
    refinement, _ = unet(section['learnable_model'], weights, pre,
                         fp8=fp8)
  return {'pretrained': pre, 'refinement': refinement,
          'pred': wrap(weights, pre, refinement)}


def wrap(weights, pre, refinement):
  """The real-penalty-add wrapper's prediction from a cascade output and a
  U-Net output, float32."""
  pre, refinement = pre.float(), refinement.float()
  real = pre[..., 0:1]
  low = real.amin(dim=(1, 2), keepdim=True)
  span = (real - low).amax(dim=(1, 2), keepdim=True)
  scaled = (real - low) / span * 2.0 - 1.0
  out = (scaled + weights['scale'] * refinement + 1.0) / 2.0 * span + low
  return torch.cat([out, pre[..., 1:2]], dim=-1)
