"""CNN discriminator (PatchGAN or FC head).

Port of ``csmri_refinement_tpu/models/discriminators.py``:

* a conv stack with per-layer filters, kernels and strides, SAME padding
  (zero, reflection, replication; stride 2 pads ceil((k − 1) / 2)), batch
  or instance(-affine) norm with the ``not-first`` option, lrelu, prelu or
  relu, and ``Dropout2d`` after the layers in ``dropout_after``;
* a head of FC layers, or a PatchGAN ``final_conv_kernel_size`` conv
  without padding, optionally averaged over space;
* the output ``{prob, logits[, features]}``, NHWC as in JAX; the features
  are the maps after each activation (and each FC layer, and the head),
  for the feature-matching loss.

Default init: conv and linear weights normal(0, 0.02), BN scale
normal(1, 0.02); ``weight_init.final_layer_bias`` sets the head's bias.
BatchNorm is the U-Net's (momentum 0.1 = flax's 0.9, biased running
variance), computed in f32. The FC head's input width comes from
``spatial_shape`` (the input's (H, W), a key the reference model takes
too): flax infers it at trace time, a torch module needs it when built.
Submodule names follow the flax tree (``conv_{i}``, ``norm_{i}``,
``prelu_{i}``, ``fc_{i}``, ``final_conv``).

Under a spatial mesh (``parallel/halo.py``) the conv stack runs on the
rank's rows (the stride-2 reflection convs through ``layers.same_conv``'s
halos, each layer's output rows by the layout ``halo.Rows.strided`` gives
it, so that a stride that splits a rank's rows leaves the ranks unequal
blocks; BN over the world, instance norm and dropout as ``layers`` has
them), and so are its ``features``, whose layouts the output gives under
``feature_rows`` for the feature-matching loss. The head needs every row:
the rows are gathered before it (``halo.gather_rows``), so that the
PatchGAN conv (VALID, its output rows not a multiple of the ranks) or the
FC head's flatten sees the whole map, and every rank of the spatial group
holds the whole ``prob``, ``logits`` and head feature
(``parallel/mesh.py``'s ``WHOLE_KEYS``).
"""

import torch
from torch import nn

from csmri_refinement_tpu_torch.models import weight_inits
from csmri_refinement_tpu_torch.models.layers import (
    InstanceNorm, PReLU, channel_dropout, conv_rows, leaky_relu, need_bias,
    pad_sizes, same_conv)
from csmri_refinement_tpu_torch.models.unet import BatchNorm2d
from csmri_refinement_tpu_torch.parallel import halo

DEFAULT_RELU_LEAKINESS = 0.2
NORM_LAYERS = ('batch', 'instance', 'instance-affine')
# The constructor's config keys (JAX REQUIRED_PARAMS + OPTIONAL_PARAMS).
PARAMS = (
    'num_inputs', 'num_filters_per_layer', 'strides', 'kernel_sizes',
    'fc_layers', 'spatial_shape', 'act_fn', 'relu_leakiness',
    'use_norm_layers', 'norm_layer', 'padding', 'final_conv_kernel_size',
    'final_average_pooling', 'use_biases', 'compute_features',
    'dropout_after', 'dropout_prob')


def _nhwc(x):
  return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


class CNNDiscriminator(nn.Module):
  """``forward(inp, generator=None)``: (B, H, W, num_inputs) → {prob,
  logits[, features]}; ``generator`` draws the dropout decisions in train
  mode, of the global batch with ``batch_shard`` (``layers.channel_dropout``,
  set by a data-parallel runner)."""

  batch_shard = None

  def __init__(self, num_inputs, num_filters_per_layer, strides,
               kernel_sizes=None, fc_layers=(), spatial_shape=None,
               act_fn='lrelu', relu_leakiness=DEFAULT_RELU_LEAKINESS,
               use_norm_layers=True, norm_layer='batch', padding='zero',
               final_conv_kernel_size=1, final_average_pooling=False,
               use_biases=True, compute_features=False, dropout_after=(),
               dropout_prob=0.5, weight_init=None, dtype=None):
    super().__init__()
    if kernel_sizes is None:
      kernel_sizes = 3
    if isinstance(kernel_sizes, int):
      kernel_sizes = [kernel_sizes] * len(num_filters_per_layer)
    if not len(num_filters_per_layer) == len(strides) == len(kernel_sizes):
      raise ValueError('num_filters_per_layer, strides and kernel_sizes '
                       'differ in length')
    if act_fn not in ('relu', 'lrelu', 'prelu'):
      raise ValueError('Unknown activation {}'.format(act_fn))
    if use_norm_layers and norm_layer not in NORM_LAYERS:
      raise ValueError('Unknown normalization layer {}'.format(norm_layer))
    self.act_fn = act_fn
    self.relu_leakiness = relu_leakiness
    self.padding = padding
    self.kernel_sizes = list(kernel_sizes)
    self.strides = list(strides)
    self.fc_layers = list(fc_layers)
    self.final_average_pooling = final_average_pooling
    self.compute_features = compute_features
    self.dropout_after = set(dropout_after)
    self.dropout_prob = dropout_prob
    self.weight_init = weight_init or {}
    self.dtype = dtype
    self.num_layers = len(num_filters_per_layer)

    use_norm = use_norm_layers
    self.normed = []
    cin = num_inputs
    size = tuple(spatial_shape) if spatial_shape is not None else None
    for idx, (cout, k, stride) in enumerate(zip(num_filters_per_layer,
                                                kernel_sizes, strides)):
      bias = use_biases and need_bias(use_norm, norm_layer)
      self.add_module('conv_{}'.format(idx),
                      nn.Conv2d(cin, cout, k, stride=stride, bias=bias))
      if use_norm and use_norm != 'not-first':
        self.add_module('norm_{}'.format(idx), BatchNorm2d(
            cout, eps=1e-5, momentum=0.1) if norm_layer == 'batch' else
                        InstanceNorm(cout, norm_layer == 'instance-affine'))
        self.normed.append(True)
      else:
        self.normed.append(False)
        if use_norm == 'not-first':
          use_norm = True
      if act_fn == 'prelu':
        self.add_module('prelu_{}'.format(idx), PReLU(cout, relu_leakiness))
      if size is not None:
        p1, p2 = pad_sizes(k, stride=stride)
        size = tuple((s + p1 + p2 - k) // stride + 1 for s in size)
      cin = cout

    if self.fc_layers:
      if size is None:
        raise ValueError('an FC head needs the input\'s spatial_shape')
      features = cin * size[0] * size[1]
      for fc_idx, num_features in enumerate(self.fc_layers):
        last = fc_idx == len(self.fc_layers) - 1
        self.add_module('fc_{}'.format(fc_idx), nn.Linear(
            features, num_features, bias=use_biases or last))
        if act_fn == 'prelu' and not last:
          self.add_module('prelu_fc_{}'.format(fc_idx),
                          PReLU(num_features, relu_leakiness))
        features = num_features
    else:
      self.final_conv = nn.Conv2d(cin, 1, final_conv_kernel_size,
                                  bias=use_biases)

  def init_weights(self, generator):
    """Seeded init: normal(0, 0.02) conv and linear weights, BN scale
    normal(1, 0.02), unless the config overrides them."""
    inits = weight_inits.resolve_inits(
        {'conv_weight': ('normal', 0.0, 0.02),
         'linear_weight': ('normal', 0.0, 0.02),
         'batchnorm_weight': ('normal', 1.0, 0.02)}, self.weight_init)
    final = self.final_conv if not self.fc_layers else \
        getattr(self, 'fc_{}'.format(len(self.fc_layers) - 1))
    for module in self.modules():
      kind = 'conv' if isinstance(module, nn.Conv2d) else \
          'linear' if isinstance(module, nn.Linear) else None
      if kind is not None:
        weight_inits.init_(module.weight, inits[kind + '_weight'], generator)
        if module.bias is not None:
          spec = inits.get('final_layer_bias') if module is final else None
          spec = spec and weight_inits.direct_spec(spec, 'final_layer_bias')
          weight_inits.init_(module.bias, spec or inits[kind + '_bias'],
                             generator)
      elif isinstance(module, nn.BatchNorm2d):
        weight_inits.init_(module.weight, weight_inits.direct_spec(
            inits['batchnorm_weight'], 'batchnorm_weight'), generator)
        module.bias.data.zero_()
        module.reset_running_stats()
      elif isinstance(module, PReLU):
        module.slope.data.fill_(self.relu_leakiness)
      elif isinstance(module, InstanceNorm) and module.scale is not None:
        module.scale.data.fill_(1.0)
        module.bias.data.zero_()

  def _act(self, x, name):
    if self.act_fn == 'relu':
      return torch.relu(x)
    if self.act_fn == 'lrelu':
      return leaky_relu(x, self.relu_leakiness)
    return getattr(self, 'prelu_' + name)(x)

  def forward(self, inp, generator=None):
    dt = self.dtype or inp.dtype
    x = inp.to(dt).permute(0, 3, 1, 2)
    mesh = halo.current()
    rows = halo.equal_rows(x, mesh, 2)
    features, feature_rows = [], []
    for idx in range(self.num_layers):
      conv = getattr(self, 'conv_{}'.format(idx))
      bias = None if conv.bias is None else conv.bias.to(dt)
      x = same_conv(x, conv.weight.to(dt), bias, self.padding,
                    stride=self.strides[idx], rows=rows)
      rows = conv_rows(rows, self.kernel_sizes[idx],
                       stride=self.strides[idx])
      if self.normed[idx]:
        x = getattr(self, 'norm_{}'.format(idx))(
            x.to(torch.promote_types(dt, torch.float32))).to(dt)
      x = self._act(x, str(idx))
      if self.compute_features:
        features.append(_nhwc(x))
        feature_rows.append(rows)
      if idx in self.dropout_after:
        x = channel_dropout(x, self.dropout_prob, self.training, generator,
                            self.batch_shard)

    if mesh is not None:
      x = halo.gather_rows(x, mesh, rows=rows)
    if self.fc_layers:
      x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
      for fc_idx in range(len(self.fc_layers)):
        fc = getattr(self, 'fc_{}'.format(fc_idx))
        x = torch.nn.functional.linear(
            x, fc.weight.to(dt), None if fc.bias is None else fc.bias.to(dt))
        if fc_idx < len(self.fc_layers) - 1:
          x = self._act(x, 'fc_{}'.format(fc_idx))
        if self.compute_features:
          features.append(x)
    else:
      conv = self.final_conv
      x = torch.nn.functional.conv2d(
          x, conv.weight.to(dt), None if conv.bias is None else
          conv.bias.to(dt))
      if self.final_average_pooling:
        x = x.mean(dim=(2, 3), keepdim=True)
      x = _nhwc(x)
      if self.compute_features:
        features.append(x)

    out = {'prob': torch.sigmoid(x), 'logits': x}
    if self.compute_features:
      out['features'] = features
      if mesh is not None:   # the head's features are whole on every rank
        out['feature_rows'] = feature_rows + [None] * (
            len(features) - len(feature_rows))
    return out
