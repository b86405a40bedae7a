"""VGG19 feature extractor for the perceptual loss.

Port of ``csmri_refinement_tpu/models/vgg.py``, written by hand (the port
has no torchvision): torchvision's VGG19 ``features`` stack (3×3 convs,
padding 1, ReLU) in blocks that each end right before a max-pool, with
ImageNet mean/std normalisation of a (B, H, W, 3) input in (0, 1).

Weights come from a local file (``vgg_weights_path``: an ``.npz`` of
``features.{i}.weight/bias`` arrays or a torch state dict with those keys),
checked against torchvision's artifact (every key, every shape, and the
embedded ``__sha256__`` content hash where the file has one), or from a
seeded random init when the config opts in with ``vgg_random_init: true``;
otherwise loading raises. Submodules are named ``conv_{i}`` as in the flax
tree. With a ``dtype`` (bf16 under ``train_dtype``) the convs compute in
it and the parameters stay f32; the ImageNet normalisation runs in f32
before the first conv's cast, as in flax. Under a spatial mesh the convs
take halo rows (``layers.same_conv``) and the pools fetch the row a
rank's last pair lacks (``layers.max_pool2``), each block's rows by the
layout its pools give (``halo.Rows``); ``feature_rows`` gives the
outputs' layouts, for the loss.
"""

import hashlib
import logging
import os

import numpy as np
import torch
from torch import nn

from csmri_refinement_tpu_torch.models.layers import (max_pool2, pool_rows,
                                                     same_conv)
from csmri_refinement_tpu_torch.parallel import halo

# torchvision vgg19 cfg 'E'; 'M' = max-pool
_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
        512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M']
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

LAST_FEATURE_MAP = 4


class VGG19(nn.Module):
  """``forward(inp)``: (B, H, W, 3) in (0, 1) → the requested blocks'
  outputs, NCHW, in ascending block order."""

  LAST_FEATURE_MAP = LAST_FEATURE_MAP

  def __init__(self, output_blocks=(LAST_FEATURE_MAP,), dtype=None):
    super().__init__()
    self.output_blocks = sorted(output_blocks)
    self.dtype = dtype
    if not self.output_blocks or self.output_blocks[-1] > 5:
      raise ValueError('VGG19 output blocks must lie in 0..5')
    cin = 3
    conv_idx = 0
    for item in _CFG:
      if item != 'M':
        self.add_module('conv_{}'.format(conv_idx),
                        nn.Conv2d(cin, item, 3, padding=1))
        cin = item
        conv_idx += 1
    self.register_buffer('mean', torch.tensor(_IMAGENET_MEAN).reshape(
        1, 3, 1, 1), persistent=False)
    self.register_buffer('std', torch.tensor(_IMAGENET_STD).reshape(
        1, 3, 1, 1), persistent=False)

  @staticmethod
  def block_rows(rows):
    """The row layout of blocks 0..5 of an input of layout ``rows`` (each
    block's is its first pool's input's; None without a mesh)."""
    layouts = [rows]
    for _ in range(5):
      layouts.append(pool_rows(layouts[-1]))
    return layouts

  def feature_rows(self, inp):
    """The row layouts of ``forward(inp)``'s outputs on this rank's rows
    of the image ``inp`` (None each without a spatial mesh)."""
    layouts = self.block_rows(halo.equal_rows(inp, halo.current(), 1))
    return [layouts[b] for b in self.output_blocks]

  def forward(self, inp):
    x = (inp.permute(0, 3, 1, 2) - self.mean) / self.std
    layouts = self.block_rows(halo.equal_rows(x, halo.current(), 2))
    last = self.output_blocks[-1]
    out = []
    block_idx = conv_idx = 0
    for item in _CFG:
      if item == 'M':
        if block_idx in self.output_blocks:
          out.append(x)
        if block_idx == last:
          break
        x = max_pool2(x, layouts[block_idx])
        block_idx += 1
      else:
        conv = getattr(self, 'conv_{}'.format(conv_idx))
        dt = self.dtype or x.dtype
        x = torch.relu(same_conv(x.to(dt), conv.weight.to(dt),
                                 conv.bias.to(dt), rows=layouts[block_idx]))
        conv_idx += 1
    if last == 5:   # the pool-only block after the last conv
      out.append(x)
    return out


def _torch_layer_index(conv_idx):
  """conv counter → torchvision ``features`` index (0, 2, 5, 7, ...)."""
  idx = count = 0
  for item in _CFG:
    if item == 'M':
      idx += 1
      continue
    if count == conv_idx:
      return idx
    idx += 2
    count += 1
  raise ValueError(conv_idx)


def expected_vgg19_artifact():
  """{torchvision key: OIHW/bias shape} of every tensor a weights file
  must hold."""
  shapes = {}
  conv_idx, cin = 0, 3
  for item in _CFG:
    if item == 'M':
      continue
    ti = _torch_layer_index(conv_idx)
    shapes['features.{}.weight'.format(ti)] = (item, cin, 3, 3)
    shapes['features.{}.bias'.format(ti)] = (item,)
    cin = item
    conv_idx += 1
  return shapes


def vgg19_content_hash(raw):
  """sha256 over the key-sorted f32 weight bytes (the JAX package's
  ``vgg19_content_hash``)."""
  h = hashlib.sha256()
  for key in sorted(expected_vgg19_artifact()):
    h.update(np.ascontiguousarray(np.asarray(raw[key], np.float32)).tobytes())
  return h.hexdigest()


def validate_vgg19_raw(raw, path):
  """Raise unless ``raw`` holds every tensor of the artifact at its shape
  and, where it records one, its content hash."""
  problems = []
  for key, shape in expected_vgg19_artifact().items():
    if key not in raw:
      problems.append('missing {}'.format(key))
    elif tuple(np.asarray(raw[key]).shape) != shape:
      problems.append('{}: shape {} != expected {}'.format(
          key, tuple(np.asarray(raw[key]).shape), shape))
  if problems:
    raise ValueError('VGG19 weights file {!r} does not match the '
                     'torchvision vgg19 artifact:\n  '.format(path) +
                     '\n  '.join(problems))
  if '__sha256__' in raw:
    want = str(np.asarray(raw['__sha256__']).item())
    got = vgg19_content_hash(raw)
    if got != want:
      raise ValueError('VGG19 weights file {!r} failed its content hash: '
                       'sha256 {} != recorded {}'.format(path, got, want))


def _load_raw(path):
  if path.endswith('.npz'):
    with np.load(path) as data:
      return dict(data)
  state = torch.load(path, map_location='cpu', weights_only=True)
  return {k: v.numpy() for k, v in state.items()
          if k.startswith('features.')}


def load_vgg19_params(weights_path=None, conf_path=None,
                      allow_random_init=False, seed=0,
                      output_blocks=(LAST_FEATURE_MAP,), dtype=None):
  """A frozen ``VGG19`` computing in ``dtype``, in eval mode, on the CPU:
  its weights from ``weights_path`` (relative to the config file), or a
  seeded random init (LeCun normal truncated at 2σ, zero bias, as flax's
  default) when ``allow_random_init``."""
  model = VGG19(output_blocks, dtype)
  if weights_path is None:
    if not allow_random_init:
      raise ValueError(
          'VGG19 perceptual loss requires pretrained weights: set '
          '"vgg_weights_path" to a converted weights file, or set '
          '"vgg_random_init": true to accept a seeded random init '
          '(functional but not ImageNet-calibrated).')
    logging.warning('VGG19: seeded random init (vgg_random_init): the '
                    'perceptual loss is not ImageNet-calibrated')
    gen = torch.Generator().manual_seed(seed)
    for conv in model.children():
      std = (1.0 / conv.weight[0].numel()) ** 0.5 / .87962566103423978
      with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                              generator=gen)
        conv.bias.zero_()
  else:
    if not os.path.isabs(weights_path) and conf_path:
      weights_path = os.path.join(os.path.dirname(conf_path), weights_path)
    raw = _load_raw(weights_path)
    validate_vgg19_raw(raw, weights_path)
    for conv_idx, conv in enumerate(model.children()):
      ti = _torch_layer_index(conv_idx)
      with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(
            raw['features.{}.weight'.format(ti)], np.float32)))
        conv.bias.copy_(torch.from_numpy(np.asarray(
            raw['features.{}.bias'.format(ti)], np.float32)))
    logging.info('Loaded VGG19 weights from %s', weights_path)
  return model.eval().requires_grad_(False)
