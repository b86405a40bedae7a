"""Import reference (PyTorch 0.3) checkpoints and torchvision VGG19 weights.

Port of ``csmri_refinement_tpu/utils/torch_import.py``. Users of the
reference train RecNet, UNET and discriminator weights with torch; the
converters below map those state dicts onto the flax variable trees of the
JAX package (numpy leaves, the same trees the JAX converters give), which
the port loads through its one layout mapping,
``utils/jax_weights.py::load_flax_variables``.

Key names follow the reference's module constructors:

* RecNet: ``conv_blocks.{b}.layers.{i}`` Sequentials of
  [pad, conv, lrelu]×(num_convs−1) + [pad, conv] → conv j at index 3j+1;
* UNET: ``encode_units.{s}.encode.{i}`` ([pad, conv, bn?, act?] per
  layer), ``concat_decode_units.{s}`` / ``decode_units.{s}`` with
  ``upsample.{i}`` (by up-sampling mode) and ``decode`` (a conv encode
  unit at the tail), ``head.0``;
* CNNDiscriminator: ``convs.{i}`` ([pad, conv, norm?, act, dropout?] per
  layer, the ``not-first`` skip), ``final_conv.0`` / ``fcs.{i}`` heads.

Layouts: torch conv weights OIHW → flax HWIO; ConvTranspose2d IOHW →
HWIO flipped in both spatial axes; linear (out, in) → (in, out).

``convert_reference_checkpoint`` writes a port checkpoint (``torch.save``:
``{'conf', 'runner', 'epoch', 'best_val_metrics'}``, each network a flax
tree of tensors), which ``validate``, ``--resume`` and
``pretrained_weights`` read; ``convert_vgg19`` writes the ``.npz`` (with
its ``__sha256__``) that ``models/vgg.py`` checks. CLI::

    python -m csmri_refinement_tpu_torch.utils.torch_import \
        --vgg19 vgg19.pth vgg19.npz
    python -m csmri_refinement_tpu_torch.utils.torch_import \
        --checkpoint CONFIG IN_PTH OUT_CKPT [--fc-spatial-shape H W]
"""

import argparse
import sys
import types

import numpy as np
import torch

from csmri_refinement_tpu_torch.models.vgg import (validate_vgg19_raw,
                                                   vgg19_content_hash)


def _np(tensor):
  if hasattr(tensor, 'detach'):
    return tensor.detach().cpu().numpy()
  return np.asarray(tensor)


def _conv_w(t):
  return np.transpose(_np(t), (2, 3, 1, 0))  # OIHW → HWIO


def _convt_w(t):
  # torch ConvTranspose2d: (in, out, kh, kw); flax ConvTranspose kernel is
  # (kh, kw, in, out) applied as fractionally-strided conv without flip →
  # flip spatial dims to match torch semantics.
  w = np.transpose(_np(t), (2, 3, 0, 1))
  return w[::-1, ::-1]


def _linear_w(t):
  return np.transpose(_np(t), (1, 0))


def _bn(state_dict, prefix):
  params = {}
  if prefix + '.weight' in state_dict:
    params['scale'] = _np(state_dict[prefix + '.weight'])
  if prefix + '.bias' in state_dict:
    params['bias'] = _np(state_dict[prefix + '.bias'])
  stats = {}
  if prefix + '.running_mean' in state_dict:
    stats['mean'] = _np(state_dict[prefix + '.running_mean'])
    stats['var'] = _np(state_dict[prefix + '.running_var'])
  return params, stats


def _conv(state_dict, prefix):
  out = {'kernel': _conv_w(state_dict[prefix + '.weight'])}
  if prefix + '.bias' in state_dict:
    out['bias'] = _np(state_dict[prefix + '.bias'])
  return out


def convert_recnet(state_dict, num_blocks, num_convs):
  """Reference RecNet state dict → {'params': ...} of a RecNet."""
  params = {}
  for b in range(num_blocks):
    block = {}
    for j in range(num_convs):
      torch_idx = 3 * j + 1  # [pad, conv, lrelu] triplets
      prefix = 'conv_blocks.{}.layers.{}'.format(b, torch_idx)
      block['conv_{}'.format(j)] = _conv(state_dict, prefix)
    params['block_{}'.format(b)] = block
  return {'params': params, 'batch_stats': {}}


def _convert_encode_unit(state_dict, prefix, num_layers, use_bn,
                         use_act=True):
  """ConvEncodeUnit: ``{prefix}.encode.{i}`` → our conv_{j}/bn_{j}."""
  params = {}
  stats = {}
  stride = 2 + (1 if use_bn else 0) + (1 if use_act else 0)
  for j in range(num_layers):
    conv_idx = j * stride + 1
    params['conv_{}'.format(j)] = _conv(
        state_dict, '{}.encode.{}'.format(prefix, conv_idx))
    if use_bn:
      bn_p, bn_s = _bn(state_dict, '{}.encode.{}'.format(prefix,
                                                         conv_idx + 1))
      params['bn_{}'.format(j)] = bn_p
      if bn_s:
        stats['bn_{}'.format(j)] = bn_s
  return params, stats


def _convert_decode_unit(state_dict, prefix, num_layers, use_bn,
                         upsampling_mode, act_upsampling_only):
  params = {}
  stats = {}

  # upsample path (unet.py:81-113)
  if upsampling_mode == 'transposed':
    up_conv_idx = 0
    params['up_conv'] = {
        'kernel': _convt_w(state_dict['{}.upsample.0.weight'.format(prefix)])
    }
    if '{}.upsample.0.bias'.format(prefix) in state_dict:
      params['up_conv']['bias'] = _np(
          state_dict['{}.upsample.0.bias'.format(prefix)])
  elif upsampling_mode == 'pixelshuffle':
    up_conv_idx = 1
    params['up_conv'] = _conv(state_dict,
                              '{}.upsample.{}'.format(prefix, up_conv_idx))
  elif upsampling_mode in ('nn-resize-conv', 'nn-biresize-conv'):
    up_conv_idx = 2
    params['up_conv'] = _conv(state_dict,
                              '{}.upsample.{}'.format(prefix, up_conv_idx))
  else:
    up_conv_idx = None  # nn / bilinear: no conv in the upsample path

  if act_upsampling_only and use_bn and up_conv_idx is not None:
    bn_p, bn_s = _bn(state_dict,
                     '{}.upsample.{}'.format(prefix, up_conv_idx + 1))
    params['up_bn'] = bn_p
    if bn_s:
      stats['up_bn'] = bn_s

  # decode tail: [bn?, act?] when not act_upsampling_only, then
  # ConvEncodeUnit (unet.py:104-129)
  decode_idx = 0
  if not act_upsampling_only and use_bn:
    bn_p, bn_s = _bn(state_dict, '{}.decode.0'.format(prefix))
    params['merge_bn'] = bn_p
    if bn_s:
      stats['merge_bn'] = bn_s
    decode_idx = 1
  if not act_upsampling_only:
    decode_idx += 1  # the activation module
  if num_layers > 0:
    sub_params, sub_stats = _convert_encode_unit(
        state_dict, '{}.decode.{}'.format(prefix, decode_idx), num_layers,
        use_bn)
    params['decode'] = sub_params
    if sub_stats:
      stats['decode'] = sub_stats
  return params, stats


def convert_unet(state_dict, num_layers_per_scale, encode_filters,
                 decode_filters, use_bn=True, upsampling_mode='transposed',
                 decoder_act_upsampling_only=False):
  """Reference UNET state dict → the flax variables of a UNET."""
  params = {}
  stats = {}

  for s in range(len(encode_filters)):
    p, st = _convert_encode_unit(state_dict, 'encode_units.{}'.format(s),
                                 num_layers_per_scale, use_bn)
    params['encode_{}'.format(s)] = p
    if st:
      stats['encode_{}'.format(s)] = st

  num_concat = min(len(decode_filters), len(encode_filters) - 1)
  for s in range(num_concat):
    p, st = _convert_decode_unit(
        state_dict, 'concat_decode_units.{}'.format(s),
        num_layers_per_scale, use_bn, upsampling_mode,
        decoder_act_upsampling_only)
    params['decode_{}'.format(s)] = p
    if st:
      stats['decode_{}'.format(s)] = st

  for s in range(len(decode_filters) - num_concat):
    p, st = _convert_decode_unit(
        state_dict, 'decode_units.{}'.format(s), num_layers_per_scale,
        use_bn, upsampling_mode, decoder_act_upsampling_only)
    params['up_decode_{}'.format(s)] = p
    if st:
      stats['up_decode_{}'.format(s)] = st

  params['head'] = _conv(state_dict, 'head.0')
  return {'params': params, 'batch_stats': stats}


def convert_discriminator(state_dict, num_filters_per_layer,
                          use_norm_layers='not-first', norm_layer='batch',
                          act_fn='lrelu', dropout_after=(), fc_layers=(),
                          conv_output_shape=None):
  """Reference CNNDiscriminator state dict → flax variables.

  ``conv_output_shape``: (H, W) spatial shape of the conv stack output,
  required when ``fc_layers`` is non-empty — torch flattens NCHW (C-major)
  but flax flattens NHWC (C-minor), so the first linear layer's input
  features must be permuted accordingly.
  """
  params = {}
  stats = {}
  idx = 0  # torch Sequential index
  use_norm = use_norm_layers
  for layer, _ in enumerate(num_filters_per_layer):
    idx += 1  # padding module
    params['conv_{}'.format(layer)] = _conv(state_dict,
                                            'convs.{}'.format(idx))
    idx += 1
    if use_norm != 'not-first' and use_norm:
      if norm_layer == 'batch':
        bn_p, bn_s = _bn(state_dict, 'convs.{}'.format(idx))
        params['norm_{}'.format(layer)] = bn_p
        if bn_s:
          stats['norm_{}'.format(layer)] = bn_s
      idx += 1
    elif use_norm == 'not-first':
      use_norm = True
    idx += 1  # activation
    if layer in dropout_after:
      idx += 1

  if fc_layers:
    assert conv_output_shape is not None, \
        'conv_output_shape=(H, W) is required to convert FC-head ' \
        'discriminators (torch flattens CHW, flax flattens HWC)'
    # fcs Sequential: [Linear, act] pairs then the final Linear → the i-th
    # Linear sits at torch index 2i (discriminators.py:160-166)
    for i in range(len(fc_layers)):
      torch_idx = 2 * i
      w = _np(state_dict['fcs.{}.weight'.format(torch_idx)])  # (out, in)
      if i == 0:
        h, wd = conv_output_shape
        c = num_filters_per_layer[-1]
        # (out, C·H·W) → (out, H·W·C) to match the NHWC flatten
        w = w.reshape(w.shape[0], c, h, wd).transpose(0, 2, 3, 1) \
             .reshape(w.shape[0], -1)
      params['fc_{}'.format(i)] = {
          'kernel': np.transpose(w, (1, 0)),
          'bias': _np(state_dict['fcs.{}.bias'.format(torch_idx)]),
      }
  elif 'final_conv.0.weight' in state_dict:
    params['final_conv'] = _conv(state_dict, 'final_conv.0')

  return {'params': params, 'batch_stats': stats}


def convert_refinement_wrapper(state_dict, recnet_kwargs, unet_kwargs):
  """Reference RefinementWrapper state dict → the flax variables of a
  RefinementWrapper (frozen RecNet + learnable UNET).

  recnet_kwargs: dict(num_blocks=, num_convs=) for the pretrained subtree;
  unet_kwargs: the convert_unet keyword args for the learnable subtree.
  """
  def sub(prefix):
    plen = len(prefix)
    return {k[plen:]: v for k, v in state_dict.items()
            if k.startswith(prefix)}

  pre = convert_recnet(sub('pretrained_model.'), **recnet_kwargs)
  learn = convert_unet(sub('learnable_model.'), **unet_kwargs)
  params = {
      'pretrained_model': pre['params'],
      'learnable_model': learn['params'],
  }
  if 'scale' in state_dict:
    params['scale'] = _np(state_dict['scale'])
  stats = {}
  if pre.get('batch_stats'):
    stats['pretrained_model'] = pre['batch_stats']
  if learn.get('batch_stats'):
    stats['learnable_model'] = learn['batch_stats']
  return {'params': params, 'batch_stats': stats}


def convert_vgg19(state_dict_or_path, out_npz_path):
  """torchvision ``vgg19`` weights (a state dict, a module, or a file
  ``torch.load`` reads) → the ``.npz`` of ``features.{i}.weight/bias``
  arrays, with their content hash under ``__sha256__``, that
  ``models/vgg.py::load_vgg19_params`` reads (``vgg_weights_path``).
  Returns the npz's keys."""
  if isinstance(state_dict_or_path, str):
    state = torch.load(state_dict_or_path, map_location='cpu',
                       weights_only=True)
  else:
    state = state_dict_or_path
  if hasattr(state, 'state_dict'):
    state = state.state_dict()
  features = {k: _np(v) for k, v in state.items()
              if k.startswith('features.')}
  if not features:
    raise ValueError('No features.* keys found — not a torchvision VGG '
                     'state dict')
  digest = vgg19_content_hash(features)
  features['__sha256__'] = np.asarray(digest)
  validate_vgg19_raw(features, out_npz_path)
  np.savez(out_npz_path, **features)
  print('vgg19 content sha256:', digest)
  return sorted(features)


def load_torch_state_dict(path):
  """Load a torch-saved checkpoint, the reference's pickled
  ``utils.config.Configuration`` stubbed in. Unpickles arbitrary objects:
  read only files of a trusted reference run."""
  if 'utils' not in sys.modules or not hasattr(sys.modules.get('utils'),
                                               'config'):
    utils_mod = sys.modules.get('utils', types.ModuleType('utils'))
    config_mod = types.ModuleType('utils.config')

    class Configuration:  # noqa: N801 — matches the pickled class name
      pass

    config_mod.Configuration = Configuration
    utils_mod.config = config_mod
    sys.modules.setdefault('utils', utils_mod)
    sys.modules['utils.config'] = config_mod

  return torch.load(path, map_location='cpu', weights_only=False)


def _tensors(tree):
  """A flax tree's numpy leaves as tensors (contiguous copies)."""
  if isinstance(tree, dict):
    return {k: _tensors(v) for k, v in tree.items()}
  return torch.from_numpy(np.ascontiguousarray(tree))


def convert_reference_checkpoint(torch_path, out_path, model_specs):
  """Convert a reference training or deployed checkpoint file into a port
  checkpoint at ``out_path``; returns it.

  ``model_specs``: {runner key: (kind, kwargs)}, kind one of ``'recnet'``,
  ``'unet'``, ``'discriminator'``, ``'refinement_wrapper'``, e.g.
  ``{'model': ('recnet', {'num_blocks': 3, 'num_convs': 3})}``
  (``specs_from_config`` builds them from a training config). Runner keys
  absent from the file are skipped (a deployed reference checkpoint holds
  the model or generator only). Optimizer state is not converted: a
  resumed run starts its optimizers afresh.
  """
  checkpoint = load_torch_state_dict(torch_path)
  runner_state = checkpoint.get('runner', checkpoint)
  converters = {
      'recnet': convert_recnet,
      'unet': convert_unet,
      'discriminator': convert_discriminator,
      'refinement_wrapper': convert_refinement_wrapper,
  }
  out_runner = {}
  for key, (kind, kwargs) in model_specs.items():
    if key not in runner_state:
      print('torch_import: runner key {!r} not in checkpoint '
            '(deployed/stripped file?) — skipped'.format(key))
      continue
    out_runner[key] = _tensors(converters[kind](runner_state[key], **kwargs))

  out = {'conf': {}, 'runner': out_runner,
         'epoch': int(checkpoint.get('epoch', 0)), 'best_val_metrics': {}}
  torch.save(out, out_path)
  return out


def _unet_convert_kwargs(section):
  """convert_unet kwargs from a UNET model-config section (dict)."""
  return {
      'num_layers_per_scale': section['num_layers_per_scale'],
      'encode_filters': section['encode_filters'],
      'decode_filters': section['decode_filters'],
      'use_bn': section.get('use_bn', True),
      'upsampling_mode': section.get('upsampling_mode', 'transposed'),
      'decoder_act_upsampling_only':
          section.get('decoder_act_upsampling_only', False),
  }


def _spec_from_model_section(section, fc_spatial_shape=None):
  """(kind, kwargs) for one model-config section (dict with 'name')."""
  name = section.get('name', 'CNNDiscriminator')
  if name == 'RecNet':
    return ('recnet', {'num_blocks': section['num_blocks'],
                       'num_convs': section['num_convs']})
  if name == 'UNET':
    return ('unet', _unet_convert_kwargs(section))
  if name == 'RefinementWrapper':
    pre = section['pretrained_model']
    learn = section['learnable_model']
    if pre.get('name') != 'RecNet' or learn.get('name') != 'UNET':
      raise ValueError('Only RecNet+UNET RefinementWrapper checkpoints are '
                       'convertible (got {}/{})'.format(pre.get('name'),
                                                        learn.get('name')))
    return ('refinement_wrapper', {
        'recnet_kwargs': {'num_blocks': pre['num_blocks'],
                          'num_convs': pre['num_convs']},
        'unet_kwargs': _unet_convert_kwargs(learn),
    })
  if name == 'CNNDiscriminator':
    kwargs = {
        'num_filters_per_layer': section['num_filters_per_layer'],
        'use_norm_layers': section.get('use_norm_layers', True),
        'norm_layer': section.get('norm_layer', 'batch'),
        'dropout_after': section.get('dropout_after', ()),
        'fc_layers': section.get('fc_layers', ()),
    }
    if kwargs['fc_layers']:
      if fc_spatial_shape is None:
        raise ValueError(
            'FC-head discriminators need --fc-spatial-shape H W (the conv '
            'stack output shape; torch flattens CHW, flax flattens HWC)')
      kwargs['conv_output_shape'] = tuple(fc_spatial_shape)
    return ('discriminator', kwargs)
  raise ValueError('No torch converter for model {!r}'.format(name))


def specs_from_config(conf, fc_spatial_shape=None):
  """``convert_reference_checkpoint`` model_specs from a training config,
  keyed as the runners' state dicts (and the reference's): 'model' for
  the standard runner, 'generator' and 'discriminator' for the
  adversarial one."""
  runner_type = conf.get_attr('runner_type', default='standard')
  if runner_type == 'standard':
    return {'model': _spec_from_model_section(conf.get_attr('model'))}
  if runner_type == 'adversarial':
    specs = {
        'generator': _spec_from_model_section(
            conf.get_attr('generator_model', alternative='model')),
    }
    disc = conf.get_attr('discriminator_model', default=None)
    if disc is not None:
      specs['discriminator'] = _spec_from_model_section(
          dict(disc, name=disc.get('name', 'CNNDiscriminator')),
          fc_spatial_shape=fc_spatial_shape)
    return specs
  raise ValueError('Unknown runner_type {!r}'.format(runner_type))


def main(argv=None):
  parser = argparse.ArgumentParser(
      description='Convert reference torch weights to the port')
  parser.add_argument('--vgg19', nargs=2, metavar=('IN_PTH', 'OUT_NPZ'),
                      help='Convert a torchvision vgg19 state dict to the '
                           'npz consumed by vgg_weights_path')
  parser.add_argument('--checkpoint', nargs=3,
                      metavar=('CONFIG', 'IN_PTH', 'OUT_CKPT'),
                      help='Convert a reference training/deployed '
                           'checkpoint, deriving the model architecture '
                           'from a training config JSON; the output loads '
                           'with validate / --resume / pretrained_weights')
  parser.add_argument('--fc-spatial-shape', nargs=2, type=int, default=None,
                      metavar=('H', 'W'),
                      help='Conv-stack output shape, required only for '
                           'FC-head discriminators')
  args = parser.parse_args(argv)
  if args.vgg19:
    keys = convert_vgg19(args.vgg19[0], args.vgg19[1])
    print('Wrote {} arrays to {}'.format(len(keys), args.vgg19[1]))
  elif args.checkpoint:
    from csmri_refinement_tpu_torch.utils.config import Configuration
    conf_path, in_path, out_path = args.checkpoint
    conf = Configuration.from_json(conf_path)
    specs = specs_from_config(conf, fc_spatial_shape=args.fc_spatial_shape)
    out = convert_reference_checkpoint(in_path, out_path, specs)
    print('Wrote {} (runner keys: {}, epoch {})'.format(
        out_path, ', '.join(sorted(out['runner'])) or 'none', out['epoch']))
  else:
    parser.print_help()


if __name__ == '__main__':
  main()
