"""Weight bridge: load a flax variable tree into a port module.

``variables`` is the JAX package's ``{'params': ..., 'batch_stats': ...}``
tree as nested dicts of numpy arrays (e.g. ``jax.tree_util.tree_map(
np.asarray, variables)``, or a network of a JAX checkpoint as
``utils/flax_msgpack.py`` decodes it; a ``bfloat16`` leaf may be a torch
tensor). The port's submodules carry the flax names
(``block_{i}.conv_{j}``, ``encode_{s}.bn_{i}``, ``decode_{s}.up_conv``,
``head``, ``pretrained_model``, ``scale``, ...), so loading is a 1:1 walk:

* a conv's ``kernel`` (HWIO) becomes ``weight`` (OIHW), ``bias`` stays;
* a ``ConvTranspose`` ``kernel`` (k, k, Cin, Cout) becomes an
  ``nn.ConvTranspose2d`` ``weight`` (Cin, Cout, k, k) flipped in both
  spatial axes: flax applies the kernel unflipped
  (``transpose_kernel=False``), torch's ``conv_transpose2d`` is the adjoint
  of a correlation, which flips it;
* a ``Dense`` ``kernel`` (in, out) becomes an ``nn.Linear`` ``weight``
  (out, in);
* a BatchNorm's ``scale``/``bias`` become ``weight``/``bias``, its
  ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``;
* a module's own parameters load by name: the wrapper's ``scale``, a
  PReLU's ``slope``, an instance norm's ``scale``/``bias``.

Every tensor of the module must be found and every leaf of the tree used;
anything else raises. A RecNet saved with ``use_scan`` holds its blocks
stacked under ``blocks``: that layout is not ported yet and raises by
name.
"""

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix + (key,)


def _copy(dst, value, path):
  value = value.detach().clone() if isinstance(value, torch.Tensor) else \
      torch.from_numpy(np.array(value))
  if tuple(value.shape) != tuple(dst.shape):
    raise ValueError('{}: flax shape {} does not fit {}'.format(
        '/'.join(path), tuple(value.shape), tuple(dst.shape)))
  with torch.no_grad():
    dst.copy_(value)


def _load(module, params, stats, path, used):
  def take(tree, key, kind):
    if key not in tree:
      raise KeyError('missing flax {} {}'.format(kind, '/'.join(path + (key,))))
    used.add((kind,) + path + (key,))
    return tree[key]

  if isinstance(module, nn.Conv2d):
    _copy(module.weight, np.transpose(take(params, 'kernel', 'params'),
                                      (3, 2, 0, 1)), path)
    if module.bias is not None:
      _copy(module.bias, take(params, 'bias', 'params'), path)
    return
  if isinstance(module, nn.ConvTranspose2d):
    kernel = np.flip(take(params, 'kernel', 'params'), (0, 1))
    _copy(module.weight, np.transpose(kernel, (2, 3, 0, 1)), path)
    if module.bias is not None:
      _copy(module.bias, take(params, 'bias', 'params'), path)
    return
  if isinstance(module, nn.Linear):
    _copy(module.weight, np.transpose(take(params, 'kernel', 'params')),
          path)
    if module.bias is not None:
      _copy(module.bias, take(params, 'bias', 'params'), path)
    return
  if isinstance(module, nn.BatchNorm2d):
    _copy(module.weight, take(params, 'scale', 'params'), path)
    _copy(module.bias, take(params, 'bias', 'params'), path)
    _copy(module.running_mean, take(stats, 'mean', 'batch_stats'), path)
    _copy(module.running_var, take(stats, 'var', 'batch_stats'), path)
    return
  for name, param in module.named_parameters(recurse=False):
    _copy(param, take(params, name, 'params'), path + (name,))
  for name, child in module.named_children():
    _load(child, params.get(name, {}), stats.get(name, {}), path + (name,),
          used)


def load_flax_variables(module, variables):
  """Copy a flax variable tree (numpy leaves) into ``module`` in place."""
  params = variables.get('params', {})
  stats = variables.get('batch_stats', {})
  if any('blocks' in path for path in _leaves(params)):
    raise NotImplementedError(
        "a flax tree of a use_scan RecNet (stacked 'blocks') is not ported "
        'yet')
  used = set()
  _load(module, params, stats, (), used)
  unused = ({('params',) + p for p in _leaves(params)} |
            {('batch_stats',) + p for p in _leaves(stats)}) - used
  if unused:
    raise ValueError('flax variables not used by the module: {}'.format(
        sorted('/'.join(p) for p in unused)))
  return module
