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

``flax_tensors`` is that walk: every tensor of a module with its flax
collection, path and layout move. ``load_flax_variables`` copies a tree's
leaves through it; ``load_optax_state`` maps the params-shaped trees of an
optax state (Adam's ``mu`` and ``nu``, RMSProp's ``nu``) through the same
moves onto an optimizer's state; ``utils/diagnostics.py`` names the
parameters by it.
"""

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

# flax → torch layout moves: (axes flipped first, then the permutation);
# a flax array of shape s becomes a torch tensor of shape s[perm].
_CONV = ((), (3, 2, 0, 1))           # HWIO → OIHW
_CONV_T = ((0, 1), (2, 3, 0, 1))     # (k, k, Cin, Cout) → (Cin, Cout, k, k)
_DENSE = ((), (1, 0))                # (in, out) → (out, in)
_SAME = ((), None)


def _leaves(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix + (key,)


def flax_tensors(module, path=()):
  """Yield (tensor, collection, flax path, move) for every parameter and
  BN statistic of ``module``: ``collection`` is ``'params'`` or
  ``'batch_stats'``, ``move`` is (flipped axes, permutation) from the
  flax layout to the tensor's."""
  own = {}
  if isinstance(module, nn.Conv2d):
    own = {'weight': ('params', 'kernel', _CONV)}
  elif isinstance(module, nn.ConvTranspose2d):
    own = {'weight': ('params', 'kernel', _CONV_T)}
  elif isinstance(module, nn.Linear):
    own = {'weight': ('params', 'kernel', _DENSE)}
  elif isinstance(module, nn.BatchNorm2d):
    own = {'weight': ('params', 'scale', _SAME),
           'running_mean': ('batch_stats', 'mean', _SAME),
           'running_var': ('batch_stats', 'var', _SAME)}
  if own:
    for name, tensor in list(module.named_parameters(recurse=False)) + \
        list(module.named_buffers(recurse=False)):
      if name in own:
        collection, key, move = own[name]
        yield tensor, collection, path + (key,), move
      elif name == 'bias':
        yield tensor, 'params', path + ('bias',), _SAME
    return
  for name, param in module.named_parameters(recurse=False):
    yield param, 'params', path + (name,), _SAME
  for name, child in module.named_children():
    yield from flax_tensors(child, path + (name,))


def flax_shape(tensor, move):
  """The flax shape of ``tensor`` under ``move``."""
  perm = move[1]
  if perm is None:
    return tuple(tensor.shape)
  shape = [0] * len(perm)
  for i, axis in enumerate(perm):
    shape[axis] = tensor.shape[i]
  return tuple(shape)


def _to_torch(value, move):
  """A flax leaf (numpy array or torch tensor) in the torch layout."""
  flip, perm = move
  if isinstance(value, torch.Tensor):
    value = value.detach()
    if flip:
      value = value.flip(flip)
    return (value.permute(perm) if perm else value).clone()
  value = np.asarray(value)
  if value.ndim and flip:
    value = np.flip(value, flip)
  if perm:
    value = np.transpose(value, perm)
  return torch.from_numpy(np.array(value))


def _lookup(tree, path, kind, used):
  node = tree
  for key in path:
    if not isinstance(node, Mapping) or key not in node:
      raise KeyError('missing flax {} {}'.format(kind, '/'.join(path)))
    node = node[key]
  used.add((kind,) + path)
  return node


def _check_all_used(trees, used):
  unused = {(kind,) + p for kind, tree in trees.items()
            for p in _leaves(tree)} - used
  if unused:
    raise ValueError('flax variables not used by the module: {}'.format(
        sorted('/'.join(p) for p in unused)))


def _refuse_scan(params):
  if any('blocks' in path for path in _leaves(params)):
    raise NotImplementedError(
        "a flax tree of a use_scan RecNet (stacked 'blocks') is not ported "
        'yet')


def _moved(tensor, value, move, path):
  """``value`` in ``tensor``'s layout; raises unless the shapes fit."""
  if tuple(np.shape(value)) != flax_shape(tensor, move):
    raise ValueError('{}: flax shape {} does not fit {}'.format(
        '/'.join(path), tuple(np.shape(value)), flax_shape(tensor, move)))
  return _to_torch(value, move)


def load_flax_variables(module, variables):
  """Copy a flax variable tree (numpy leaves) into ``module`` in place."""
  trees = {'params': variables.get('params', {}),
           'batch_stats': variables.get('batch_stats', {})}
  _refuse_scan(trees['params'])
  used = set()
  for tensor, collection, path, move in flax_tensors(module):
    value = _lookup(trees[collection], path, collection, used)
    with torch.no_grad():
      tensor.copy_(_moved(tensor, value, move, path))
  _check_all_used(trees, used)
  return module


def load_optax_state(optimizer, module, tree):
  """Fill ``optimizer`` (``torch.optim.Adam`` or the port's ``RMSProp``,
  over parameters of ``module``) from the optax state ``tree`` of the same
  parameters, as ``flax.serialization.to_state_dict`` writes an
  ``optax.inject_hyperparams`` state: ``inner_state['0']`` holds Adam's
  ``count``, ``mu`` and ``nu`` or RMSProp's ``nu``, params-shaped trees
  that take the weights' layout moves, and ``hyperparams.learning_rate``
  sets each group's ``lr``. A parameter outside the optimizer (a frozen
  pretrained model, whose gradients JAX stops) must have zero moments;
  its leaves are skipped. Each moment lands on its parameter's device
  (``Optimizer.load_state_dict`` places them)."""
  inner = tree['inner_state']['0']
  adam = isinstance(optimizer, torch.optim.Adam)
  keys = {'mu': 'exp_avg', 'nu': 'exp_avg_sq'} if adam else {'nu': 'nu'}
  if set(keys) != set(inner) - {'count'}:
    raise ValueError('optax state {} does not fit {}'.format(
        sorted(inner), type(optimizer).__name__))
  for key in keys:
    _refuse_scan(inner[key])
  params = [p for group in optimizer.param_groups for p in group['params']]
  index = {id(p): i for i, p in enumerate(params)}
  state, used = {}, set()
  for tensor, collection, path, move in flax_tensors(module):
    if collection != 'params':
      continue
    moments = {name: _moved(tensor, _lookup(inner[key], path, key, used),
                            move, path) for key, name in keys.items()}
    if id(tensor) not in index:
      if any(bool(m.any()) for m in moments.values()):
        raise ValueError('{}: a parameter outside the optimizer has non-zero '
                         'optax moments'.format('/'.join(path)))
      continue
    if adam:
      moments['step'] = torch.tensor(float(inner['count']))
    state[index[id(tensor)]] = moments
  _check_all_used({key: inner[key] for key in keys}, used)
  missing = [i for i in range(len(params)) if i not in state]
  if missing:
    raise ValueError('optax state lacks {} optimizer parameters'.format(
        len(missing)))
  state_dict = optimizer.state_dict()
  state_dict['state'] = state
  lr = float(tree['hyperparams']['learning_rate'])
  for group in state_dict['param_groups']:
    group['lr'] = lr
  optimizer.load_state_dict(state_dict)
  return optimizer
