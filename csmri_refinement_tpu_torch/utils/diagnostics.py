"""Model parameter summaries.

Port of ``csmri_refinement_tpu/utils/diagnostics.py:12-44``: per network
of a runner (``model``; ``generator`` and ``discriminator``), the count of
its parameters and a line per parameter under the flax path and shape the
JAX package prints (``['block_0']['conv_0']['kernel']: (3, 3, 2, 32)``),
through the weight bridge's walk (``utils/jax_weights.py::flax_tensors``).
Frozen parameters (a RefinementWrapper's pretrained model) count, as they
do in the JAX tree.
"""

import math

from csmri_refinement_tpu_torch.utils.jax_weights import (flax_shape,
                                                          flax_tensors)


def runner_networks(runner):
  """{name: module} of a runner's networks, named as in its checkpoints."""
  if hasattr(runner, 'model'):
    return {'model': runner.model}
  networks = {'generator': runner.gen}
  if runner.disc is not None:
    networks['discriminator'] = runner.disc
  return networks


def parameter_shapes(module):
  """[(flax path, flax shape)] of ``module``'s parameters, in the JAX
  tree's order; a stacked (``use_scan``) leaf once, its entries along a
  first axis."""
  shapes = {}
  for tensor, collection, path, move in flax_tensors(module):
    if collection != 'params':
      continue
    shape = flax_shape(tensor, move)
    if isinstance(path[-1], int):
      path = path[:-1]
      shape = (shapes[path][0] + 1 if path in shapes else 1,) + shape
    shapes[path] = shape
  return sorted(shapes.items())


def print_model_parameters(runner):
  """Print per-network parameter counts and shapes of a runner."""
  total = 0
  for name, module in runner_networks(runner).items():
    shapes = parameter_shapes(module)
    n = sum(math.prod(shape) for _, shape in shapes)
    total += n
    print('{}: {:,} parameters'.format(name, n))
    for path, shape in shapes:
      print('  {}: {} -> {:,}'.format(
          ''.join("['{}']".format(key) for key in path), shape,
          math.prod(shape)))
  print('Total: {:,} parameters'.format(total))
