"""Readings that hold the port's int8 serving mode to the JAX package.

    JAX_PLATFORMS=cpu python tests/int8_parity_readings.py

Runs on the CPU (the JAX package jitted, its Pallas chain kernel in
interpret mode; the port through its kernels' plain versions) and prints:

1. The flagship U-Net's int8-vs-f32 error, max |Δ| / max |f32| of its
   output, at 256² on the weights and batch of ``chip_smoke.py``'s phase 14
   (the port's seeded init, scale 0.5, B = 2): the JAX package's reading, on
   those weights exported to a flax tree, beside the port's. ``chip_smoke.py``
   holds the card's reading to the JAX one (``INT8_VS_F32_FLAGSHIP_JAX``).
2. Where the port-vs-JAX int8 gap of a U-Net comes from
   (``test_torch_port_quant.py::test_unet_int8_matches_jax``), at 64², on
   both U-Net configurations and three seeds: the gap with the port's own
   float input to each quantized suffix, the first suffix input's relative
   difference from JAX's, and the gap once every suffix is given JAX's input.
"""

import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

import chip_smoke  # noqa: E402
import csmri_refinement_tpu_torch as P  # noqa: E402
from csmri_refinement_tpu.models import unet as junet  # noqa: E402
from csmri_refinement_tpu.models.recnet import RecNet as JRecNet  # noqa: E402
from csmri_refinement_tpu.models.refinement_wrapper import (  # noqa: E402
    RefinementWrapper as JWrapper)
from csmri_refinement_tpu_torch.models import unet as tunet  # noqa: E402
from csmri_refinement_tpu_torch.utils.jax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_quant import (  # noqa: E402
    FLAGSHIP_UNET, UNET_INT8_CASES, _np, jax_unet_int8, port_unet_int8)


def flax_variables(module):
  """The flax variable tree of a port module: the inverse of
  ``load_flax_variables``."""
  def walk(m, params, stats):
    if isinstance(m, nn.Conv2d):
      params['kernel'] = m.weight.detach().permute(2, 3, 1, 0).numpy()
      if m.bias is not None:
        params['bias'] = m.bias.detach().numpy()
      return
    if isinstance(m, nn.BatchNorm2d):
      params['scale'] = m.weight.detach().numpy()
      params['bias'] = m.bias.detach().numpy()
      stats['mean'] = m.running_mean.numpy()
      stats['var'] = m.running_var.numpy()
      return
    for name, param in m.named_parameters(recurse=False):
      params[name] = param.detach().numpy()
    for name, child in m.named_children():
      p, s = {}, {}
      walk(child, p, s)
      if p:
        params[name] = p
      if s:
        stats[name] = s

  params, stats = {}, {}
  walk(module, params, stats)
  return {'params': params, 'batch_stats': stats}


def rel_err(a, b):
  return float(np.abs(a - b).max() / np.abs(b).max())


def flagship_reading():
  model8, model, batch = chip_smoke.int8_quality_inputs(P)
  args = [batch[k] for k in ('inp', 'kspace', 'mask')]
  key = 'prescaled_refinement'
  with torch.inference_mode():
    port8, port = model8(*args)[key].numpy(), model(*args)[key].numpy()
  variables = flax_variables(model8)
  jargs = [jnp.asarray(a.numpy()) for a in args]
  out = {}
  for quantized in (True, False):
    jmodel = JWrapper(
        pretrained_model=JRecNet(num_blocks=3, num_convs=3, num_filters=32),
        learnable_model=junet.UNET(quantize_inference=quantized,
                                   **FLAGSHIP_UNET),
        mode='real-penalty-add', input_mode='output')
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *jargs)
    assert (jax.tree_util.tree_structure(tree) ==
            jax.tree_util.tree_structure(variables))
    out[quantized] = np.asarray(jax.jit(jmodel.apply)(variables, *jargs)[key])
  size = chip_smoke.SIZE
  print('flagship U-Net {}^2 B2, int8 vs f32, max|d|/max|f32|: JAX {:.9f}, '
        'port {:.9f}'.format(size, rel_err(out[True], out[False]),
                             rel_err(port8, port)))
  print('  port vs JAX on the same weights, max|d|/max|JAX|: int8 {:.3e}, '
        'f32 {:.3e}'.format(rel_err(port8, out[True]),
                            rel_err(port, out[False])))


def gap_witness():
  print('U-Net 64^2 B2, port vs JAX int8, max|d|/max|JAX|:')
  for case in sorted(UNET_INT8_CASES):
    kw = UNET_INT8_CASES[case]
    for seed in (0, 1, 2):
      x = np.random.RandomState(4 + seed).randn(2, 64, 64, 2).astype(
          np.float32)
      variables, want, jax_inputs = jax_unet_int8(kw, seed, x)
      port = tunet.UNET(quantize_inference=True, **kw)
      load_flax_variables(port, _np(variables)).eval()
      got, own_inputs = port_unet_int8(port, x)
      pinned, _ = port_unet_int8(port, x, jax_inputs)
      print('  {} seed {}: own suffix inputs {:.3e}; first suffix input '
            'off by {:.3e}; JAX\'s suffix inputs {:.3e}'.format(
                case, seed, rel_err(got, want),
                rel_err(own_inputs[0], jax_inputs[0]), rel_err(pinned, want)))


if __name__ == '__main__':
  torch.set_num_threads(4)
  flagship_reading()
  gap_witness()
