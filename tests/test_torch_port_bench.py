"""The port's benchmark forward against the JAX bench's, on the CPU.

* ``build_flagship`` takes every side the JAX ``bench.build_forward``
  takes (a multiple of 4 from 16): at 48² the port's forward on JAX's
  variables agrees with JAX's within the U-Net bar (5e-4,
  tests/test_conv_pallas.py:130).
* ``csmri_refinement_tpu_torch.bench.build_forward`` in f32, bf16 and int8
  on JAX's variables agrees with JAX's ``build_forward``: f32 within 5e-4,
  bf16 and int8 within 2e-2 of max |ref| (``PERF.md`` §2's bars).
  ``scale`` is set to 0.5 on both sides: at its zero init the U-Net never
  reaches ``pred``.

The command itself is tested in ``tests/test_torch_port_bench_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from csmri_refinement_tpu_torch import bench
from csmri_refinement_tpu_torch.flagship import build_flagship
from csmri_refinement_tpu_torch.utils.jax_weights import load_flax_variables

torch.set_num_threads(1)

F32_ATOL = 5e-4      # tests/test_conv_pallas.py:130
BF16_REL = 2e-2      # PERF.md §2: bf16 and int8 against f32-accumulated refs


def _jax_forward(size, dtype_str):
  """JAX's bench forward at ``size``², B = 2, its variables as numpy with
  ``scale`` 0.5, and its batch as numpy: (variables, batch, pred)."""
  forward, variables, batch_for = jax_bench.build_forward(size, dtype_str)
  variables = jax.tree_util.tree_map(np.asarray, variables)
  variables['params']['scale'] = np.full((1,), 0.5, np.float32)
  batch = {k: np.asarray(v) for k, v in batch_for(2).items()}
  pred = forward(jax.tree_util.tree_map(jnp.asarray, variables),
                 *[batch[k] for k in ('inp', 'kspace', 'mask')])
  return variables, batch, np.asarray(pred.astype(jnp.float32))


def _port_pred(model, forward, batch):
  with torch.inference_mode():
    got = forward(*[torch.from_numpy(np.array(batch[k]))
                    for k in ('inp', 'kspace', 'mask')])
  return got.float().numpy()


def test_build_flagship_runs_sides_jax_runs():
  variables, batch, want = _jax_forward(48, 'f32')
  assert want.shape == (2, 48, 48, 2)
  model, _ = build_flagship(48, torch.float32, 'cpu')
  load_flax_variables(model, variables)
  outs = []
  got = _port_pred(model, lambda *a: outs.append(model(*a)) or
                   outs[0]['pred'], batch)
  np.testing.assert_allclose(got, want, atol=F32_ATOL)
  # the U-Net (12² at its deepest scale) reaches pred
  refinement = outs[0]['pred'] - outs[0]['pretrained']
  assert float(refinement.abs().max()) > 1e-3


def test_build_flagship_refuses_sides_the_unet_cannot_pool():
  for side in (30, 12):
    with pytest.raises(ValueError, match='multiple of 4'):
      build_flagship(side, torch.float32, 'cpu')
  build_flagship(1024, torch.float32, 'cpu')   # the plain version: any side


@pytest.mark.parametrize('dtype_str', ['f32', 'bf16', 'int8'])
def test_bench_forward_matches_jax(dtype_str):
  variables, batch, want = _jax_forward(32, dtype_str)
  forward, model, batch_for = bench.build_forward(32, dtype_str,
                                                  device='cpu')
  load_flax_variables(model, variables)
  got = _port_pred(model, forward, batch)
  assert got.shape == want.shape == (2, 32, 32, 2)
  tol = F32_ATOL if dtype_str == 'f32' else BF16_REL * np.abs(want).max()
  np.testing.assert_allclose(got, want, atol=tol)
  # its own batch: seeded, varden 8x
  again = batch_for(2)
  for key, value in batch_for(2).items():
    assert torch.equal(value, again[key]), key
  assert tuple(again['inp'].shape) == (2, 32, 32, 2)
