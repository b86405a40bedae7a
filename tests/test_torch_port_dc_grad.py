"""The DC's backward (K1-bwd) in the port against the JAX custom VJP.

``_DCFunction`` takes the plain versions for CPU tensors, so these tests
run its backward formula (``dc_plain_vjp``) as the card runs it with the
kernel. The JAX side is ``ops/dc.py::_dc_fused``, the Pallas kernel with its
hand-written VJP, in interpret mode on the CPU (as
``tests/test_dc_pallas.py`` runs it). Tolerance 2e-3, the bar of
``tests/test_dc_pallas.py:46``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu_torch.models import recnet as trecnet
from csmri_refinement_tpu_torch.ops import dc as tdc
from csmri_refinement_tpu_torch.ops import dc_kernel as tdck

GRAD_ATOL = 2e-3     # tests/test_dc_pallas.py:46


def _inputs(b, n, seed):
  rng = np.random.RandomState(seed)
  x = rng.randn(b, n, n, 2).astype(np.float32)
  k0 = rng.randn(b, n, n, 2).astype(np.float32)
  w = rng.randn(b, n, n, 2).astype(np.float32)   # the output's cotangent
  mask = jmasks.cartesian_mask_np((b, n, n), 4, 4, centred=False,
                                  rng=np.random.RandomState(seed + 1))
  return x, k0, w, mask[..., None].astype(np.float32)


def _jax_grads(x, k0, w, mask):
  def loss(x_, k0_):
    return jnp.sum(jdc._dc_fused(x_, k0_, jnp.asarray(mask)) * w)
  gx, gk = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                   jnp.asarray(k0))
  return np.asarray(gx), np.asarray(gk)


@pytest.mark.parametrize('b,n', [(2, 16), (1, 32)])
def test_dc_function_grads_match_jax_custom_vjp(b, n):
  x, k0, w, mask = _inputs(b, n, n)
  want_x, want_k0 = _jax_grads(x, k0, w, mask)
  tx = torch.from_numpy(x).requires_grad_()
  tk0 = torch.from_numpy(k0).requires_grad_()
  y = tdck._DCFunction.apply(tx, tk0, torch.from_numpy(mask))
  (y * torch.from_numpy(w)).sum().backward()
  np.testing.assert_allclose(tx.grad.numpy(), want_x, atol=GRAD_ATOL)
  np.testing.assert_allclose(tk0.grad.numpy(), want_k0, atol=GRAD_ATOL)


@pytest.mark.parametrize('need_k0', [True, False])
def test_dc_plain_vjp_matches_torch_autodiff(need_k0):
  x, k0, w, mask = _inputs(2, 16, 3)
  tx = torch.from_numpy(x).requires_grad_()
  tk0 = torch.from_numpy(k0).requires_grad_()
  m = torch.from_numpy(mask)
  (tdck.dc_plain(tx, tk0, m) * torch.from_numpy(w)).sum().backward()
  gx, gk0 = tdck.dc_plain_vjp(torch.from_numpy(w), m, need_k0)
  np.testing.assert_allclose(gx.numpy(), tx.grad.numpy(), atol=GRAD_ATOL)
  if need_k0:
    np.testing.assert_allclose(gk0.numpy(), tk0.grad.numpy(),
                               atol=GRAD_ATOL)
  else:
    assert gk0 is None


def test_dc_function_gives_no_k0_or_mask_grad_unless_asked():
  x, k0, w, mask = _inputs(1, 16, 5)
  tx = torch.from_numpy(x).requires_grad_()
  tk0 = torch.from_numpy(k0)
  m = torch.from_numpy(mask).requires_grad_()
  y = tdck._DCFunction.apply(tx, tk0, m)
  (y * torch.from_numpy(w)).sum().backward()
  assert tx.grad is not None and m.grad is None and tk0.grad is None
  want_x, _ = tdck.dc_plain_vjp(torch.from_numpy(w), m.detach(), False)
  np.testing.assert_allclose(tx.grad.numpy(), want_x.numpy(), atol=1e-6)


def test_dc_bwd_wrapper_takes_cuda_tensors_only():
  before = tdck.dc_bwd_cuda.launches
  with pytest.raises(ValueError):
    tdck.dc_bwd_cuda(torch.zeros(1, 8, 8, 2), torch.zeros(1, 8, 8, 1))
  assert tdck.dc_bwd_cuda.launches == before


def test_data_consistency_cpu_is_differentiable_plain():
  """On the CPU the DC is the autodiffed plain version; its gradient equals
  the Function's Hermitian formula."""
  x, k0, w, mask = _inputs(2, 16, 7)
  tx = torch.from_numpy(x).requires_grad_()
  y = tdc.data_consistency(tx, torch.from_numpy(k0), torch.from_numpy(mask))
  assert 'DCFunction' not in type(y.grad_fn).__name__
  (y * torch.from_numpy(w)).sum().backward()
  want_x, _ = tdck.dc_plain_vjp(torch.from_numpy(w), torch.from_numpy(mask))
  np.testing.assert_allclose(tx.grad.numpy(), want_x.numpy(),
                             atol=GRAD_ATOL)


def test_recnet_loss_reaches_every_block_on_cpu():
  model = trecnet.RecNet(num_blocks=2, num_convs=2, num_filters=8)
  model.init_weights(torch.Generator().manual_seed(0))
  x, k0, _, mask = _inputs(2, 16, 9)
  pred = model(torch.from_numpy(x), torch.from_numpy(k0),
               torch.from_numpy(mask))
  pred.pow(2).mean().backward()
  for name, p in model.named_parameters():
    assert p.grad is not None and p.grad.abs().sum() > 0, name
