"""Port parity for the ops of ``csmri_refinement_tpu_torch`` on the CPU.

The same seeded numpy inputs go through each JAX function and its port;
on the CPU the port's kernel wrappers run their plain PyTorch versions.
Tolerances are the JAX suite's own: DC 2e-4 (tests/test_dc_pallas.py:26),
conv chain 2e-4 (tests/test_conv_pallas.py:75), FFT 1e-5 (f32 rounding).
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.models.layers import same_pad as jax_same_pad
from csmri_refinement_tpu.ops import conv_pallas as jconv
from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu.ops import fft as jfft
from csmri_refinement_tpu.ops import masks as jmasks
from csmri_refinement_tpu.ops import undersample as jus
from csmri_refinement_tpu.ops.dc_pallas import dc_pallas
from csmri_refinement_tpu_torch.models import layers as tlayers
from csmri_refinement_tpu_torch.ops import conv_chain as tconv
from csmri_refinement_tpu_torch.ops import dc as tdc
from csmri_refinement_tpu_torch.ops import dc_kernel as tdck
from csmri_refinement_tpu_torch.ops import fft as tfft
from csmri_refinement_tpu_torch.ops import masks as tmasks
from csmri_refinement_tpu_torch.ops import undersample as tus

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'csmri_refinement_tpu_torch')


def _t(a):
  return torch.from_numpy(np.array(a))


def test_fft_matches_jnp():
  rng = np.random.RandomState(0)
  x = (rng.randn(2, 16, 8) + 1j * rng.randn(2, 16, 8)).astype(np.complex64)
  for jf, tf in ((jfft.fft2, tfft.fft2), (jfft.ifft2, tfft.ifft2)):
    np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(x)),
                               atol=1e-5)
  packed = np.asarray(jfft.pack_complex(jnp.asarray(x)))
  np.testing.assert_array_equal(tfft.pack_complex(_t(x)).numpy(), packed)
  np.testing.assert_array_equal(tfft.unpack_complex(_t(packed)).numpy(), x)
  np.testing.assert_allclose(tfft.complex_abs(_t(packed)).numpy(),
                             np.asarray(jfft.complex_abs(packed)), atol=1e-6)


@pytest.mark.parametrize('shape,acc,sample_n', [
    ((2, 32, 16), 4, 8), ((3, 64, 8), 3.2, 8), ((1, 16, 16), 2, 4)])
def test_cartesian_mask_np_bit_identical(shape, acc, sample_n):
  want = jmasks.cartesian_mask_np(shape, acc, sample_n,
                                  rng=np.random.RandomState(7))
  got = tmasks.cartesian_mask_np(shape, acc, sample_n,
                                 rng=np.random.RandomState(7))
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('nx,acc', [(64, 8), (256, 8), (256, 3.2), (32, 8)])
def test_torch_cartesian_mask_line_count(nx, acc):
  assert tmasks.cartesian_num_lines(nx, acc) == \
      jmasks.cartesian_num_lines(nx, acc)
  gen = torch.Generator().manual_seed(0)
  mask = tmasks.cartesian_mask(gen, (6, nx, 4), acc)
  assert mask.shape == (6, nx, 4)
  lines = mask[..., 0]
  # every line is fully sampled or not at all
  assert torch.equal(mask, lines[..., None].expand_as(mask))
  want = tmasks.cartesian_num_lines(nx, acc)
  assert lines.sum(-1).tolist() == [want] * 6
  centred = torch.fft.fftshift(lines, dim=-1)
  c = tmasks.CARTESIAN_CENTRAL_LINES
  assert bool((centred[:, nx // 2 - c // 2:nx // 2 + c // 2] == 1).all())
  # different generator draws give different masks when lines are random
  if want > c:
    other = tmasks.cartesian_mask(torch.Generator().manual_seed(1),
                                  (6, nx, 4), acc)
    assert not torch.equal(mask, other)


def test_variable_acceleration_line_counts():
  gen = torch.Generator().manual_seed(3)
  mask = tmasks.make_masks(gen, 8, 64, 4, acceleration_factor=4,
                           variable_acceleration=True)
  counts = mask[..., 0].sum(-1)
  assert bool((counts >= tmasks.CARTESIAN_CENTRAL_LINES).all())
  assert bool((counts <= 64).all())
  assert len(set(counts.tolist())) > 1


def test_undersample_batch_fixed_mask_matches_jax():
  rng = np.random.RandomState(1)
  gt = rng.rand(2, 16, 16).astype(np.float32)
  mask = jmasks.cartesian_mask_np((2, 16, 16), 4, 4,
                                  rng=np.random.RandomState(2))
  want = jus.undersample_batch(None, jnp.asarray(gt), fixed_mask=mask)
  got = tus.undersample_batch(None, _t(gt), fixed_mask=mask)
  for key in ('inp', 'kspace', 'mask', 'target'):
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=1e-5, err_msg=key)


def _dc_inputs(seed):
  rng = np.random.RandomState(seed)
  x = rng.randn(2, 16, 16, 2).astype(np.float32)
  gt = rng.randn(2, 16, 16) + 1j * rng.randn(2, 16, 16)
  mask = jmasks.cartesian_mask_np((2, 16, 16), 2, 4,
                                  rng=np.random.RandomState(seed))
  k0c = mask * np.fft.fft2(gt, axes=(-2, -1), norm='ortho')
  k0 = np.stack([k0c.real, k0c.imag], -1).astype(np.float32)
  return x, k0, mask[..., None].astype(np.float32), k0c, mask


def test_dc_plain_matches_jax_and_pallas():
  x, k0, m, _, _ = _dc_inputs(0)
  want = np.asarray(jdc.data_consistency(jnp.asarray(x), jnp.asarray(k0),
                                         jnp.asarray(m)))
  pallas = np.asarray(dc_pallas(jnp.asarray(x), jnp.asarray(k0),
                                jnp.asarray(m), interpret=True))
  got = tdc.data_consistency(_t(x), _t(k0), _t(m)).numpy()
  np.testing.assert_allclose(got, want, atol=2e-4)
  np.testing.assert_allclose(got, pallas, atol=2e-4)
  np.testing.assert_array_equal(
      got, tdck.dc_plain(_t(x), _t(k0), _t(m)).numpy())


def test_dc_plain_preserves_sampled_lines():
  x, k0, m, k0c, mask = _dc_inputs(1)
  out = tdc.data_consistency(_t(x), _t(k0), _t(m)).numpy()
  out_k = np.fft.fft2(out[..., 0] + 1j * out[..., 1], axes=(-2, -1),
                      norm='ortho')
  np.testing.assert_allclose(out_k[mask > 0], k0c[mask > 0], atol=2e-4)


def _chain(rng, k, cin, widths=(16, 16)):
  layers = []
  for cout in widths:
    w = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    layers.append((w, b, 0.2))
    cin = cout
  return layers


@pytest.mark.parametrize('cin', [2, 8, 16])
@pytest.mark.parametrize('pad_mode', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('k', [3, 4])
def test_chain_plain_matches_jax(k, pad_mode, cin):
  rng = np.random.RandomState(k * 100 + cin)
  spec = _chain(rng, k, cin)
  x = rng.randn(2, 8, 12, cin).astype(np.float32)
  want = jconv.chain_forward(
      jnp.asarray(x),
      [jconv.ChainLayer(jnp.asarray(w), jnp.asarray(b), l)
       for w, b, l in spec],
      pad_mode=pad_mode, need_cin=10 ** 9)
  got = tconv.chain_forward(
      _t(x), [tconv.ChainLayer(_t(w), _t(b), l) for w, b, l in spec],
      pad_mode=pad_mode)
  assert got.shape == want.shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize('k,pad_mode', [(4, 'reflection'), (3, 'zero'),
                                        (4, 'replication')])
def test_same_pad_matches_jax(k, pad_mode):
  x = np.random.RandomState(k).randn(1, 5, 6, 3).astype(np.float32)
  want = np.asarray(jax_same_pad(jnp.asarray(x), k, 1, pad_mode))
  got = tlayers.same_pad(_t(x).permute(0, 3, 1, 2), k, pad_mode)
  np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
  assert tlayers.pad_sizes(4) == (1, 2)


def test_kernel_wrappers_reject_cpu_tensors():
  """On a CPU tensor the dispatchers take the plain versions; the kernel
  wrappers themselves take CUDA tensors only, and count no launch."""
  before = (tdck.dc_cuda.launches, tconv.conv_layer_cuda.launches)
  x = torch.zeros(1, 8, 8, 2)
  with pytest.raises(ValueError):
    tdck.dc_cuda(x, x, torch.zeros(1, 8, 8, 1))
  layer = tconv.ChainLayer(torch.zeros(3, 3, 2, 16))
  with pytest.raises(ValueError):
    tconv.conv_layer_cuda(x, layer)
  tdck.dc_fused(x, x, torch.zeros(1, 8, 8, 1))
  tconv.conv_layer(x, layer, 'zero')
  assert (tdck.dc_cuda.launches, tconv.conv_layer_cuda.launches) == before


def _imports(path):
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def test_port_imports_no_jax():
  files = [os.path.join(REPO, 'chip_smoke.py')]
  for root, _, names in os.walk(PKG):
    files += [os.path.join(root, n) for n in names if n.endswith('.py')]
  assert len(files) > 35
  # nor pandas, PIL or msgpack, which the card machine need not have
  banned = ('jax', 'jaxlib', 'flax', 'optax', 'csmri_refinement_tpu',
            'pandas', 'PIL', 'msgpack')
  for path in files:
    for mod in _imports(path):
      assert mod.split('.')[0] not in banned, (path, mod)
  # Only modules the import adds count: an interpreter start-up hook may
  # import jax on its own.
  code = ('import sys; before = set(sys.modules); '
          'import csmri_refinement_tpu_torch.flagship, '
          'csmri_refinement_tpu_torch.utils.jax_weights, '
          'csmri_refinement_tpu_torch.models, '
          'csmri_refinement_tpu_torch.models.criteria, '
          'csmri_refinement_tpu_torch.train, '
          'csmri_refinement_tpu_torch.validate, '
          'csmri_refinement_tpu_torch.eval_results, '
          'csmri_refinement_tpu_torch.data.results_io, '
          'csmri_refinement_tpu_torch.training.runner, '
          'csmri_refinement_tpu_torch.data.transform_wrappers, '
          'csmri_refinement_tpu_torch.metrics.image_metrics, '
          'csmri_refinement_tpu_torch.metrics.scalar_metrics, '
          'csmri_refinement_tpu_torch.profile_train, '
          'csmri_refinement_tpu_torch.profile_flagship, '
          'csmri_refinement_tpu_torch.ops.quantize, '
          'csmri_refinement_tpu_torch.quality_dtype_table, '
          'csmri_refinement_tpu_torch.probes.mosaic_prims, '
          'csmri_refinement_tpu_torch.probes.int8_prims, '
          'csmri_refinement_tpu_torch.deploy_checkpoint, '
          'csmri_refinement_tpu_torch.utils.tensor_transforms, '
          'csmri_refinement_tpu_torch.utils.diagnostics, '
          'csmri_refinement_tpu_torch.utils.preemption, '
          'csmri_refinement_tpu_torch.utils.profiling, '
          'csmri_refinement_tpu_torch.utils.torch_import; '
          'bad = [m for m in set(sys.modules) - before if m.split(".")[0] in '
          '("jax", "flax", "optax", "csmri_refinement_tpu", "pandas", '
          '"PIL", "msgpack")]; '
          'assert not bad, bad')
  subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                 timeout=120)
