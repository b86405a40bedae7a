"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
``cuda`` fixture, never at import). Run on a machine with an NVIDIA
Hopper GPU and nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports jax, which such a machine
may not have; this file needs only torch.)
"""

import pytest
import torch

from csmri_refinement_tpu_torch import build_flagship
from csmri_refinement_tpu_torch.models.recnet import RecNet
from csmri_refinement_tpu_torch.ops import conv_chain as cc
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.ops import masks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


@pytest.mark.parametrize('b,n', [(3, 2), (2, 16), (4, 64), (2, 512)])
def test_dc_kernel_matches_plain(cuda, b, n):
  gen = torch.Generator(device=cuda).manual_seed(n)
  x = torch.randn(b, n, n, 2, device=cuda, generator=gen)
  k0 = torch.randn(b, n, n, 2, device=cuda, generator=gen)
  m = (torch.rand(b, n, n, 1, device=cuda, generator=gen) > 0.5).float()
  got = dc_kernel.dc_cuda(x, k0, m)
  torch.cuda.synchronize()
  want = dc_kernel.dc_plain(x, k0, m)
  assert (got - want).abs().max().item() <= 2e-4


def test_dc_kernel_keeps_sampled_lines(cuda):
  gen = torch.Generator(device=cuda).manual_seed(0)
  gt = torch.rand(2, 128, 128, device=cuda, generator=gen).to(torch.complex64)
  mask = masks.cartesian_mask(gen, (2, 128, 128), 4, device=cuda)
  k0c = mask * fft.fft2(gt)
  x = torch.randn(2, 128, 128, 2, device=cuda, generator=gen)
  y = dc_kernel.dc_cuda(x, fft.pack_complex(k0c).contiguous(),
                        mask[..., None].contiguous())
  err = (fft.fft2(fft.unpack_complex(y)) - k0c)[mask > 0].abs().max()
  assert err.item() <= 2e-4


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('pad', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('k,cin,cout', [(3, 2, 32), (4, 48, 16),
                                        (4, 32, 64), (3, 128, 128)])
def test_conv_layer_kernel_matches_plain(cuda, k, cin, cout, pad, dtype):
  """Odd image sizes exercise the tile overhang at every border."""
  gen = torch.Generator(device=cuda).manual_seed(k * cin + cout)
  x = torch.randn(2, 19, 37, cin, device=cuda, generator=gen).to(dtype)
  w = torch.randn(k, k, cin, cout, device=cuda, generator=gen)
  layer = cc.ChainLayer(w * (2.0 / (k * k * cin)) ** 0.5,
                        torch.randn(cout, device=cuda, generator=gen), 0.1)
  got = cc.conv_layer_cuda(x, layer, pad)
  torch.cuda.synchronize()
  want = cc.conv_layer_plain(x, layer, pad)
  err = (got.float() - want.float()).abs().max().item()
  # bf16: the output is rounded to bf16 (2^-8 relative); a different
  # summation order may round a near-tie the other way.
  tol = 2e-4 if dtype == torch.float32 else 1e-2 * want.abs().max().item()
  assert got.dtype == dtype and err <= tol


def test_kernel_wrappers_raise_on_unsupported_inputs(cuda):
  x = torch.zeros(1, 16, 16, 2, device=cuda)
  m = torch.zeros(1, 16, 16, 1, device=cuda)
  with pytest.raises(ValueError):
    dc_kernel.dc_cuda(x[:, :, :12].contiguous(), x[:, :, :12].contiguous(),
                      m[:, :, :12].contiguous())           # not square
  with pytest.raises(ValueError):
    dc_kernel.dc_cuda(x.double(), x.double(), m)          # not f32
  layer = cc.ChainLayer(torch.zeros(3, 3, 2, 16, device=cuda))
  with pytest.raises(ValueError):
    cc.conv_layer_cuda(x.permute(0, 2, 1, 3), layer)      # not contiguous
  with pytest.raises(ValueError):
    cc.conv_layer_cuda(x, cc.ChainLayer(torch.zeros(5, 5, 2, 16,
                                                    device=cuda)))


def test_flagship_forward_launches_kernels(cuda):
  model, undersample_batch = build_flagship(64, torch.bfloat16, 'cuda', 0)
  gen = torch.Generator(device=cuda).manual_seed(0)
  batch = undersample_batch(gen, torch.rand(2, 64, 64, device=cuda,
                                            generator=gen), 'varden', 8)
  dc_kernel.dc_cuda.launches = 0
  cc.conv_layer_cuda.launches = 0
  with torch.inference_mode():
    out = model(batch['inp'], batch['kspace'], batch['mask'])
  torch.cuda.synchronize()
  assert (dc_kernel.dc_cuda.launches, cc.conv_layer_cuda.launches) == (3, 10)
  assert out['pred'].shape == (2, 64, 64, 2)
  assert bool(torch.isfinite(out['pred'].float()).all())


@pytest.mark.parametrize('need_k0', [True, False], ids=['k0_grad', 'no_k0'])
@pytest.mark.parametrize('b,n', [(4, 256), (2, 512)])
def test_dc_bwd_kernel_matches_plain_vjp(cuda, b, n, need_k0):
  """K1-bwd through _DCFunction vs dc_plain_vjp, at 2e-3
  (tests/test_dc_pallas.py:46)."""
  gen = torch.Generator(device=cuda).manual_seed(n + need_k0)
  x = torch.randn(b, n, n, 2, device=cuda, generator=gen, requires_grad=True)
  k0 = torch.randn(b, n, n, 2, device=cuda, generator=gen)
  k0.requires_grad_(need_k0)
  g = torch.randn(b, n, n, 2, device=cuda, generator=gen)
  m = masks.cartesian_mask(gen, (b, n, n), 8, device=cuda)[..., None]
  m = m.contiguous()
  before = dc_kernel.dc_bwd_cuda.launches
  dc_kernel._DCFunction.apply(x, k0, m).backward(g)
  torch.cuda.synchronize()
  assert dc_kernel.dc_bwd_cuda.launches == before + 1
  want_x, want_k0 = dc_kernel.dc_plain_vjp(g, m, need_k0)
  assert (x.grad - want_x).abs().max().item() <= 2e-3
  if need_k0:
    assert (k0.grad - want_k0).abs().max().item() <= 2e-3
  else:
    assert k0.grad is None


def test_recnet_backward_reaches_every_block_on_card(cuda):
  """The DC on the card is differentiable: a loss on pred reaches every
  block's parameters, through K1 forward and K1-bwd backward."""
  model = RecNet(num_blocks=3, num_convs=3, num_filters=32)
  model.init_weights(torch.Generator().manual_seed(0))
  model.to(cuda)
  gen = torch.Generator(device=cuda).manual_seed(1)
  gt = torch.rand(2, 64, 64, device=cuda, generator=gen)
  mask = masks.cartesian_mask(gen, (2, 64, 64), 4, device=cuda)
  k0c = mask * fft.fft2(gt.to(torch.complex64))
  inp = fft.pack_complex(fft.ifft2(k0c))
  dc_kernel.dc_cuda.launches = 0
  dc_kernel.dc_bwd_cuda.launches = 0
  pred = model(inp, fft.pack_complex(k0c).contiguous(),
               mask[..., None].contiguous())
  ((pred - fft.pack_complex(gt.to(torch.complex64))) ** 2).mean().backward()
  torch.cuda.synchronize()
  assert (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches) == \
      (3, 3)
  for name, p in model.named_parameters():
    assert p.grad is not None and p.grad.abs().sum().item() > 0, name
