"""Host-side layouts of the port's Hopper kernels, checked on the CPU.

The CUDA kernels run only on the card, but what they are built on is
decided on the host and can be replayed here:

* K1 (``csrc/dc.cu``): the mixed-radix plan of each line FFT and its
  inter-stage twiddle tables (``ops/dc_kernel.py::FFT_PLANS``,
  ``fft_tables``). The replay runs the kernel's Stockham stages in
  complex64, with the in-register radix-2 networks and their f32 roots,
  and must match ``torch.fft.fft`` for every side from 2 to 512.
* K2 (``csrc/conv_chain.cu``): the bf16 route's K order and packed weights
  (``ops/conv_chain.py::gemm_layout``, ``pack_weights``). An implicit GEMM
  over the packed weights, in the kernel's K order, must equal
  ``conv_layer_plain``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from csmri_refinement_tpu_torch.models import layers
from csmri_refinement_tpu_torch.ops import conv_chain as cc
from csmri_refinement_tpu_torch.ops import dc_kernel

SIDES = [2, 4, 8, 16, 32, 64, 128, 256, 512]
# exp(-2 pi i k / 16), k < 8, rounded once to f32 as the kernel's literals
ROOT16 = np.exp(-2j * np.pi * np.arange(8) / 16).astype(np.complex64)


def _dft_network(v, inverse):
  """The kernel's in-register R-point DFT: bit reversal, then radix-2
  decimation-in-time butterflies with the f32 roots."""
  r = len(v)
  lg = r.bit_length() - 1
  v = v.copy()
  for i in range(r):
    j = int(format(i, '0{}b'.format(lg))[::-1], 2) if lg else 0
    if i < j:
      v[i], v[j] = v[j], v[i]
  for st in range(lg):
    half = 1 << st
    for i in range(r // 2):
      p, k = i & (half - 1), (i >> st) << (st + 1)
      a, b = v[k + p], v[k + p + half]
      if p:
        w = ROOT16[p * 8 // half]
        b = b * (np.conj(w) if inverse else w)
      v[k + p], v[k + p + half] = a + b, a - b
  return v


def _replay(x, inverse):
  """One line through the kernel's Stockham stages, in complex64."""
  n = len(x)
  table = dc_kernel.fft_tables(n)
  tw = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
  span, off = 1, 0
  for r in dc_kernel.FFT_PLANS[n]:
    out = np.empty_like(x)
    for j in range(n // r):
      v = x[j + np.arange(r) * (n // r)].copy()
      m = j % span
      if span > 1:
        w = tw[off + np.arange(r) * span + m]
        v = v * (np.conj(w) if inverse else w)
      out[(j // span) * span * r + m + np.arange(r) * span] = \
          _dft_network(v, inverse)
    if span > 1:
      off += span * r
    x, span = out, span * r
  return x


@pytest.mark.parametrize('inverse', [False, True], ids=['fwd', 'inv'])
@pytest.mark.parametrize('n', SIDES)
def test_fft_plan_replay_matches_torch_fft(n, inverse):
  rng = np.random.default_rng(n)
  x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
      np.complex64)
  got = _replay(x, inverse) / np.sqrt(n)
  t = torch.from_numpy(x.astype(np.complex128))
  want = (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho')
  assert np.abs(got - want.numpy()).max() <= 1e-5


@pytest.mark.parametrize('n', SIDES)
def test_fft_plan_shape(n):
  """Radices of 2 to 16 whose product is n; the tables hold Ns·r entries
  per stage after the first; the plan code is one byte per radix."""
  plan = dc_kernel.FFT_PLANS[n]
  assert int(np.prod(plan)) == n and all(2 <= r <= 16 for r in plan)
  spans = np.cumprod((1,) + plan)[:-1]
  size = sum(int(s) * r for s, r in zip(spans[1:], plan[1:]))
  assert dc_kernel.fft_tables(n).shape == (max(size, 1), 2)
  code = dc_kernel.plan_code(n)
  assert [(code >> (8 * s)) & 255 for s in range(3)] == \
      list(plan) + [0] * (3 - len(plan))


def _implicit_gemm(x, packed, k, cin, pad_mode):
  """The kernel's GEMM in plain torch: A gathers each pixel's padded
  input in the K order (chunk, tap, channel in chunk), B is the packed
  weight."""
  cin_pad, chunk, kp = cc.gemm_layout(cin, k)
  b, h, w, _ = x.shape
  xp = layers.same_pad(x.permute(0, 3, 1, 2), k, pad_mode)
  xp = F.pad(xp, (0, 0, 0, 0, 0, cin_pad - cin))      # zero channels
  cols = []
  for c in range(cin_pad // chunk):
    for dy in range(k):
      for dx in range(k):
        cols.append(xp[:, c * chunk:(c + 1) * chunk, dy:dy + h, dx:dx + w])
  a = torch.cat(cols, dim=1).permute(0, 2, 3, 1).reshape(b * h * w, -1)
  a = F.pad(a, (0, kp - a.shape[1]))
  return (a @ packed.t()).reshape(b, h, w, -1)


@pytest.mark.parametrize('pad_mode', ['reflection', 'zero'])
@pytest.mark.parametrize('k,cin,cout', [(4, 2, 32), (3, 2, 16), (4, 16, 32),
                                        (4, 32, 32), (3, 48, 16),
                                        (4, 64, 32), (3, 128, 64),
                                        (4, 128, 128)])
def test_packed_weights_match_conv_layer_plain(k, cin, cout, pad_mode):
  gen = torch.Generator().manual_seed(k * cin + cout)
  x = torch.randn(2, 7, 9, cin, generator=gen)
  kernel = torch.randn(k, k, cin, cout, generator=gen) / (k * cin) ** 0.5
  bias = torch.randn(cout, generator=gen)
  packed = cc.pack_weights(kernel, torch.float32)
  cin_pad, chunk, kp = cc.gemm_layout(cin, k)
  assert packed.shape == (cout, kp) and kp % 64 == 0
  assert (k * k * chunk) % 64 == 0 or cin_pad == chunk
  assert not packed[:, k * k * cin_pad:].any()
  got = _implicit_gemm(x, packed, k, cin, pad_mode) + bias
  got = layers.leaky_relu(got, 0.1)
  want = cc.conv_layer_plain(x, cc.ChainLayer(kernel, bias, 0.1), pad_mode)
  assert (got - want).abs().max().item() <= 1e-4


def test_pack_weights_bf16_rounds_once():
  """The bf16 operand is the HWIO weight rounded once to bf16."""
  kernel = torch.randn(4, 4, 32, 64, generator=torch.Generator().manual_seed(0))
  packed = cc.pack_weights(kernel)
  assert packed.dtype == torch.bfloat16
  want = cc.pack_weights(kernel.to(torch.bfloat16).float(), torch.float32)
  assert torch.equal(packed.float(), want)


def test_conv_route_by_shape():
  """The flagship's layers: the 2-channel stem stages 4 bytes at a time,
  the rest 16; f32 is the FMA route."""
  assert cc.conv_route(2, 32, torch.bfloat16) == 'wgmma, 4-byte staging'
  for cin in (32, 64, 128):
    assert cc.conv_route(cin, 32, torch.bfloat16) == 'wgmma'
  assert cc.conv_route(3, 16, torch.bfloat16) == 'wgmma, gathered halo'
  assert cc.conv_route(64, 64, torch.float32) == 'fma'
