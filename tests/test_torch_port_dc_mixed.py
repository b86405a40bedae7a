"""K1's mixed-radix route (``csrc/dc.cu``'s ``mix_rows``, ``mix_cols``),
replayed on the CPU.

The kernel runs only on the card, but its arithmetic is decided on the
host and can be replayed here in complex64, stage by stage as the kernel
runs it:

* the plans (``ops/dc_kernel.py::mixed_plan``) of every side from 2 to 512
  whose prime factors are at most 13, their inter-stage twiddles
  (``mixed_tables``, f64 rounded once to f32) and the odd DFTs' constant
  roots (``odd_roots``, which must be the kernel's ``odd_root`` literals):
  each line transform against ``torch.fft`` within 1e-5;
* the whole DC on those plans (rows along W, columns along H, the merge)
  against the JAX package's ``ops/dc.py::_dc_fused`` (the Pallas kernel in
  interpret mode, as ``tests/test_dc_pallas.py`` runs it) within 2e-4 at
  small non-power-of-two squares, and its VJP (``DC(g, 0, m)`` and
  ``fft2(g)``, as ``_DCFunction`` computes it) against JAX's custom VJP
  within 2e-3 (``tests/test_dc_pallas.py:26,46``);
* the column blocks the mixed-radix route takes (the per-axis routes are
  in ``tests/test_torch_port_kernel_layouts.py::test_dc_route_by_shape``).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu_torch.ops import dc_kernel

DC_ATOL = 2e-4       # tests/test_dc_pallas.py:26
GRAD_ATOL = 2e-3     # tests/test_dc_pallas.py:46
SMOOTH = [n for n in range(2, 513) if dc_kernel.mixed_plan(n)]
DC_SRC = os.path.join(os.path.dirname(dc_kernel.__file__), '..', 'csrc',
                      'dc.cu')
# exp(-2 pi i k / 16), k < 8, rounded once to f32 as the kernel's root16
ROOT16 = np.exp(-2j * np.pi * np.arange(8) / 16).astype(np.complex64)


def _c64(table):
  return (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)


def _radix2_network(v, inverse):
  """The kernel's ``dft<R>`` on (R, ...) arrays: bit reversal, then
  radix-2 decimation-in-time butterflies with the f32 roots."""
  r = v.shape[0]
  lg = r.bit_length() - 1
  rev = [int(format(i, '0{}b'.format(lg))[::-1], 2) if lg else 0
         for i in range(r)]
  v = v[rev].copy()
  for st in range(lg):
    half = 1 << st
    for i in range(r // 2):
      p, k = i & (half - 1), (i >> st) << (st + 1)
      a, b = v[k + p].copy(), v[k + p + half]
      if p:
        w = ROOT16[p * 8 // half]
        b = b * (np.conj(w) if inverse else w)
      v[k + p], v[k + p + half] = a + b, a - b
  return v


def _odd_dft(v, inverse):
  """The kernel's ``odd_dft<R>`` on (R, ...) arrays: the pairs' sums
  against the f32 cosines, their differences against the sines."""
  r = v.shape[0]
  h = (r - 1) // 2
  roots = dc_kernel.odd_roots(r)
  a = [v[j] + v[r - j] for j in range(1, h + 1)]
  b = [v[j] - v[r - j] for j in range(1, h + 1)]
  out = np.empty_like(v)
  out[0] = v[0] + sum(a)
  for k in range(1, h + 1):
    c = v[0].copy()
    t = np.zeros_like(v[0])
    for j in range(1, h + 1):
      m = j * k % r
      if m == 0:
        c = c + a[j - 1]
        continue
      cos, sin = roots[(m if m <= h else r - m) - 1]
      sin = sin if m <= h else -sin
      c = c + a[j - 1] * np.float32(cos)
      t = t + b[j - 1] * np.float32(sin)
    minus, plus = c - 1j * t, c + 1j * t
    out[k], out[r - k] = (plus, minus) if inverse else (minus, plus)
  return out


def mixed_replay(x, inverse=False):
  """Lines x (..., n) complex64 through the kernel's Stockham stages (no
  scale): butterfly j reads points j + q·n/r, twiddles them by
  exp(∓2πi·k·q/(Ns·r)), k = j mod Ns, and writes point q to
  (j − k)·r + k + q·Ns."""
  x = np.moveaxis(np.asarray(x, np.complex64), -1, 0)
  n = x.shape[0]
  tw = _c64(dc_kernel.mixed_tables(n))
  span, off = 1, 0
  for r in dc_kernel.mixed_plan(n):
    m = n // r
    j = np.arange(m)
    k = j % span
    v = x[j[None, :] + m * np.arange(r)[:, None]]       # (r, m, ...)
    if span > 1:
      w = tw[off + np.arange(r)[:, None] * span + k[None, :]]
      w = np.conj(w) if inverse else w
      v = v * w.reshape(w.shape + (1,) * (v.ndim - 2))
      off += span * r
    v = (_odd_dft if r % 2 else _radix2_network)(v, inverse)
    out = np.empty_like(x)
    out[((j - k) * r + k)[None, :] + span * np.arange(r)[:, None]] = v
    x, span = out, span * r
  return np.moveaxis(x, 0, -1)


@pytest.mark.parametrize('inverse', [False, True], ids=['fwd', 'inv'])
@pytest.mark.parametrize('n', SMOOTH)
def test_mixed_plan_replay_matches_torch_fft(n, inverse):
  rng = np.random.default_rng(n)
  x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
      np.complex64)
  got = mixed_replay(x, inverse) / np.sqrt(n)
  t = torch.from_numpy(x.astype(np.complex128))
  want = (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho')
  assert np.abs(got - want.numpy()).max() <= 1e-5


@pytest.mark.parametrize('n', SMOOTH)
def test_mixed_plan_shape(n):
  """Radices of the kernel's set whose product is n, at most
  ``MIXED_MAX_STAGES`` of them, the power of two split as ``FFT_PLANS``
  splits it; the tables hold Ns·r entries per stage after the first; the
  plan code is one byte per radix."""
  plan = dc_kernel.mixed_plan(n)
  assert int(np.prod(plan)) == n
  assert set(plan) <= set(dc_kernel.MIXED_RADICES)
  assert len(plan) <= dc_kernel.MIXED_MAX_STAGES
  twos = [r for r in plan if not r % 2]
  assert tuple(twos) == dc_kernel.FFT_PLANS.get(int(np.prod(twos)), ())
  spans = np.cumprod((1,) + plan)[:-1]
  size = sum(int(s) * r for s, r in zip(spans[1:], plan[1:]))
  assert dc_kernel.mixed_tables(n).shape == (max(size, 1), 2)
  code = dc_kernel.mixed_plan_code(n)
  assert [(code >> (8 * s)) & 255 for s in range(len(plan) + 1)] == \
      list(plan) + [0]


def test_mixed_plans_cover_the_smooth_sides():
  """168 sides from 2 to 512 have no prime factor above 13: the route
  takes each (BraTS's 240, fastMRI's 320, and 384, 192, 160, 120, 360,
  480 among them), and no other."""
  assert len(SMOOTH) == 168
  for n in (240, 320, 384, 192, 160, 120, 360, 480):
    assert n in SMOOTH
  for n in (17, 237, 244, 509, 511, 1, 513, 1025):
    assert dc_kernel.mixed_plan(n) is None
  assert dc_kernel.mixed_plan(240) == (16, 15)
  assert dc_kernel.mixed_plan(320) == (8, 8, 5)
  assert dc_kernel.mixed_plan(384) == (16, 8, 3)


def test_odd_roots_are_the_kernel_literals():
  """``csrc/dc.cu``'s ``odd_root`` holds (cos, sin) of 2πm/R as f32
  literals, case R·8 + m; the replay uses ``odd_roots``: the same
  numbers. The kernel's radix set and stage limit are the host's."""
  with open(DC_SRC) as f:
    src = f.read()
  body = re.search(r'float2 odd_root\(int r, int m\) \{(.*?)\n\}', src,
                   re.S).group(1)
  cases = {int(c): (np.float32(a), np.float32(b)) for c, a, b in re.findall(
      r'case (\d+): return make_float2\(([-0-9.e]+)f, ([-0-9.e]+)f\);',
      body)}
  want = {}
  for r in (3, 5, 7, 9, 11, 13, 15):
    for m, (c, s) in enumerate(dc_kernel.odd_roots(r), 1):
      want[r * 8 + m] = (c, s)
  assert cases == want
  assert 'constexpr int kMaxStages = {};'.format(
      dc_kernel.MIXED_MAX_STAGES) in src
  radices = re.search(r'constexpr bool mix_radix\(int r\) \{(.*?)\}', src,
                      re.S).group(1)
  assert sorted(int(r) for r in re.findall(r'r == (\d+)', radices)) == \
      sorted(dc_kernel.MIXED_RADICES)


def _dc_replay(x, k0, mask):
  """K1 on the mixed-radix route, replayed: pass 1 along W, pass 2 along
  H (merge with k0, None: zero), pass 3 along W, each line scaled by
  1/sqrt(n) after its transform as the kernel scales it."""
  b, h, w, _ = x.shape
  sh, sw = np.float32(1 / np.sqrt(h)), np.float32(1 / np.sqrt(w))
  t = mixed_replay(x[..., 0] + 1j * x[..., 1]) * sw
  k = np.swapaxes(mixed_replay(np.swapaxes(t, 1, 2)), 1, 2) * sh
  k = (1 - mask[..., 0]) * k
  if k0 is not None:
    k = k + (k0[..., 0] + 1j * k0[..., 1])
  t = np.swapaxes(mixed_replay(np.swapaxes(k, 1, 2), True), 1, 2) * sh
  y = mixed_replay(t, True) * sw
  return np.stack([y.real, y.imag], axis=-1).astype(np.float32)


def _inputs(n, seed):
  rng = np.random.RandomState(seed)
  x, k0, g = (rng.randn(2, n, n, 2).astype(np.float32) for _ in range(3))
  mask = (rng.rand(2, n, n, 1) > 0.6).astype(np.float32)
  return x, k0 * mask, g, mask


@pytest.mark.parametrize('n', [12, 20, 30, 60])
def test_mixed_dc_replay_matches_jax_dc_fused(n):
  x, k0, _, mask = _inputs(n, n)
  assert dc_kernel.dc_route(n, n) == ('mixed', 'mixed')
  want = np.asarray(jdc._dc_fused(jnp.asarray(x), jnp.asarray(k0),
                                  jnp.asarray(mask)))
  np.testing.assert_allclose(_dc_replay(x, k0, mask), want, atol=DC_ATOL)


@pytest.mark.parametrize('n', [12, 20, 30, 60])
def test_mixed_dc_vjp_replay_matches_jax_custom_vjp(n):
  """K1-bwd on the mixed-radix route (the kernel's no-k0 mode on the
  output gradient) and ``grad_k0 = fft2(g)`` against jax.grad through
  ``_dc_fused``'s custom VJP."""
  x, k0, g, mask = _inputs(n, n + 1)

  def loss(x_, k0_):
    return jnp.sum(jdc._dc_fused(x_, k0_, jnp.asarray(mask)) * g)
  want_x, want_k0 = jax.jit(jax.grad(loss, argnums=(0, 1)))(
      jnp.asarray(x), jnp.asarray(k0))
  np.testing.assert_allclose(_dc_replay(g, None, mask), np.asarray(want_x),
                             atol=GRAD_ATOL)
  gk = np.fft.fft2(g[..., 0] + 1j * g[..., 1], norm='ortho')
  np.testing.assert_allclose(np.stack([gk.real, gk.imag], -1),
                             np.asarray(want_k0), atol=GRAD_ATOL)


def test_mixed_route_takes_column_blocks_of_any_width():
  """``mesh.col_bounds`` gives a 240-wide image 120 columns on each of two
  ranks and 80 on three; 237 on two gives 119 and 118, 320 on three 107,
  107 and 106: the mixed-radix column pass takes each, as the dense one
  does, and the radix route keeps its rule."""
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  for width, s in ((240, 2), (240, 3), (237, 2), (320, 3)):
    bounds = mesh_lib.col_bounds(width, s)
    for r in range(s):
      lo, hi = bounds.block(r)
      dc_kernel.check_cols_block('pass', hi - lo, width, 'mixed', 240)
  for w in (0, 241):
    with pytest.raises(ValueError, match='{} of the image'.format(w)):
      dc_kernel.check_cols_block('pass', w, 240, 'mixed', 240)
  with pytest.raises(ValueError, match='86 of the image'):
    dc_kernel.check_cols_block('pass', 86, 256, 'fft', 256)


@pytest.mark.parametrize('h', [2 ** k for k in range(1, 10)])
def test_every_rank_column_block_takes_its_route(h):
  """A spatial group of S ranks divides H (JAX's ``shard_batch``), and
  ``mesh.col_bounds`` cuts any width W into S blocks: at a power-of-two H,
  for every W from 2 to 1024 and every S up to 16 that divides H, each
  rank's block is one that H's route (``dc_route``) takes in the column
  pass, 256×240 at S = 2 and 256×192 at S = 8 among them."""
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  for w in range(2, dc_kernel.TILE_LINE + 1):
    route = dc_kernel.dc_route(h, w)[0]
    for s in (2, 4, 8, 16):
      if h % s or s > w:
        continue
      bounds = mesh_lib.col_bounds(w, s)
      for r in range(s):
        lo, hi = bounds.block(r)
        dc_kernel.check_cols_block('pass', hi - lo, w, route, h)
