"""K1 and K1-bwd at sides 513 to 1024 (``csrc/dc.cu``), replayed on the CPU.

The kernel runs only on the card; what it computes at these sides is
decided on the host and replayed here, as ``tests/test_torch_port_dc_mixed.py``
and ``tests/test_torch_port_kernel_layouts.py`` replay the sides up to 512:

* the routes of every side from 513 to 1024 and of rectangles such as
  fastMRI's 640 × 368 knee k-space (``dc_route``), and those above 1024;
* the radix plan of 1024 and the mixed-radix plan of every side from 513
  to 1024 whose prime factors are at most 13, stage by stage in complex64
  against ``torch.fft`` within 1e-5, each within ``MIXED_MAX_STAGES``;
* lines of 521 and 1021 points on the chirp route, which takes them (the
  dense route keeps to small sides);
* the whole DC at 640 × 640 and 640 × 368 on the kernel's plans (rows
  along W on W's route, columns along H on H's) against the JAX package's
  ``ops/dc.py::data_consistency`` as JAX runs it on the CPU (``fft.fft2``)
  and as it runs on the TPU (``force_gemm``: the split-real GEMM DFT with
  its radix-2 splits above 512) within 2e-4, and its VJP (``DC(g, 0, m)``,
  ``fft2(g)``) against ``jax.vjp`` within 2e-3 (``tests/test_dc_pallas.py
  :26,46``);
* the column blocks of a spatial rank at these sides (``check_cols_block``,
  the radix route's 8-column strips above 512 rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_port_dc_any_side import dc_replay, line_replay
from tests.test_torch_port_dc_mixed import mixed_replay
from tests.test_torch_port_kernel_layouts import _replay as radix_replay

DC_ATOL = 2e-4       # tests/test_dc_pallas.py:26
GRAD_ATOL = 2e-3     # tests/test_dc_pallas.py:46
LARGE_SMOOTH = [n for n in range(513, 1025) if dc_kernel.mixed_plan(n)]


def _largest_prime(n):
  p, big = 2, 1
  while n > 1:
    while n % p == 0:
      n //= p
      big = p
    p += 1
  return big


def test_routes_of_every_side_from_513_to_1024():
  """Every side from 513 to 1024 has a route: the radix plans at 1024, the
  mixed-radix plans where no prime factor exceeds 13, the chirp route
  where one does; the sides above 1024 have one too (the split and chirp
  routes, ``tests/test_torch_port_dc_any_side.py``)."""
  for n in range(513, 1025):
    want = 'fft' if n == 1024 else \
        'mixed' if _largest_prime(n) <= 13 else 'chirp'
    assert dc_kernel.axis_route(n) == want
    assert dc_kernel.dc_route(n, n) == (want, want)
  for n, want in ((1025, 'chirp'), (1026, 'chirp'), (1536, 'split'),
                  (2048, 'split')):
    assert dc_kernel.axis_route(n) == want
    assert dc_kernel.dc_route(n, n) == (want, want)
  assert dc_kernel.TILE_LINE == 1024


@pytest.mark.parametrize('h,w,want', [
    (640, 368, ('mixed', 'chirp')), (368, 640, ('chirp', 'mixed')),
    (1024, 240, ('mixed', 'mixed')), (1024, 1024, ('fft', 'fft')),
    (1024, 512, ('fft', 'fft')), (2, 1024, ('fft', 'fft')),
    (1024, 1021, ('mixed', 'chirp')), (768, 768, ('mixed', 'mixed')),
    (1021, 1021, ('chirp', 'chirp')), (1025, 640, ('chirp', 'mixed')),
    (640, 1025, ('mixed', 'chirp')), (1024, 1, None)])
def test_routes_of_large_rectangles(h, w, want):
  """One route per axis; a power-of-two H keeps the radix route only
  beside a power-of-two W."""
  assert dc_kernel.dc_route(h, w) == want


def test_large_smooth_sides_keep_to_the_stage_limit():
  """77 sides from 513 to 1024 have no prime factor above 13 (1024
  among them); none needs more than ``MIXED_MAX_STAGES`` stages (1000 =
  8·5·5·5 and 990 = 2·15·3·11 take four), and 1024's plan is the radix
  route's."""
  assert len(LARGE_SMOOTH) == 77
  assert max(len(dc_kernel.mixed_plan(n)) for n in LARGE_SMOOTH) == \
      dc_kernel.MIXED_MAX_STAGES
  assert dc_kernel.mixed_plan(1000) == (8, 5, 5, 5)
  assert dc_kernel.mixed_plan(990) == (2, 15, 3, 11)
  assert dc_kernel.mixed_plan(640) == (16, 8, 5)
  assert dc_kernel.mixed_plan(768) == (16, 16, 3)
  assert dc_kernel.mixed_plan(1024) == dc_kernel.FFT_PLANS[1024] == (16, 8, 8)
  assert dc_kernel.mixed_plan(1025) is None


@pytest.mark.parametrize('inverse', [False, True], ids=['fwd', 'inv'])
@pytest.mark.parametrize('n', LARGE_SMOOTH)
def test_large_mixed_plan_replay_matches_torch_fft(n, inverse):
  """The plan of each side, its radices of the kernel's set and its
  twiddles, stage by stage as ``mix_rows``/``mix_cols`` run it."""
  plan = dc_kernel.mixed_plan(n)
  assert int(np.prod(plan)) == n and len(plan) <= dc_kernel.MIXED_MAX_STAGES
  assert set(plan) <= set(dc_kernel.MIXED_RADICES)
  rng = np.random.default_rng(n)
  x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
      np.complex64)
  got = mixed_replay(x, inverse) / np.sqrt(n)
  t = torch.from_numpy(x.astype(np.complex128))
  want = (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho')
  assert np.abs(got - want.numpy()).max() <= 1e-5


@pytest.mark.parametrize('inverse', [False, True], ids=['fwd', 'inv'])
def test_radix_plan_1024_replay_matches_torch_fft(inverse):
  """1024's radix plan (16, 8, 8) as ``row_fft``/``col_dc`` run it (one
  radix-16 and two radix-8 stages, 16 points a thread); its twiddle
  tables and plan code as the kernel checks them."""
  rng = np.random.default_rng(1024)
  x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(
      np.complex64)
  got = radix_replay(x, inverse) / np.sqrt(1024)
  t = torch.from_numpy(x.astype(np.complex128))
  want = (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho')
  assert np.abs(got - want.numpy()).max() <= 1e-5
  assert dc_kernel.fft_tables(1024).shape == (16 * 8 + 128 * 8, 2)
  assert dc_kernel.plan_code(1024) == 16 | 8 << 8 | 8 << 16


@pytest.mark.parametrize('n', [521, 1021])
def test_large_dft_table_lines_match_torch_fft(n):
  """A line at a prime side above 512, on the route that takes it since
  the dense route keeps to small sides: Bluestein's chirp, replayed from
  its host tables, forward and inverse, against ``torch.fft``."""
  assert dc_kernel.axis_route(n) == 'chirp'
  rng = np.random.default_rng(n)
  x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
      np.complex64)
  t = torch.from_numpy(x.astype(np.complex128))
  for inverse in (False, True):
    got = line_replay(x, 'chirp', inverse)
    want = (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho')
    assert np.abs(got - want.numpy()).max() <= 2e-5


def _dc_replay(x, k0, mask):
  """K1 on the kernel's routes (``dc_route``): pass 1 along W on W's
  route, pass 2 along H on H's (merge with k0, None: zero), pass 3."""
  return dc_replay(x, k0, mask)


def _inputs(h, w, seed):
  rng = np.random.RandomState(seed)
  x, k0, g = (rng.randn(1, h, w, 2).astype(np.float32) for _ in range(3))
  mask = (rng.rand(1, h, w, 1) > 0.6).astype(np.float32)
  return x, k0 * mask, g, mask


@pytest.fixture(params=['fft2', 'gemm'])
def jax_lowering(request):
  """The JAX DC as it runs on the CPU (``fft.fft2``) or forced onto the
  TPU's split-real GEMM lowering (``force_gemm``), reset afterwards."""
  jdc.force_gemm(request.param == 'gemm')
  try:
    yield request.param
  finally:
    jdc.force_gemm(False)


@pytest.mark.parametrize('h,w', [(640, 640), (640, 368)],
                         ids=['640', '640x368'])
def test_large_dc_replay_matches_jax_data_consistency(h, w, jax_lowering):
  x, k0, _, mask = _inputs(h, w, h + w)
  want = np.asarray(jax.jit(jdc.data_consistency)(
      jnp.asarray(x), jnp.asarray(k0), jnp.asarray(mask)))
  np.testing.assert_allclose(_dc_replay(x, k0, mask), want, atol=DC_ATOL)


@pytest.mark.parametrize('h,w', [(640, 640), (640, 368)],
                         ids=['640', '640x368'])
def test_large_dc_vjp_replay_matches_jax_vjp(h, w, jax_lowering):
  """K1-bwd (the kernel's no-k0 mode on the output gradient) and
  ``grad_k0 = fft2(g)``, as ``_DCFunction`` computes them, against
  ``jax.vjp`` of ``data_consistency``."""
  x, k0, g, mask = _inputs(h, w, h + w + 1)
  _, vjp = jax.vjp(lambda x_, k0_: jdc.data_consistency(
      x_, k0_, jnp.asarray(mask)), jnp.asarray(x), jnp.asarray(k0))
  want_x, want_k0 = vjp(jnp.asarray(g))
  np.testing.assert_allclose(_dc_replay(g, None, mask), np.asarray(want_x),
                             atol=GRAD_ATOL)
  gk = torch.fft.fft2(torch.from_numpy(g[..., 0] + 1j * g[..., 1]),
                      norm='ortho').numpy()
  np.testing.assert_allclose(np.stack([gk.real, gk.imag], -1),
                             np.asarray(want_k0), atol=GRAD_ATOL)


@pytest.mark.parametrize('height', [640, 1024, 368])
def test_spatial_column_blocks_of_640_take_their_route(height):
  """A 640-wide image's column blocks on S = 2 (320 each) and 3 (214, 213,
  213: ``mesh.col_bounds``) are blocks that H's route takes in the column
  pass: mixed-radix at 640 and at 1024 (a power-of-two H beside a W of no
  power-of-two plan), the chirp route at 368."""
  route = dc_kernel.dc_route(height, 640)[0]
  assert route == ('chirp' if height == 368 else 'mixed')
  for s in (2, 3):
    bounds = mesh_lib.col_bounds(640, s)
    widths = [hi - lo for lo, hi in map(bounds.block, range(s))]
    assert widths == ([320, 320] if s == 2 else [214, 213, 213])
    for cols in widths:
      dc_kernel.check_cols_block('pass', cols, 640, route, height)


def test_radix_column_strips_narrow_above_512_rows():
  """The radix column pass walks 16-column strips up to 512 rows and
  8-column strips above (``radix_strip``, ``csrc/dc.cu``'s ``col_strip``):
  at 1024 rows every rank's block of a power-of-two width takes it, and a
  block of whole 8-column strips that is not one of 16 passes only
  there."""
  assert [dc_kernel.radix_strip(h) for h in (2, 512, 513, 1024)] == \
      [16, 16, 8, 8]
  for width in (2 ** k for k in range(1, 11)):
    for s in (2, 4, 8, 16, 32, 64):
      if s <= width:
        dc_kernel.check_cols_block('pass', width // s, width, 'fft', 1024)
  dc_kernel.check_cols_block('pass', 24, 48, 'fft', 1024)
  with pytest.raises(ValueError, match='16-column strips'):
    dc_kernel.check_cols_block('pass', 24, 48, 'fft', 512)
  with pytest.raises(ValueError, match='8-column strips'):
    dc_kernel.check_cols_block('pass', 12, 48, 'fft', 1024)
