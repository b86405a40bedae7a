"""K1 and K1-bwd at every side (``csrc/dc.cu``'s chirp and split routes),
replayed on the CPU.

The kernel runs only on the card; what it computes at these sides is
decided on the host and replayed here in complex64, as
``tests/test_torch_port_dc_large.py`` replays the sides up to 1024:

* every side from 2 to 16384 has a route (``axis_route``, ``dc_route``):
  a chirp's length m is the 13-smooth m ≥ 2n − 1 one launch a pass holds
  whose plan costs least (``plan_cost``), a split's radices multiply to n, a line runs in one block, on a
  cluster or on device stages (``axis_plan``), and every radix of a device
  stage is a line one block holds with a mixed-radix plan
  (``split_radices``, ``axis_stages``);
* Bluestein's chirp (``'chirp'``), from the host tables ``axis_tables``
  (the chirp, the filter's transform, the roots or each stage's
  twiddles) through the in-place transforms of ``tests/
  test_torch_port_dc_cluster.py`` and, past a cluster, the device stages
  on the mixed-radix stage functions of ``tests/
  test_torch_port_dc_mixed.py``: against ``torch.fft`` within 1e-5,
  forward and inverse, at primes and sides with a prime factor above 13
  from 17 to 12289;
* the split route at 1280, 2048 (a block's line), 4096 and 16384 (a
  cluster's), and the device stages (Stockham stages of whole lines, each
  a block's mixed-radix transform) of all four;
* the whole DC on the kernel's routes against the JAX package's
  ``ops/dc.py::data_consistency`` as it runs on the CPU (``fft.fft2``) and
  on the TPU (``force_gemm``) within 2e-4, and its VJP against ``jax.vjp``
  within 2e-3 (``tests/test_dc_pallas.py:26,46``);
* every spatial rank's column block at these sides (``check_cols_block``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_port_dc_mixed import _c64, _odd_dft, _radix2_network

DC_ATOL = 2e-4       # tests/test_dc_pallas.py:26
GRAD_ATOL = 2e-3     # tests/test_dc_pallas.py:46
LINE_ATOL = 1e-5
CHIRP_SIDES = [17, 23, 368, 509, 521, 1021, 1031, 2053, 8191, 12289]
SPLIT_SIDES = [1280, 2048, 4096, 16384]


def _largest_prime(n):
  p, big = 2, 1
  while n > 1:
    while n % p == 0:
      n //= p
      big = p
    p += 1
  return big


def block_replay(x, r, tw, inverse):
  """Lines x (r, ...) complex64 through one block's mixed-radix plan of r
  points with its twiddles ``tw`` (no scale), as ``mix_fft`` runs it."""
  span, off = 1, 0
  for radix in dc_kernel.mixed_plan(r):
    m = r // radix
    j = np.arange(m)
    k = j % span
    v = x[j[None, :] + m * np.arange(radix)[:, None]]
    if span > 1:
      w = tw[off + np.arange(radix)[:, None] * span + k[None, :]]
      w = np.conj(w) if inverse else w
      v = v * w.reshape(w.shape + (1,) * (v.ndim - 2))
      off += span * radix
    v = (_odd_dft if radix % 2 else _radix2_network)(v, inverse)
    out = np.empty_like(x)
    out[((j - k) * radix + k)[None, :] + span * np.arange(radix)[:, None]] = v
    x, span = out, span * radix
  return x


def _stage_tables(radices):
  """The in-block and device twiddles of device stages of ``radices``, as
  ``axis_tables`` lays them out where an axis runs on them."""
  blocks = [_c64(dc_kernel._block_twiddles(r)) for r in radices]
  table = _c64(dc_kernel.stage_twiddles(radices))
  dev, span, off = [None], radices[0], 0
  for r in radices[1:]:
    dev.append(table[off:off + span * r])
    off += span * r
    span *= r
  return blocks, dev


def _split_tables(route, n, staged=False):
  """The device stages of an axis on them (``staged``: an axis a cluster
  holds, beside too few lines) and the pieces of its ``axis_tables``:
  (radices, [in-block twiddles of each stage], [device twiddles of each
  stage, None for the first], rest: the chirp and filter on the chirp
  route)."""
  assert dc_kernel.axis_plan(route, n, staged)[0] == 'stages'
  radices = dc_kernel.axis_stages(route, n, staged)
  table = _c64(dc_kernel.axis_tables(route, n, staged))
  off = 0
  head = []
  if route == 'chirp':
    m = dc_kernel.chirp_length(n)
    head = [table[:n], table[n:n + m]]
    off = n + m
  blocks = []
  for r in radices:
    size = len(dc_kernel._block_twiddles(r))
    blocks.append(table[off:off + size])
    off += size
  dev, span = [None], radices[0]
  for r in radices[1:]:
    dev.append(table[off:off + span * r])
    off += span * r
    span *= r
  assert off == len(table)
  return radices, blocks, dev, head


def stages_replay(x, radices, blocks, dev, inverse):
  """Lines x (..., N) complex64 through the device stages (no scale): stage
  s's butterfly j < N / R reads points j + q·N/R, twiddles them by the
  stage's table ``[q·Ns + k]`` (k = j mod Ns), runs the block's transform
  of R points and writes point q to (j − k)·R + k + q·Ns."""
  x = np.moveaxis(np.asarray(x, np.complex64), -1, 0)
  n = x.shape[0]
  span = 1
  for r, tw, dtw in zip(radices, blocks, dev):
    m = n // r
    j = np.arange(m)
    k = j % span
    v = x[j[None, :] + m * np.arange(r)[:, None]]          # (r, m, ...)
    if span > 1:
      w = dtw[np.arange(r)[:, None] * span + k[None, :]]
      w = np.conj(w) if inverse else w
      v = v * w.reshape(w.shape + (1,) * (v.ndim - 2))
    v = block_replay(v, r, tw, inverse)
    out = np.empty_like(x)
    out[((j - k) * r + k)[None, :] + span * np.arange(r)[:, None]] = v
    x, span = out, span * r
  return np.moveaxis(x, 0, -1)


def chirp_replay(x, inverse=False, staged=False):
  """Lines x (..., n) complex64 through the chirp route (no scale): the
  chirped line zero-padded to m, its transform, the product with the
  filter's transform, the inverse transform, the chirp on the way out; the
  inverse DFT conjugates on the way in and out. In one launch a pass as
  ``tests/test_torch_port_dc_cluster.py`` replays it, else (or with
  ``staged``) on the device stages."""
  from tests.test_torch_port_dc_cluster import one_launch_replay
  x = np.asarray(x, np.complex64)
  n = x.shape[-1]
  if dc_kernel.axis_plan('chirp', n, staged)[0] != 'stages':
    return one_launch_replay(x, 'chirp', inverse)
  radices, blocks, dev, (c, f) = _split_tables('chirp', n, staged)
  m = f.shape[0]
  a = np.zeros(x.shape[:-1] + (m,), np.complex64)
  a[..., :n] = (np.conj(x) if inverse else x) * np.conj(c)
  y = stages_replay(a, radices, blocks, dev, False) * f
  y = stages_replay(y, radices, blocks, dev, True)[..., :n] * np.conj(c)
  return np.conj(y) if inverse else y


def split_replay(x, inverse=False, staged=False):
  """Lines x (..., n) complex64 through the split route (no scale): in one
  launch a pass, or (also with ``staged``) on its device stages."""
  from tests.test_torch_port_dc_cluster import one_launch_replay
  if dc_kernel.axis_plan('split', x.shape[-1], staged)[0] != 'stages':
    return one_launch_replay(x, 'split', inverse)
  radices, blocks, dev, _ = _split_tables('split', x.shape[-1], staged)
  return stages_replay(x, radices, blocks, dev, inverse)


def _line(n, seed):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
      np.complex64)


def _torch_fft(x, inverse):
  t = torch.from_numpy(x.astype(np.complex128))
  return (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho').numpy()


@pytest.mark.parametrize('lo,hi', [(2, 4097), (4097, 8193), (8193, 12289),
                                   (12289, 16385)],
                         ids=['2-4096', '4097-8192', '8193-12288',
                              '12289-16384'])
def test_every_side_has_a_route(lo, hi):
  """Every side from 2 to 16384 has a route: the radix and mixed-radix
  routes to 1024 as before, the split route for the longer sides whose
  prime factors are at most 13, for the sides with a larger one dense lines
  up to ``DENSE_MAX`` and the chirp route above. In one launch a pass, the
  plan's radices multiply to the transform's length, a block's share is at
  most BLOCK_LINE and the first radix a multiple of the cluster's blocks;
  on device stages each radix is a line one block holds."""
  for n in range(lo, hi):
    route = dc_kernel.axis_route(n)
    smooth = _largest_prime(n) <= 13
    if n <= 1024:
      want = 'fft' if n & (n - 1) == 0 else 'mixed' if smooth else \
          'dft' if n <= dc_kernel.DENSE_MAX else 'chirp'
    else:
      want = 'split' if smooth else 'chirp'
    assert route == want, (n, route)
    assert dc_kernel.dc_route(n, n) == (route, route)
    if route in ('chirp', 'split'):
      length = dc_kernel.axis_length(route, n)
      radices = dc_kernel.axis_stages(route, n)
      assert int(np.prod(radices)) == length
      kind, c, plan = dc_kernel.axis_plan(route, n)
      if kind == 'stages':
        assert radices == plan
        assert all(dc_kernel.mixed_plan(r) for r in radices)
        assert max(radices) <= dc_kernel.STAGE_LINE
      else:
        assert int(np.prod(plan)) == length and plan[0] % c == 0
        assert length // c <= dc_kernel.BLOCK_LINE
        assert len(plan) <= dc_kernel.BLOCK_MAX_STAGES + (c > 1)


def test_side_one_and_below_have_no_route():
  assert dc_kernel.axis_route(1) is None and dc_kernel.axis_route(0) is None
  assert dc_kernel.dc_route(1, 64) is None and dc_kernel.dc_route(64, 1) is None


@pytest.mark.parametrize('n', CHIRP_SIDES + [65537, 2 ** 20 + 7])
def test_chirp_length_covers_the_linear_convolution(n):
  """m ≥ 2n − 1 has prime factors of at most 13. Where one launch a pass
  holds such an m, m is the one from 2n − 1 to twice that whose plan costs
  least (``plan_cost``) of those the least such m's launch (one block or a
  cluster) holds; else m is the least with device stages (no smaller such
  m has a line plan). Up to n = 2309 (m ≤ 4628 = BLOCK_LINE) the whole
  convolution is one block's line, up to 18479 a cluster's (m ≤
  8·BLOCK_LINE), above it runs on device stages."""
  m = dc_kernel.chirp_length(n)
  lo = 2 * n - 1
  assert m >= lo and _largest_prime(m) <= 13
  kind, c, plan = dc_kernel.axis_plan('chirp', n)
  assert int(np.prod(plan)) == m
  if kind == 'stages':
    for smaller in range(lo, min(m, 2 * n + 400)):
      if _largest_prime(smaller) <= 13:
        assert dc_kernel.line_plan(smaller, n) is None
  else:
    least = next(k for k in range(lo, m + 1) if _largest_prime(k) <= 13
                 and dc_kernel.line_plan(k, n))
    assert (dc_kernel.line_plan(least, n)[0] == 1) == (kind == 'block')
    cost = dc_kernel.plan_cost(m, plan, c)
    for other in range(lo, min(2 * lo, 8 * dc_kernel.BLOCK_LINE) + 1):
      held = _largest_prime(other) <= 13 and dc_kernel.line_plan(other, n)
      if held and (held[0] == 1) == (kind == 'block'):
        assert dc_kernel.plan_cost(other, held[1], held[0]) >= cost, other
  assert kind == ('block' if n <= 2309 else 'cluster' if n <= 18479
                  else 'stages')
  assert (kind == 'block') == (m <= dc_kernel.BLOCK_LINE)
  radices = dc_kernel.axis_stages('chirp', n)
  assert (len(radices) == 1) == (kind != 'stages')


@pytest.mark.parametrize('n,want', [(1280, (32, 40)), (2048, (32, 64)),
                                    (4096, (64, 64)), (16384, (128, 128)),
                                    (1536, (32, 48)), (13 ** 5, (169, 2197)),
                                    (2 ** 23, (2048, 4096)),
                                    (2 ** 25, (128, 512, 512))])
def test_split_factors_multiply_to_the_side(n, want):
  """Device stages' radices multiply to n, each a side of at most
  STAGE_LINE with a mixed-radix plan the kernel checks (its plan code), as
  few and as even as the side allows; a side one block or a cluster holds
  launches as one stage (its host array [1, C, S, radices...]), a longer
  one on its radices."""
  radices = dc_kernel.split_radices(n)
  assert radices == want
  assert int(np.prod(radices)) == n
  stages = dc_kernel.axis_stages('split', n)
  kind, c, line = dc_kernel.axis_plan('split', n)
  assert stages == ((n,) if kind != 'stages' else radices)
  assert kind == ('block' if n <= 3500 else 'cluster' if n <= 28000
                  else 'stages')
  route, plan, codes = dc_kernel._plan_args('split', n)
  assert (route, plan) == (4, n)
  if kind == 'stages':
    want_codes = [len(stages)] + [
        v for r in stages for v in (r, dc_kernel._code(dc_kernel.mixed_plan(
            r)))]
  else:
    want_codes = [1, c, len(line)] + list(line)
  codes = np.ctypeslib.as_array(
      (dc_kernel.ctypes.c_uint64 * len(want_codes)).from_address(
          codes.value))
  assert list(codes) == want_codes
  for r in radices:
    plan = dc_kernel.mixed_plan(r)
    assert int(np.prod(plan)) == r and set(plan) <= set(dc_kernel.MIXED_RADICES)
    assert len(plan) <= dc_kernel.MIXED_MAX_STAGES


def test_chirp_tables_from_exact_phases():
  """The chirp's phase π·(j² mod 2n)/n from exact integers (j² past 2^53
  would round in f64), and the filter's transform with 1/m folded in."""
  n = 12289
  c, f = (_c64(t) for t in dc_kernel.chirp_tables(n))
  j = np.arange(n)
  want = np.exp(1j * np.pi * ((j * j) % (2 * n)) / n)
  assert np.abs(c - want).max() <= 1e-7
  m = dc_kernel.chirp_length(n)
  b = np.zeros(m, np.complex128)
  b[:n], b[m - n + 1:] = want, want[1:][::-1]
  assert np.abs(f - np.fft.fft(b) / m).max() <= 1e-7


@pytest.mark.parametrize('inverse', [False, True], ids=['fwd', 'inv'])
@pytest.mark.parametrize('n', CHIRP_SIDES)
def test_chirp_replay_matches_torch_fft(n, inverse):
  """The chirp route at every side it takes, and at 17 and 23, which take
  the dense route by default (``DENSE_MAX``) and the chirp route where a
  caller names it (``chip_smoke.py`` phase 11 times both)."""
  assert dc_kernel.axis_route(n) == ('dft' if n <= dc_kernel.DENSE_MAX
                                     else 'chirp')
  x = _line(n, n)
  got = chirp_replay(x, inverse) * np.float32(1 / np.sqrt(n))
  assert np.abs(got - _torch_fft(x, inverse)).max() <= LINE_ATOL


@pytest.mark.parametrize('inverse', [False, True], ids=['fwd', 'inv'])
@pytest.mark.parametrize('n', SPLIT_SIDES)
def test_split_replay_matches_torch_fft(n, inverse):
  """The split route as it runs (one block's line up to BLOCK_LINE, device
  stages above), and the device stages of ``split_radices`` at every
  side."""
  assert dc_kernel.axis_route(n) == 'split'
  x = _line(n, n)
  want = _torch_fft(x, inverse)
  got = split_replay(x, inverse) * np.float32(1 / np.sqrt(n))
  assert np.abs(got - want).max() <= LINE_ATOL
  radices = dc_kernel.split_radices(n)
  got = stages_replay(x, radices, *_stage_tables(radices), inverse)
  assert np.abs(got * np.float32(1 / np.sqrt(n)) - want).max() <= LINE_ATOL


def line_replay(x, route, inverse):
  """Lines x (..., n) complex64 through the kernel's route for n, scaled
  by 1/sqrt(n) after the transform as the kernel scales them."""
  from tests.test_torch_port_dc_mixed import mixed_replay
  n = x.shape[-1]
  y = {'chirp': chirp_replay, 'split': split_replay}.get(
      route, mixed_replay)(x, inverse)
  return y * np.float32(1 / np.sqrt(n))


def dc_replay(x, k0, mask):
  """K1 on the kernel's routes (``dc_route``): pass 1 along W on W's
  route, pass 2 along H on H's (merge with k0, None: zero), pass 3."""
  b, h, w, _ = x.shape
  route_h, route_w = dc_kernel.dc_route(h, w)
  t = line_replay(x[..., 0] + 1j * x[..., 1], route_w, False)
  k = np.swapaxes(line_replay(np.swapaxes(t, 1, 2), route_h, False), 1, 2)
  k = (1 - mask[..., 0]) * k
  if k0 is not None:
    k = k + (k0[..., 0] + 1j * k0[..., 1])
  t = np.swapaxes(line_replay(np.swapaxes(k, 1, 2), route_h, True), 1, 2)
  y = line_replay(t, route_w, True)
  return np.stack([y.real, y.imag], axis=-1).astype(np.float32)


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


DC_SHAPES = {'1031x16': (1031, 16), '16x2048': (16, 2048),
             '640x368': (640, 368), '368x640': (368, 640)}
# Axes on device stages, past a cluster: H's chirp (m = 37044 = 189·196),
# W's split (32768 = 128·256)
STAGE_SHAPES = {'18481x4': (18481, 4), '8x32768': (8, 32768)}


def _jax_dc_matches(h, w):
  x, k0, _, mask = _inputs(h, w, h + w)
  want = np.asarray(jax.jit(jdc.data_consistency)(
      jnp.asarray(x), jnp.asarray(k0), jnp.asarray(mask)))
  np.testing.assert_allclose(dc_replay(x, k0, mask), want, atol=DC_ATOL)


@pytest.mark.parametrize('h,w', list(DC_SHAPES.values()), ids=list(DC_SHAPES))
def test_dc_replay_matches_jax_data_consistency(h, w, jax_lowering):
  """H on the chirp route in one block (1031: m = 2112) and W on the split
  route in one block (2048), fastMRI's knee k-space both ways (368 on the
  chirp route, m = 792)."""
  assert 'chirp' in dc_kernel.dc_route(h, w) or \
      'split' in dc_kernel.dc_route(h, w)
  _jax_dc_matches(h, w)


@pytest.mark.parametrize('h,w', list(STAGE_SHAPES.values()),
                         ids=list(STAGE_SHAPES))
def test_dc_replay_on_device_stages_matches_jax(h, w):
  """The chirp and split routes on device stages, past the lines a cluster
  holds and the sides JAX's GEMM lowering is held at: against
  ``fft.fft2``'s DC within 2e-4."""
  assert max(len(dc_kernel.axis_stages(r, n)) for r, n in zip(
      dc_kernel.dc_route(h, w), (h, w)) if r in ('chirp', 'split')) == 2
  _jax_dc_matches(h, w)


@pytest.mark.parametrize('h,w', list(DC_SHAPES.values()), ids=list(DC_SHAPES))
def test_dc_vjp_replay_matches_jax_vjp(h, w, jax_lowering):
  """K1-bwd (the kernel's no-k0 mode on the output gradient) and
  ``grad_k0 = fft2(g)``, as ``_DCFunction`` computes them, against
  ``jax.vjp`` of ``data_consistency``."""
  x, k0, g, mask = _inputs(h, w, h + w + 1)
  _, vjp = jax.vjp(lambda x_, k0_: jdc.data_consistency(
      x_, k0_, jnp.asarray(mask)), jnp.asarray(x), jnp.asarray(k0))
  want_x, want_k0 = vjp(jnp.asarray(g))
  np.testing.assert_allclose(dc_replay(g, None, mask), np.asarray(want_x),
                             atol=GRAD_ATOL)
  gk = torch.fft.fft2(torch.from_numpy(g[..., 0] + 1j * g[..., 1]),
                      norm='ortho').numpy()
  np.testing.assert_allclose(np.stack([gk.real, gk.imag], -1),
                             np.asarray(want_k0), atol=GRAD_ATOL)


@pytest.mark.parametrize('h,w,s', [(2048, 2048, 2), (2048, 2048, 4),
                                   (1031, 1031, 3), (640, 368, 3)],
                         ids=['2048-S2', '2048-S4', '1031-S3', '640x368-S3'])
def test_every_rank_column_block_takes_its_route(h, w, s):
  """Each rank's column block (``mesh.col_bounds``: 1024 or 512 of 2048,
  344, 344 and 343 of 1031, 123, 123 and 122 of 368) is one that H's route
  takes in the column pass: the split and chirp routes (2048, 1031) and
  the mixed-radix route (640) walk any block."""
  route = dc_kernel.dc_route(h, w)[0]
  assert route == {2048: 'split', 1031: 'chirp', 640: 'mixed'}[h]
  bounds = mesh_lib.col_bounds(w, s)
  widths = [hi - lo for lo, hi in map(bounds.block, range(s))]
  assert sum(widths) == w and max(widths) - min(widths) <= 1
  for cols in widths:
    dc_kernel.check_cols_block('pass', cols, w, route, h)
  for cols in (1, w - 1, w):
    dc_kernel.check_cols_block('pass', cols, w, route, h)


def test_work_buffers_of_the_device_stages():
  """Passes on device stages take two buffers of the transform's length a
  line (``work_elems``); a block's line, a cluster's and the tile routes
  none."""
  assert dc_kernel.work_elems('split', 32768, 10) == 2 * 10 * 32768
  assert dc_kernel.work_elems('chirp', 18481, 3) == 2 * 3 * 37044
  assert dc_kernel.work_elems('split', 16384, 3) == 0
  assert dc_kernel.work_elems('chirp', 2053, 3) == 0
  assert dc_kernel.work_elems('split', 4096, 3) == 0
  assert dc_kernel.work_elems('chirp', 1031, 3) == 0
  assert dc_kernel.work_elems('mixed', 240, 3) == 0
  assert dc_kernel.work_elems('fft', 256, 3) == 0


def test_index_range_is_the_only_refusal():
  """A CUDA tensor is refused only where an int32 index would overflow:
  up to 65535 images, B·H and B·W below 2^31, sides up to 2^29."""
  dc_kernel._check_ranges('dc', 65535, 1024, 1024)
  dc_kernel._check_ranges('dc', 1, 2 ** 29, 2)
  for b, h, w in ((65536, 2, 2), (1, 2 ** 29 + 1, 2), (2 ** 12, 2 ** 19, 8),
                  (0, 8, 8)):
    with pytest.raises(ValueError, match='int32 index range'):
      dc_kernel._check_ranges('dc', b, h, w)
