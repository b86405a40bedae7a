"""K1 and K1-bwd on the chirp and split routes in one launch a pass
(``csrc/dc.cu``'s ``block_lines`` and ``cluster_lines``), replayed on the
CPU.

The kernels run only on the card; what they compute is decided on the host
and replayed here in complex64, stage by stage as they run it:

* the in-place transform of a line: decimation in frequency (natural order
  in, each frequency at its digit-reversed position, ``line_positions``,
  out) and its adjoint, decimation in time; one table of the transform's
  roots (``dft_table``); on the chirp route the zero padding neither
  staged nor read, the filter at the positions of its frequencies; against
  ``torch.fft`` within 1e-5 at sides from 244 to 16384, forward and
  inverse;
* the cluster's decomposition: a line of N points over C blocks' shares,
  the first stage's butterflies shared out over the blocks and reading and
  writing across them (the exchange through distributed shared memory),
  every later stage inside one block's share;
* the whole DC and its VJP against the JAX package's
  ``ops/dc.py::data_consistency`` and ``jax.vjp`` (``tests/
  test_dc_pallas.py:26,46``) at the routes' boundaries: the largest chirp
  length and split line one block holds, the smallest and the largest a
  cluster holds;
* every spatial rank's column block on the cluster route, and the limits
  the host and ``csrc/dc.cu`` share.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csmri_refinement_tpu.ops import dc as jdc
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_port_dc_mixed import DC_SRC, _c64, _odd_dft, \
    _radix2_network

DC_ATOL = 2e-4       # tests/test_dc_pallas.py:26
GRAD_ATOL = 2e-3     # tests/test_dc_pallas.py:46
LINE_ATOL = 1e-5
# The routes' boundaries (sides): the largest chirp side whose m one block
# holds (2309: m = 4620) and the smallest on a cluster (2311: m = 4802),
# the largest on a cluster (18479: m = 36960); the largest split line in a
# block (3500), the smallest on a cluster (3510) and the largest (28000).
CHIRP_BLOCK_MAX, CHIRP_CLUSTER_MIN, CHIRP_CLUSTER_MAX = 2309, 2311, 18479
SPLIT_BLOCK_MAX, SPLIT_CLUSTER_MIN, SPLIT_CLUSTER_MAX = 3500, 3510, 28000
LINE_SIDES = {'chirp': [244, 368, 509, 1031, 2053, CHIRP_BLOCK_MAX,
                        CHIRP_CLUSTER_MIN, 4099, 12289, 16381],
              'split': [1280, 2048, SPLIT_BLOCK_MAX, SPLIT_CLUSTER_MIN, 4096,
                        16384]}


def stage_geometry(plan):
  """(L, R, M) of each stage of the in-place transform of ``plan``: stage
  s works on blocks of L = N / (R_0⋯R_(s−1)) positions, radix R, M = L / R
  butterflies a block."""
  out, length = [], int(np.prod(plan))
  for r in plan:
    out.append((length, r, length // r))
    length //= r
  return out


def _butterflies(n, length, m):
  """Positions p0 = blk·L + j of a stage's butterflies, and their j."""
  blk, j = np.meshgrid(np.arange(n // length), np.arange(m), indexing='ij')
  return (blk * length + j).reshape(-1), j.reshape(-1)


def _dft(v, inverse):
  return (_odd_dft if v.shape[0] % 2 else _radix2_network)(v, inverse)


def _twiddles(roots, j, r, step):
  """W_L^(jk) of butterflies j, k < r: root j·k·(N / L) of the table."""
  return roots[(j[None, :] * np.arange(r)[:, None]) * step]


def dif_replay(x, plan, roots):
  """Lines x (N, ...) complex64, positions first, through ``dif_stage``:
  butterfly (blk, j) of each stage reads positions p0 + q·M, runs the
  R-point DFT, multiplies result k by W_L^(jk) and writes it back to
  p0 + k·M (in place)."""
  x = np.array(x, np.complex64)
  n = x.shape[0]
  for length, r, m in stage_geometry(plan):
    p0, j = _butterflies(n, length, m)
    idx = p0[None, :] + m * np.arange(r)[:, None]
    v = _dft(x[idx], False)
    w = _twiddles(roots, j, r, n // length)
    x[idx] = v * w.reshape(w.shape + (1,) * (v.ndim - 2))
  return x


def dit_replay(x, plan, roots):
  """The adjoint of ``dif_replay`` (``dit_stage``): the stages in reverse,
  each butterfly's points times the conjugate twiddles, then the inverse
  R-point DFT: digit-reversed positions in, natural order out, unscaled."""
  x = np.array(x, np.complex64)
  n = x.shape[0]
  for length, r, m in reversed(stage_geometry(plan)):
    p0, j = _butterflies(n, length, m)
    idx = p0[None, :] + m * np.arange(r)[:, None]
    w = np.conj(_twiddles(roots, j, r, n // length))
    x[idx] = _dft(x[idx] * w.reshape(w.shape + (1,) * (x.ndim - 1)), True)
  return x


def line_tables(route, n):
  """An axis's plan and the pieces of its ``axis_tables`` in one launch a
  pass: (C, plan, roots, chirp, filter at positions, positions)."""
  kind, c, plan = dc_kernel.axis_plan(route, n)
  assert kind in ('block', 'cluster')
  length = dc_kernel.axis_length(route, n)
  table = dc_kernel.axis_tables(route, n)
  if route == 'split':
    pos = table[length:].reshape(-1).view(np.int32)[:length]
    assert len(table) == length + (length + 1) // 2
    return c, plan, _c64(table[:length]), None, None, pos
  t = _c64(table)
  assert len(t) == n + 2 * length
  return c, plan, t[n + length:], t[:n], t[n:n + length], None


def one_launch_replay(x, route, inverse=False):
  """Lines x (..., n) complex64 as ``block_lines``/``cluster_lines`` runs
  a pass 1 or 3 (unscaled): on the chirp route the chirped raw points in
  (the zero padding never read), the forward transform, the filter at the
  positions, the adjoint, the chirp out (the inverse conjugated in and
  out); on the split route the forward transform and the store reading
  each frequency k at ``pos[k]``."""
  x = np.moveaxis(np.asarray(x, np.complex64), -1, 0)
  n = x.shape[0]
  _, plan, roots, chirp, filt, pos = line_tables(route, n)
  length = len(roots)
  a = np.conj(x) if inverse else x
  if route == 'split':
    y = dif_replay(a, plan, roots)[pos]
  else:
    buf = np.zeros((length,) + x.shape[1:], np.complex64)
    buf[:n] = a * np.conj(chirp).reshape((n,) + (1,) * (x.ndim - 1))
    f = filt.reshape((length,) + (1,) * (x.ndim - 1))
    y = dit_replay(dif_replay(buf, plan, roots) * f, plan, roots)[:n]
    y = y * np.conj(chirp).reshape((n,) + (1,) * (x.ndim - 1))
  return np.moveaxis(np.conj(y) if inverse else y, 0, -1)


def _line(n, seed, lines=2):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal((lines, n)) +
          1j * rng.standard_normal((lines, n))).astype(np.complex64)


@pytest.mark.parametrize('inverse', [False, True], ids=['fwd', 'inv'])
@pytest.mark.parametrize('route,n', [(r, n) for r in LINE_SIDES
                                     for n in LINE_SIDES[r]])
def test_one_launch_replay_matches_torch_fft(route, n, inverse):
  """The in-place transform of a block's line or a cluster's, from the
  host's tables, against ``torch.fft`` with ``norm='ortho'``."""
  assert dc_kernel.axis_route(n) == route
  assert dc_kernel.axis_plan(route, n)[0] in ('block', 'cluster')
  x = _line(n, n)
  got = one_launch_replay(x, route, inverse) * np.float32(1 / np.sqrt(n))
  t = torch.from_numpy(x.astype(np.complex128))
  want = (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho')
  assert np.abs(got - want.numpy()).max() <= LINE_ATOL


@pytest.mark.parametrize('route,n', [('chirp', 244), ('chirp', 1031),
                                     ('chirp', 2053), ('split', 2048)])
def test_first_stage_skips_the_zero_padding(route, n):
  """The first stage reads only the n raw points (the chirp's zero padding
  is neither staged nor read): replaying it with garbage above n gives
  the same line."""
  length = dc_kernel.axis_length(route, n)
  _, plan, roots, chirp, filt, _ = line_tables(route, n)
  x = _line(n, n, 1)[0]
  a = np.zeros(length, np.complex64)
  a[:n] = x if chirp is None else x * np.conj(chirp)
  want = dif_replay(a, plan, roots)
  # butterfly j of stage 0 reads p = j + q·M: only q with p < n are loaded
  length0, r, m = stage_geometry(plan)[0]
  p0, _ = _butterflies(length, length0, m)
  idx = p0[None, :] + m * np.arange(r)[:, None]
  loaded = np.unique(idx[idx < n])
  assert np.array_equal(loaded, np.arange(n))
  b = np.full(length, np.complex64(1e30 + 1e30j))
  b[:n] = a[:n]
  v = _dft(np.where(idx < n, b[np.minimum(idx, length - 1)], 0), False)
  np.testing.assert_array_equal(v, _dft(a[idx], False))
  assert np.isfinite(want).all()


@pytest.mark.parametrize('route,n', [('chirp', CHIRP_CLUSTER_MIN),
                                     ('chirp', 4099), ('chirp', 12289),
                                     ('chirp', CHIRP_CLUSTER_MAX),
                                     ('split', SPLIT_CLUSTER_MIN),
                                     ('split', 4096), ('split', 16384),
                                     ('split', SPLIT_CLUSTER_MAX)])
def test_cluster_exchanges_only_in_the_first_stage(route, n):
  """A cluster of C blocks, block r holding positions r·N/C on and raw
  points r·ceil(n/C) on: the first stage's butterflies, shared out over
  the blocks by j, cover every butterfly once and read and write every
  block's share (the exchange through distributed shared memory); every
  later stage's butterfly lies in one block's share, and each block's
  share and staging fit the block (``tile_bytes``)."""
  kind, c, plan = dc_kernel.axis_plan(route, n)
  length = dc_kernel.axis_length(route, n)
  assert kind == 'cluster' and 2 <= c <= dc_kernel.CLUSTER_MAX
  assert plan[0] % c == 0 and length % c == 0
  chunk = length // c
  assert chunk <= dc_kernel.BLOCK_LINE
  assert dc_kernel.tile_bytes(chunk, -(-n // c)) <= dc_kernel.BLOCK_SMEM
  geometry = stage_geometry(plan)
  length0, r0, m0 = geometry[0]
  share = -(-m0 // c)
  owners = np.minimum(np.arange(m0) // share, c - 1)
  assert np.array_equal(np.bincount(owners, minlength=c)[:c - 1],
                        np.full(c - 1, share))
  reads = (np.arange(m0)[None, :] + m0 * np.arange(r0)[:, None]) // chunk
  assert set(np.unique(reads)) == set(range(c))
  for length_s, r, m in geometry[1:]:
    p0, _ = _butterflies(length, length_s, m)
    blocks = (p0[None, :] + m * np.arange(r)[:, None]) // chunk
    assert (blocks == blocks[0]).all()
  assert len(plan) <= dc_kernel.BLOCK_MAX_STAGES + 1
  assert all(p in dc_kernel.MIXED_RADICES for p in plan)


def test_chirp_length_prefers_one_launch():
  """The chirp's m is the 13-smooth m ≥ 2n − 1 that one launch a pass
  holds whose plan costs least: 512 = 8·8·8 for 244 (not 490 = 2·5·7·7),
  792 for fastMRI's 368, 2112 for 1031, 4160 for 2053 (one block each),
  4802 = 2·7⁴ for 2311 and 8320 for 4099 (a cluster of two, the first
  radix 2); past the largest a cluster holds (18479: m = 36960 on eight),
  device stages."""
  want = {244: (512, 'block', (8, 8, 8)), 368: (792, 'block', (8, 9, 11)),
          1031: (2112, 'block', (3, 8, 8, 11)),
          2053: (4160, 'block', (5, 8, 8, 13)),
          CHIRP_CLUSTER_MIN: (4802, 'cluster', (2, 7, 7, 7, 7)),
          4099: (8320, 'cluster', (2, 5, 8, 8, 13)),
          CHIRP_CLUSTER_MAX: (36960, 'cluster', (8, 4, 7, 11, 15)),
          CHIRP_CLUSTER_MAX + 2: (37044, 'stages', (189, 196))}
  for n, (m, kind, plan) in want.items():
    assert dc_kernel.chirp_length(n) == m
    assert dc_kernel.axis_plan('chirp', n)[0] == kind
    assert dc_kernel.axis_plan('chirp', n)[2] == plan
  assert dc_kernel.axis_plan('chirp', 4099)[1] == 2
  assert dc_kernel.axis_plan('chirp', CHIRP_CLUSTER_MAX)[1] == 8
  for n in range(CHIRP_BLOCK_MAX - 60, CHIRP_CLUSTER_MIN + 60):
    if dc_kernel.axis_route(n) == 'chirp':
      kind = dc_kernel.axis_plan('chirp', n)[0]
      assert kind == ('block' if n <= CHIRP_BLOCK_MAX else 'cluster'), n


def test_route_limits_from_the_budget():
  """BLOCK_LINE from the 226 KiB budget: a column tile of COL_TILE lines of
  4628 points (a padding entry per 16) and the staging of 2314 raw points
  a line take 231,400 bytes, one point more does not fit; a split line,
  staged whole, fits up to 3506 points; the boundaries' sides take the
  kind of launch their names say."""
  assert dc_kernel.tile_bytes(4628, 2314) == 231400 <= dc_kernel.BLOCK_SMEM
  assert dc_kernel.tile_bytes(4629, 2315) > dc_kernel.BLOCK_SMEM
  assert dc_kernel.BLOCK_LINE == 4628
  assert dc_kernel.tile_bytes(3506, 3506) <= dc_kernel.BLOCK_SMEM < \
      dc_kernel.tile_bytes(3507, 3507)
  assert dc_kernel.BLOCK_SMEM == 227 * 1024 - 1024
  for route, n, kind in (('chirp', CHIRP_BLOCK_MAX, 'block'),
                         ('chirp', CHIRP_CLUSTER_MIN, 'cluster'),
                         ('chirp', CHIRP_CLUSTER_MAX, 'cluster'),
                         ('split', SPLIT_BLOCK_MAX, 'block'),
                         ('split', SPLIT_CLUSTER_MIN, 'cluster'),
                         ('split', SPLIT_CLUSTER_MAX, 'cluster'),
                         ('split', 32768, 'stages')):
    assert dc_kernel.axis_route(n) == route
    assert dc_kernel.axis_plan(route, n)[0] == kind, (route, n)


def _constant(src, name):
  return int(re.search(r'constexpr int {} = (\d+);'.format(name),
                       src).group(1))


def test_line_limits_match_the_kernel():
  """``csrc/dc.cu``'s limits are the host's: the block's line and budget,
  the column tile, the cluster size, the stages of a line plan, the device
  stages' radix; and both pad a tile alike (``tile_addr``, ``tile_bytes``)."""
  with open(DC_SRC) as f:
    src = f.read()
  assert _constant(src, 'kBlockLine') == dc_kernel.BLOCK_LINE
  assert _constant(src, 'kBlockSmem') == dc_kernel.BLOCK_SMEM
  assert _constant(src, 'kColTile') == dc_kernel.COL_TILE
  assert _constant(src, 'kClusterMax') == dc_kernel.CLUSTER_MAX
  assert _constant(src, 'kLineStages') == dc_kernel.BLOCK_MAX_STAGES + 1
  assert _constant(src, 'kStageLine') == dc_kernel.STAGE_LINE
  assert _constant(src, 'kTileLine') == dc_kernel.TILE_LINE
  assert 'return u + (u >> 4);' in src
  assert 'return tile_addr(u) + ((rows ? staged | 1 : staged) << lg);' in src
  assert 'line_smem(chunk, 2, staged, false) * 8 > kBlockSmem' in src


def _inputs(h, w, seed):
  rng = np.random.RandomState(seed)
  x, k0, g = (rng.randn(1, h, w, 2).astype(np.float32) for _ in range(3))
  mask = (rng.rand(1, h, w, 1) > 0.6).astype(np.float32)
  return x, k0 * mask, g, mask


def _pass(t, route, inverse):
  """One axis's lines (..., n) complex64 through its route, scaled."""
  n = t.shape[-1]
  if route in ('chirp', 'split') and \
      dc_kernel.axis_plan(route, n)[0] != 'stages':
    y = one_launch_replay(t, route, inverse)
  else:
    from tests.test_torch_port_dc_any_side import line_replay
    return line_replay(t, route, inverse)
  return y * np.float32(1 / np.sqrt(n))


def dc_replay(x, k0, mask):
  """K1 (k0 None: K1-bwd) on the kernel's routes: pass 1 along W, pass 2
  along H with the merge, pass 3."""
  h, w = x.shape[1:3]
  route_h, route_w = dc_kernel.dc_route(h, w)
  t = _pass(x[..., 0] + 1j * x[..., 1], route_w, False)
  k = np.swapaxes(_pass(np.swapaxes(t, 1, 2), route_h, False), 1, 2)
  k = (1 - mask[..., 0]) * k
  if k0 is not None:
    k = k + (k0[..., 0] + 1j * k0[..., 1])
  t = np.swapaxes(_pass(np.swapaxes(k, 1, 2), route_h, True), 1, 2)
  y = _pass(t, route_w, True)
  return np.stack([y.real, y.imag], axis=-1).astype(np.float32)


# (H, W) at each boundary, the boundary's axis along H or W
BOUNDARY_SHAPES = {
    'chirp-block-max': (CHIRP_BLOCK_MAX, 8),
    'chirp-cluster-min': (8, CHIRP_CLUSTER_MIN),
    'chirp-cluster-max': (CHIRP_CLUSTER_MAX, 4),
    'split-block-max': (8, SPLIT_BLOCK_MAX),
    'split-cluster-min': (SPLIT_CLUSTER_MIN, 8),
    'split-cluster-max': (4, SPLIT_CLUSTER_MAX)}


@pytest.mark.parametrize('h,w', list(BOUNDARY_SHAPES.values()),
                         ids=list(BOUNDARY_SHAPES))
def test_dc_at_route_boundaries_matches_jax(h, w):
  """K1 against JAX's ``data_consistency`` (``fft.fft2``, as it runs on
  the CPU) within 2e-4 at each boundary of one block and a cluster."""
  x, k0, _, mask = _inputs(h, w, h + w)
  want = np.asarray(jax.jit(jdc.data_consistency)(
      jnp.asarray(x), jnp.asarray(k0), jnp.asarray(mask)))
  np.testing.assert_allclose(dc_replay(x, k0, mask), want, atol=DC_ATOL)


@pytest.mark.parametrize('h,w', list(BOUNDARY_SHAPES.values()),
                         ids=list(BOUNDARY_SHAPES))
def test_dc_vjp_at_route_boundaries_matches_jax(h, w):
  """K1-bwd (no k0 on the output gradient) and ``grad_k0 = fft2(g)``, as
  ``_DCFunction`` computes them, against ``jax.vjp``."""
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


def test_dc_on_a_cluster_matches_jax_gemm_lowering():
  """The smallest cluster chirp against JAX's DC forced onto the TPU's
  split-real GEMM lowering (``force_gemm``)."""
  h, w = 8, CHIRP_CLUSTER_MIN
  x, k0, _, mask = _inputs(h, w, 5)
  jdc.force_gemm(True)
  try:
    want = np.asarray(jax.jit(jdc.data_consistency)(
        jnp.asarray(x), jnp.asarray(k0), jnp.asarray(mask)))
  finally:
    jdc.force_gemm(False)
  np.testing.assert_allclose(dc_replay(x, k0, mask), want, atol=DC_ATOL)


@pytest.mark.parametrize('h,s', [(4099, 2), (4099, 3), (4099, 8),
                                 (16384, 2), (16384, 8), (12289, 7)],
                         ids=['4099-S2', '4099-S3', '4099-S8', '16384-S2',
                              '16384-S8', '12289-S7'])
def test_rank_column_blocks_take_the_cluster_route(h, s):
  """A spatial rank's column pass at an H on the cluster route takes its
  column block whatever its width (``mesh.col_bounds``: W // S, one more on
  the first W mod S ranks): the cluster's tile walks any block of lines;
  a line's result does not depend on its neighbours, so each rank's
  columns are the whole image's (replayed on two columns either side of
  a block's edge)."""
  for w in (h, 37):
    route = dc_kernel.dc_route(h, w)[0]
    assert route in ('chirp', 'split')
    assert dc_kernel.axis_plan(route, h)[0] == 'cluster'
    # every rank decides by the image's width: a cluster beside h columns,
    # device stages beside 37
    assert dc_kernel.axis_staged(route, h, w, True) == (w == 37)
    bounds = mesh_lib.col_bounds(w, s)
    widths = [hi - lo for lo, hi in map(bounds.block, range(s))]
    assert sum(widths) == w
    for cols in widths + [1, w - 1]:
      dc_kernel.check_cols_block('pass', cols, w, route, h)
  lines = _line(h, h, 4)
  whole = one_launch_replay(lines, route)
  for lo, hi in ((0, 2), (2, 4), (1, 3)):
    np.testing.assert_array_equal(
        one_launch_replay(lines[lo:hi], route), whole[lo:hi])


def test_plan_codes_of_one_launch():
  """The host array of an axis in one launch a pass, as ``csrc/dc.cu``'s
  ``line_plan`` checks it: [1, C, S, R_0, ..., R_(S−1)]; the chirp's
  tables hold the chirp, the filter at the positions and the roots, the
  split's the roots and the positions as int32."""
  for route, n in (('chirp', 1031), ('chirp', 4099), ('split', 2048),
                   ('split', 16384)):
    kind, c, plan = dc_kernel.axis_plan(route, n)
    code, length, arr = dc_kernel._plan_args(route, n)
    assert code == dc_kernel._ROUTE_CODES[route]
    assert length == dc_kernel.axis_length(route, n)
    vals = list(np.ctypeslib.as_array(
        (dc_kernel.ctypes.c_uint64 * (3 + len(plan))).from_address(
            arr.value)))
    assert vals == [1, c, len(plan)] + list(plan)
    pos = dc_kernel.line_positions(plan)
    assert np.array_equal(np.sort(pos), np.arange(length))
    assert math.prod(plan) == length


def test_block_plans_take_the_smallest_radix_first():
  """A block's plan has ``mixed_plan``'s radices in ascending order, so
  the first stage (from the staging) and the inverse's last (to device
  memory) hold the fewest points; a cluster's first radix is a multiple of
  C and the rest a block's plan."""
  for n in (192, 512, 735, 1024, 1280, 2048, 2112, 4160, 4620):
    plan = dc_kernel.block_plan(n)
    assert plan == tuple(sorted(dc_kernel.mixed_plan(n, 5)))
  for route, n in (('chirp', 2311), ('chirp', 4099), ('split', 3510),
                   ('split', 16384)):
    kind, c, plan = dc_kernel.axis_plan(route, n)
    assert kind == 'cluster' and plan[0] % c == 0
    assert plan[1:] == dc_kernel.block_plan(math.prod(plan[1:]))


def test_plan_cost_weighs_each_radix():
  """``plan_cost``: the length times the sum of the radices'
  ``RADIX_COST`` (every radix of the set has one), plus on a cluster the
  first radix's ``cluster_first_cost`` (none for 2, half a stage to 7, a
  stage above)."""
  assert set(dc_kernel.RADIX_COST) == set(dc_kernel.MIXED_RADICES)
  assert dc_kernel.plan_cost(512, (8, 8, 8)) == pytest.approx(512 * 3.0)
  assert dc_kernel.plan_cost(490, (2, 5, 7, 7)) > \
      dc_kernel.plan_cost(512, (8, 8, 8))
  assert [dc_kernel.cluster_first_cost(r) for r in (2, 4, 7, 8, 16)] == \
      [0.0, 0.5, 0.5, 1.0, 1.0]
  assert dc_kernel.plan_cost(4802, (2, 7, 7, 7, 7), 2) == \
      pytest.approx(dc_kernel.plan_cost(4802, (2, 7, 7, 7, 7)))
  assert dc_kernel.plan_cost(4928, (8, 7, 8, 11), 2) == pytest.approx(
      dc_kernel.plan_cost(4928, (8, 7, 8, 11)) + 4928)


@pytest.mark.parametrize('route,n', [('chirp', CHIRP_CLUSTER_MIN),
                                     ('chirp', 4099), ('split', 3510),
                                     ('split', 16384)])
def test_few_lines_take_the_device_stages(route, n):
  """An axis a cluster holds runs on device stages where the image has
  fewer lines of it than ``cluster_lines`` (512·C on the split route, 32·C
  rows or 128·C columns on the chirp route): the same length on
  ``split_radices``, with their host array, work buffer and tables, whose
  replay matches ``torch.fft`` within 1e-5 forward and inverse; an axis in
  one block, or on another route, never does."""
  from tests.test_torch_port_dc_any_side import chirp_replay, split_replay
  kind, c, _ = dc_kernel.axis_plan(route, n)
  assert kind == 'cluster'
  for cols in (False, True):
    need = dc_kernel.cluster_lines(route, c, cols)
    assert need == (512 if route == 'split' else 128 if cols else 32) * c
    assert dc_kernel.axis_staged(route, n, need - 1, cols)
    assert not dc_kernel.axis_staged(route, n, need, cols)
  length = dc_kernel.axis_length(route, n)
  radices = dc_kernel.split_radices(length)
  assert dc_kernel.axis_plan(route, n, True) == ('stages', None, radices)
  assert dc_kernel.work_elems(route, n, 3, True) == 2 * 3 * length
  assert dc_kernel.work_elems(route, n, 3) == 0
  _, got_len, arr = dc_kernel._plan_args(route, n, True)
  want = [len(radices)] + [v for r in radices for v in (
      r, dc_kernel._code(dc_kernel.mixed_plan(r)))]
  codes = np.ctypeslib.as_array((dc_kernel.ctypes.c_uint64 * len(want))
                                .from_address(arr.value))
  assert got_len == length and list(codes) == want
  replay = chirp_replay if route == 'chirp' else split_replay
  x = _line(n, 9)
  for inverse in (False, True):
    got = replay(x, inverse, staged=True) * np.float32(1 / np.sqrt(n))
    want_x = (torch.fft.ifft if inverse else torch.fft.fft)(
        torch.from_numpy(x.astype(np.complex128)), norm='ortho').numpy()
    np.testing.assert_allclose(got, want_x, atol=LINE_ATOL, rtol=0)
  assert not dc_kernel.axis_staged('chirp', 2053, 1, True)
  assert not dc_kernel.axis_staged('split', 2048, 1, False)
  assert not dc_kernel.axis_staged('mixed', 240, 1, True)
