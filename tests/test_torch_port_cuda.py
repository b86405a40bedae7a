"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided in the
``cuda`` fixture, never at import). Run on a machine with an NVIDIA
Hopper GPU and nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports jax, which such a machine
may not have; this file needs only torch.)
"""

import os

import pytest
import torch

from csmri_refinement_tpu_torch import build_flagship
from csmri_refinement_tpu_torch.models.recnet import RecNet
from csmri_refinement_tpu_torch.ops import conv_chain as cc
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.ops import masks
from csmri_refinement_tpu_torch.ops import quantize
from csmri_refinement_tpu_torch.probes import int8_prims
from csmri_refinement_tpu_torch.probes import mosaic_prims

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


@pytest.mark.parametrize('with_k0', [True, False], ids=['k0', 'no_k0'])
@pytest.mark.parametrize('n', [2, 4, 8, 16, 32, 64, 128, 256, 512])
def test_dc_kernel_matches_plain(cuda, n, with_k0):
  """Every side the plan covers, with k0 and in the no-k0 mode (K1-bwd);
  B = 3 walks a partial last row tile at the small sides."""
  b = 3 if n <= 64 else 2
  gen = torch.Generator(device=cuda).manual_seed(n)
  x = torch.randn(b, n, n, 2, device=cuda, generator=gen)
  k0 = torch.randn(b, n, n, 2, device=cuda, generator=gen)
  m = (torch.rand(b, n, n, 1, device=cuda, generator=gen) > 0.5).float()
  if with_k0:
    got = dc_kernel.dc_cuda(x, k0, m)
    torch.cuda.synchronize()
    want = dc_kernel.dc_plain(x, k0, m)
  else:
    got = dc_kernel.dc_bwd_cuda(x, m)
    torch.cuda.synchronize()
    want = dc_kernel.dc_plain_vjp(x, m, need_k0=False)[0]
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


def _conv_case(cuda, k, cin, cout, pad, dtype, shape):
  gen = torch.Generator(device=cuda).manual_seed(k * cin + cout)
  x = torch.randn(*shape, cin, device=cuda, generator=gen).to(dtype)
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
  assert got.dtype == dtype and got.shape == want.shape and err <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('pad', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('k,cin,cout', [(3, 2, 32), (4, 48, 16),
                                        (4, 32, 64), (3, 128, 128)])
def test_conv_layer_kernel_matches_plain(cuda, k, cin, cout, pad, dtype):
  """Odd image sizes exercise the tile overhang at every border."""
  _conv_case(cuda, k, cin, cout, pad, dtype, (2, 19, 37))


@pytest.mark.parametrize('pad', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('k', [3, 4])
@pytest.mark.parametrize('cout', [16, 32, 64, 128])
@pytest.mark.parametrize('cin', [2, 16, 32, 64, 128])
def test_conv_layer_wgmma_grid(cuda, cin, cout, k, pad):
  """The bf16 wgmma route over Cin x Cout x k x pad, on images that are
  not tile multiples (40 x 72, B = 3; 9 x 9, B = 1)."""
  _conv_case(cuda, k, cin, cout, pad, torch.bfloat16, (3, 40, 72))
  _conv_case(cuda, k, cin, cout, pad, torch.bfloat16, (1, 9, 9))


@pytest.mark.parametrize('k', [3, 4])
@pytest.mark.parametrize('cin', [3, 18, 48, 66])
def test_conv_layer_staging_routes(cuda, cin, k):
  """Cin that is not a whole number of chunks: gathered (odd), 4-byte
  copies in one chunk (18) and in three (66), zero-filled 16-byte groups
  (48)."""
  _conv_case(cuda, k, cin, 32, 'zero', torch.bfloat16, (2, 21, 70))
  _conv_case(cuda, k, cin, 32, 'reflection', torch.bfloat16, (2, 21, 70))


# Sides with no power-of-two plan: the mixed-radix route (prime factors
# at most 13) on at least one axis, the dense route (a larger prime
# factor) on at least one axis.
MIXED_SHAPES = {'3': (3, 3), '100': (100, 100), '192': (192, 192),
                '240': (240, 240), '320': (320, 320), '384': (384, 384),
                '160': (160, 160), '120': (120, 120), '360': (360, 360),
                '480': (480, 480), '256x192': (256, 192),
                '192x256': (192, 256), '512x320': (512, 320), '5x7': (5, 7),
                '16x15': (16, 15), '128x24': (128, 24), '2x512': (2, 512)}
DFT_SHAPES = {'17': (17, 17), '31': (31, 31), '61': (61, 61),
              '79': (79, 79), '64x61': (64, 61), '61x48': (61, 48)}
# Sides with a prime factor above 13 past DENSE_MAX on Bluestein's chirp,
# in one block a pass (m up to 4628)
CHIRP_SHAPES = {'89': (89, 89), '127': (127, 127), '244': (244, 244),
                '509': (509, 509), '240x237': (240, 237),
                '368x64': (368, 64)}


def _dc_case(cuda, shape, with_k0):
  """K1 against dc_plain, K1-bwd against dc_plain_vjp, on (b, h, w)."""
  h, w = shape
  b = 3 if h * w <= 192 * 192 else 2
  gen = torch.Generator(device=cuda).manual_seed(h if h == w else h + w)
  x = torch.randn(b, h, w, 2, device=cuda, generator=gen)
  k0 = torch.randn(b, h, w, 2, device=cuda, generator=gen)
  m = (torch.rand(b, h, w, 1, device=cuda, generator=gen) > 0.5).float()
  if with_k0:
    got = dc_kernel.dc_cuda(x, k0, m)
    torch.cuda.synchronize()
    want = dc_kernel.dc_plain(x, k0, m)
  else:
    got = dc_kernel.dc_bwd_cuda(x, m)
    torch.cuda.synchronize()
    want = dc_kernel.dc_plain_vjp(x, m, need_k0=False)[0]
  assert (got - want).abs().max().item() <= 2e-4


@pytest.mark.parametrize('with_k0', [True, False], ids=['k0', 'no_k0'])
@pytest.mark.parametrize('shape', list(MIXED_SHAPES.values()),
                         ids=list(MIXED_SHAPES))
def test_dc_kernel_mixed_radix_sides(cuda, shape, with_k0):
  """Sides with no power-of-two plan whose prime factors are at most 13
  run the mixed-radix route on their axis, non-square images one route
  per axis: K1 against dc_plain, K1-bwd against dc_plain_vjp."""
  assert 'mixed' in dc_kernel.dc_route(*shape) or shape == (2, 512)
  _dc_case(cuda, shape, with_k0)


@pytest.mark.parametrize('with_k0', [True, False], ids=['k0', 'no_k0'])
@pytest.mark.parametrize('shape', list(DFT_SHAPES.values()),
                         ids=list(DFT_SHAPES))
def test_dc_kernel_dense_dft_sides(cuda, shape, with_k0):
  """Axes with a prime factor above 13 up to ``DENSE_MAX`` run the
  kernel's dense DFT lines, a root table per axis (64×61: H on the radix
  route's mixed-radix twin, W dense): K1 against dc_plain, K1-bwd against
  dc_plain_vjp."""
  assert 'dft' in dc_kernel.dc_route(*shape)
  _dc_case(cuda, shape, with_k0)


@pytest.mark.parametrize('with_k0', [True, False], ids=['k0', 'no_k0'])
@pytest.mark.parametrize('shape', list(CHIRP_SHAPES.values()),
                         ids=list(CHIRP_SHAPES))
def test_dc_kernel_chirp_sides(cuda, shape, with_k0):
  """Axes with a prime factor above 13 past ``DENSE_MAX`` run Bluestein's
  chirp in one block a pass (240×237: H mixed-radix, W chirp): K1 against
  dc_plain, K1-bwd against dc_plain_vjp."""
  assert 'chirp' in dc_kernel.dc_route(*shape)
  _dc_case(cuda, shape, with_k0)


def _dc_on_blocks(x, k0, m, s, bwd):
  """K1's (``bwd``: K1-bwd's) three passes on ``s`` row blocks and ``s``
  column blocks (``mesh.col_bounds``: one row or column more on the first
  H or W mod s) in one process, the all-to-alls done by slicing: the
  arithmetic of a DC distributed over ``s`` ranks."""
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  b, h, w, _ = x.shape
  rows, cols = mesh_lib.col_bounds(h, s), mesh_lib.col_bounds(w, s)
  rows_fft = dc_kernel.dc_bwd_rows_fft_cuda if bwd else \
      dc_kernel.dc_rows_fft_cuda
  rows_ifft = dc_kernel.dc_bwd_rows_ifft_cuda if bwd else \
      dc_kernel.dc_rows_ifft_cuda
  row = lambda t, i: t[:, slice(*rows.block(i))].contiguous()
  col = lambda t, j: t[:, :, slice(*cols.block(j))].contiguous()
  t = torch.cat([rows_fft(row(x, i), h) for i in range(s)], 1)
  t = torch.cat([dc_kernel.dc_bwd_cols_cuda(col(t, j), col(m, j), w) if bwd
                 else dc_kernel.dc_cols_cuda(col(t, j), col(k0, j),
                                             col(m, j), w)
                 for j in range(s)], 2)
  return torch.cat([rows_ifft(row(t, i), h) for i in range(s)], 1)


@pytest.mark.parametrize('bwd', [False, True], ids=['K1', 'K1-bwd'])
@pytest.mark.parametrize('s', [2, 4])
@pytest.mark.parametrize('shape', [(16, 16), (64, 64), (256, 256),
                                   (512, 512), (320, 320), (256, 192),
                                   (24, 20), (240, 237), (16, 15),
                                   (256, 128)],
                         ids=['16', '64', '256', '512', '320', '256x192',
                              '24x20', '240x237', '16x15', '256x128'])
def test_dc_passes_on_blocks_equal_the_whole_dc(cuda, shape, s, bwd):
  """The passes on a rank's rows and columns give the whole-image K1's
  (K1-bwd's) output bit for bit, on both routes, and on the dense route
  on column blocks that differ by one where S does not divide W; each
  pass is within 2e-4 of its plain version."""
  h, w = shape
  gen = torch.Generator(device=cuda).manual_seed(h + w + s)
  x, k0 = (torch.randn(2, h, w, 2, device=cuda, generator=gen)
           for _ in range(2))
  m = (torch.rand(2, h, w, 1, device=cuda, generator=gen) > 0.5).float()
  got = _dc_on_blocks(x, k0, m, s, bwd)
  want = dc_kernel.dc_bwd_cuda(x, m) if bwd else dc_kernel.dc_cuda(x, k0, m)
  torch.cuda.synchronize()
  assert torch.equal(got, want)
  t = dc_kernel.dc_rows_fft_cuda(x, h)
  rel = lambda a, b: ((a - b).abs().max() / b.abs().max().clamp_min(1.0))
  assert rel(t, dc_kernel.dc_rows_fft_plain(x)).item() <= 2e-4
  c = dc_kernel.dc_bwd_cols_cuda(t, m, w) if bwd else \
      dc_kernel.dc_cols_cuda(t, k0, m, w)
  assert rel(c, dc_kernel.dc_cols_plain(t, None if bwd else k0,
                                        m)).item() <= 2e-4
  y = dc_kernel.dc_rows_ifft_cuda(c, h)
  assert rel(y, dc_kernel.dc_rows_ifft_plain(c)).item() <= 2e-4


@pytest.mark.parametrize('bwd', [False, True], ids=['K1', 'K1-bwd'])
@pytest.mark.parametrize('shape,s', [((240, 240), 2), ((240, 240), 3),
                                     ((320, 320), 3), ((256, 240), 2),
                                     ((512, 240), 2), ((256, 192), 8)],
                         ids=['240-S2', '240-S3', '320-S3', '256x240-S2',
                              '512x240-S2', '256x192-S8'])
def test_dc_passes_on_uneven_blocks_equal_the_whole_dc(cuda, shape, s, bwd):
  """The mixed-radix route's passes on a rank's column blocks (120 of 240
  on two ranks, 80 on three; 107, 107 and 106 of 320 on three, rows split
  alike; 24 of 192 on eight, a power-of-two H beside a width of no
  power-of-two plan) give the whole-image K1's (K1-bwd's) output bit for
  bit."""
  h, w = shape
  assert dc_kernel.dc_route(h, w) == ('mixed', 'mixed')
  gen = torch.Generator(device=cuda).manual_seed(h + w + s)
  x, k0 = (torch.randn(2, h, w, 2, device=cuda, generator=gen)
           for _ in range(2))
  m = (torch.rand(2, h, w, 1, device=cuda, generator=gen) > 0.5).float()
  got = _dc_on_blocks(x, k0, m, s, bwd)
  want = dc_kernel.dc_bwd_cuda(x, m) if bwd else dc_kernel.dc_cuda(x, k0, m)
  torch.cuda.synchronize()
  assert torch.equal(got, want)


def test_dc_passes_raise_on_blocks_they_cannot_take(cuda):
  """The radix column pass refuses a block that is not whole strips; a
  row pass of any width runs (1025: the chirp route) and raises only at an
  index range the kernels count in int32."""
  t = torch.zeros(1, 64, 24, 2, device=cuda)
  m = torch.zeros(1, 64, 24, 1, device=cuda)
  with pytest.raises(ValueError, match='a block of 24 of the image'):
    dc_kernel.dc_cols_cuda(t, t, m, 64)
  x = torch.randn(1, 4, 1025, 2, device=cuda)
  y = dc_kernel.dc_rows_fft_cuda(x, 8)
  torch.cuda.synchronize()
  assert (y - dc_kernel.dc_rows_fft_plain(x)).abs().max().item() <= 2e-4
  with pytest.raises(ValueError, match='int32 index range'):
    dc_kernel.dc_rows_fft_cuda(torch.zeros(65536, 1, 2, 2, device=cuda), 2)


@pytest.mark.parametrize('shape', [(1, 64), (64, 1)], ids=['1x64', '64x1'])
def test_dc_fused_raises_outside_the_kernel_sides(cuda, shape):
  """A CUDA image with a side of 1 has no kernel route: the DC raises and
  nothing falls back to the plain version."""
  h, w = shape
  x = torch.zeros(1, h, w, 2, device=cuda)
  m = torch.zeros(1, h, w, 1, device=cuda)
  before = dc_kernel.dc_cuda.launches
  with pytest.raises(ValueError, match='sides from 2'):
    dc_kernel.dc_fused(x, x, m)
  assert dc_kernel.dc_cuda.launches == before


@pytest.mark.parametrize('shape', [(1025, 1025), (256, 1025), (2053, 64),
                                   (4099, 16), (16, 16384), (256, 4099),
                                   (4096, 16384)],
                         ids=['1025', '256x1025', '2053x64', '4099x16',
                              '16x16384', '256x4099', '4096x16384'])
def test_dc_fused_runs_sides_above_1024(cuda, shape):
  """The sides that raised while the kernel stopped at 1024 run, in one
  block (1025, 2053: m = 4160), on a cluster (4099 beside 256 rows: m =
  8320; 16384 beside 4096) and on device stages (4099 beside 16 columns,
  16384 beside 16 rows: too few lines for a cluster): the DC launches K1
  once, within 2e-4 of the plain version."""
  h, w = shape
  gen = torch.Generator(device=cuda).manual_seed(h + w)
  x, k0 = (torch.randn(1, h, w, 2, device=cuda, generator=gen)
           for _ in range(2))
  m = (torch.rand(1, h, w, 1, device=cuda, generator=gen) > 0.5).float()
  before = dc_kernel.dc_cuda.launches
  y = dc_kernel.dc_fused(x, k0, m)
  torch.cuda.synchronize()
  assert dc_kernel.dc_cuda.launches == before + 1
  assert (y - dc_kernel.dc_plain(x, k0, m)).abs().max().item() <= 2e-4


@pytest.mark.parametrize('shape', [(320, 320), (384, 384), (256, 192)],
                         ids=['320', '384', '256x192'])
def test_data_consistency_other_shapes_on_card(cuda, shape):
  """RecNet's DC at sides the JAX package runs, through the kernels
  (forward and backward, one launch each), against the plain versions, the
  gradients at 2e-3 (tests/test_dc_pallas.py:46)."""
  _data_consistency_case(cuda, shape)


def _data_consistency_case(cuda, shape):
  from csmri_refinement_tpu_torch.ops.dc import data_consistency
  h, w = shape
  gen = torch.Generator(device=cuda).manual_seed(h + w)
  x = torch.randn(2, h, w, 2, device=cuda, generator=gen, requires_grad=True)
  k0 = torch.randn(2, h, w, 2, device=cuda, generator=gen)
  g = torch.randn(2, h, w, 2, device=cuda, generator=gen)
  m = masks.cartesian_mask(gen, (2, h, w), 8, device=cuda)[..., None]
  m = m.contiguous()
  before = (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches)
  y = data_consistency(x, k0, m)
  y.backward(g)
  torch.cuda.synchronize()
  assert (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches) == \
      (before[0] + 1, before[1] + 1)
  assert (y - dc_kernel.dc_plain(x, k0, m)).abs().max().item() <= 2e-4
  want_x, _ = dc_kernel.dc_plain_vjp(g, m, need_k0=False)
  assert (x.grad - want_x).abs().max().item() <= 2e-3


LARGE_SHAPES = {'640': (640, 640), '768': (768, 768), '1024': (1024, 1024),
                '640x368': (640, 368), '1021': (1021, 1021)}
# Every route past 1024 and the chirp's sides, (B, H, W): the chirp in one
# block (244, 509, 368, 1021, 1031, 2053: m = 4160, and the largest, 2309:
# m = 4620), on a cluster (the smallest, 2311: m = 4802 on 2 blocks; 4099:
# 8320 on 2; 12289: 25088 on 7; the largest, 18479: 36960 on 8, each
# beside enough lines: dc_kernel.cluster_lines) and on device stages past
# it (18481) or beside too few lines (16 × 2311, 12289 × 8, 18479 × 4);
# the split route in one block (2048, 1280, the largest, 3500), on a
# cluster (the smallest, 3510; 4096 on 2; 16384 and the largest, 28000,
# on 8) and on device stages (32768, and 16384, 3510 and 28000 beside too
# few lines)
ANY_SHAPES = {'244': (2, 244, 244), '509': (2, 509, 509),
              '640x368': (2, 640, 368), '1021': (2, 1021, 1021),
              '1031': (1, 1031, 1031), '2048': (1, 2048, 2048),
              '1280': (1, 1280, 1280), '4096': (1, 4096, 4096),
              '16384x16': (1, 16384, 16), '16x16384': (1, 16, 16384),
              '12289x8': (1, 12289, 8), '2053x64': (1, 2053, 64),
              '2309x16': (1, 2309, 16), '16x2311': (1, 16, 2311),
              '4099': (1, 4099, 4099), '18479x4': (1, 18479, 4),
              '4x18481': (1, 4, 18481), '3500x8': (1, 3500, 8),
              '8x3510': (1, 8, 3510), '28000x4': (1, 28000, 4),
              '8x32768': (1, 8, 32768), '64x2311': (1, 64, 2311),
              '2311x256': (1, 2311, 256), '224x12289': (1, 224, 12289),
              '256x18479': (1, 256, 18479), '2048x3510': (1, 2048, 3510),
              '3510x2048': (1, 3510, 2048), '4096x16384': (1, 4096, 16384),
              '4096x28000': (1, 4096, 28000)}


@pytest.mark.parametrize('with_k0', [True, False], ids=['k0', 'no_k0'])
@pytest.mark.parametrize('shape', list(LARGE_SHAPES.values()),
                         ids=list(LARGE_SHAPES))
def test_dc_kernel_large_sides(cuda, shape, with_k0):
  """Sides above 512 on every route (1024 radix, 640 and 768 mixed-radix,
  1021 dense, 640×368 mixed-radix H and dense W): K1 against dc_plain,
  K1-bwd against dc_plain_vjp within 2e-4, one launch each."""
  assert dc_kernel.dc_route(*shape) is not None
  name = 'dc_cuda' if with_k0 else 'dc_bwd_cuda'
  before = getattr(dc_kernel, name).launches
  _dc_case(cuda, shape, with_k0)
  assert getattr(dc_kernel, name).launches == before + 1


@pytest.mark.parametrize('with_k0', [True, False], ids=['k0', 'no_k0'])
@pytest.mark.parametrize('shape', list(ANY_SHAPES.values()),
                         ids=list(ANY_SHAPES))
def test_dc_kernel_any_side(cuda, shape, with_k0):
  """K1 against dc_plain and K1-bwd against dc_plain_vjp within 2e-4 on
  the chirp and split routes, in one block, on a cluster and on device
  stages, at each boundary between them, one counted launch each."""
  b, h, w = shape
  gen = torch.Generator(device=cuda).manual_seed(h + w)
  x = torch.randn(b, h, w, 2, device=cuda, generator=gen)
  k0 = torch.randn(b, h, w, 2, device=cuda, generator=gen)
  m = (torch.rand(b, h, w, 1, device=cuda, generator=gen) > 0.5).float()
  name = 'dc_cuda' if with_k0 else 'dc_bwd_cuda'
  before = getattr(dc_kernel, name).launches
  if with_k0:
    got = dc_kernel.dc_cuda(x, k0, m)
    torch.cuda.synchronize()
    want = dc_kernel.dc_plain(x, k0, m)
  else:
    got = dc_kernel.dc_bwd_cuda(x, m)
    torch.cuda.synchronize()
    want = dc_kernel.dc_plain_vjp(x, m, need_k0=False)[0]
  assert getattr(dc_kernel, name).launches == before + 1
  assert (got - want).abs().max().item() <= 2e-4


@pytest.mark.parametrize('shape', [(18481, 4), (509, 32), (8, 32768),
                                   (16, 2048), (4099, 256), (2048, 3510),
                                   (4099, 16), (16, 16384)],
                         ids=['chirp-stages', 'chirp-block', 'split-stages',
                              'split-block', 'chirp-cluster',
                              'split-cluster', 'chirp-few-lines',
                              'split-few-lines'])
def test_dc_routes_never_reach_torch_fft(cuda, shape, monkeypatch):
  """With ``torch.fft`` patched to raise, K1 and K1-bwd on the chirp and
  split routes (in one block, on a cluster and on device stages) launch
  and count: no route falls back to cuFFT."""
  h, w = shape
  assert set(dc_kernel.dc_route(h, w)) & {'chirp', 'split'}
  gen = torch.Generator(device=cuda).manual_seed(h * w)
  x, k0 = (torch.randn(2, h, w, 2, device=cuda, generator=gen)
           for _ in range(2))
  m = (torch.rand(2, h, w, 1, device=cuda, generator=gen) > 0.5).float()
  want = dc_kernel.dc_plain(x, k0, m)

  def refuse(*args, **kwargs):
    raise AssertionError('torch.fft reached')
  for name in ('fft', 'ifft', 'fft2', 'ifft2', 'fftn', 'ifftn'):
    monkeypatch.setattr(torch.fft, name, refuse)
  before = (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches)
  y = dc_kernel.dc_cuda(x, k0, m)
  dc_kernel.dc_bwd_cuda(x, m)
  torch.cuda.synchronize()
  assert (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches) == \
      (before[0] + 1, before[1] + 1)
  monkeypatch.undo()
  assert (y - want).abs().max().item() <= 2e-4


@pytest.mark.parametrize('bwd', [False, True], ids=['K1', 'K1-bwd'])
@pytest.mark.parametrize('shape,s', [((640, 640), 2), ((640, 640), 3),
                                     ((1024, 1024), 2), ((1024, 1024), 4),
                                     ((1024, 640), 3), ((640, 368), 3),
                                     ((2048, 2048), 2), ((1031, 1031), 3),
                                     ((2053, 96), 3), ((96, 8192), 2),
                                     ((4099, 48), 3), ((48, 4099), 2),
                                     ((16384, 16), 4), ((18481, 8), 2),
                                     ((8, 32768), 2), ((4099, 256), 3),
                                     ((64, 4099), 2), ((3510, 2048), 4),
                                     ((2048, 8192), 2)],
                         ids=['640-S2', '640-S3', '1024-S2', '1024-S4',
                              '1024x640-S3', '640x368-S3', '2048-S2',
                              '1031-S3', '2053x96-S3', '96x8192-S2',
                              '4099x48-S3', '48x4099-S2', '16384x16-S4',
                              '18481x8-S2', '8x32768-S2', '4099x256-S3',
                              '64x4099-S2', '3510x2048-S4', '2048x8192-S2'])
def test_dc_passes_on_large_blocks_equal_the_whole_dc(cuda, shape, s, bwd):
  """The passes on a rank's rows and columns above 512 (the radix route's
  8-column strips at 1024 rows, the mixed-radix route's 4-column strips,
  uneven blocks at S = 3, the chirp route in one block at 368, 1031 and
  2053, on a cluster at 4099 beside 256 columns or 64 rows, on device
  stages at 18481 and at 4099 beside 48 lines, the split route in one
  block at 2048, on a cluster at 8192 beside 2048 rows and at 3510 beside
  2048 columns, on device stages at 32768 and at 16384 and 8192 beside 16
  and 96 lines) give the
  whole-image K1's (K1-bwd's) output bit for bit."""
  h, w = shape
  gen = torch.Generator(device=cuda).manual_seed(h + w + s)
  x, k0 = (torch.randn(1, h, w, 2, device=cuda, generator=gen)
           for _ in range(2))
  m = (torch.rand(1, h, w, 1, device=cuda, generator=gen) > 0.5).float()
  got = _dc_on_blocks(x, k0, m, s, bwd)
  want = dc_kernel.dc_bwd_cuda(x, m) if bwd else dc_kernel.dc_cuda(x, k0, m)
  torch.cuda.synchronize()
  assert torch.equal(got, want)


@pytest.mark.parametrize('size', [640, 1024, 2048])
def test_build_flagship_above_512_on_card(cuda, size):
  """``build_flagship`` takes sides above 512 on the card: a bf16 forward
  at B = 2 (B = 1 at 2048, the split route in one block) through 3 K1 and
  10 K2 launches, finite, its K1 launches against the plain DC."""
  b = 1 if size > 1024 else 2
  model, undersample_batch = build_flagship(size, torch.bfloat16, 'cuda', 0)
  gen = torch.Generator(device=cuda).manual_seed(size)
  gt = torch.rand(b, size, size, device=cuda, generator=gen)
  batch = undersample_batch(gen, gt, 'varden', 8)
  calls = []
  kernel = dc_kernel.dc_cuda

  def recorded(x, k0, mask):   # the wrapper counts through this name
    y = kernel(x, k0, mask)
    calls.append((x, k0, mask, y))
    return y
  recorded.launches = 0
  conv_before = cc.conv_layer_cuda.launches
  dc_kernel.dc_cuda = recorded
  try:
    with torch.inference_mode():
      out = model(batch['inp'], batch['kspace'], batch['mask'])
    torch.cuda.synchronize()
  finally:
    dc_kernel.dc_cuda = kernel
    kernel.launches += recorded.launches
  assert (recorded.launches, len(calls),
          cc.conv_layer_cuda.launches - conv_before) == (3, 3, 10)
  assert out['pred'].shape == (b, size, size, 2)
  assert bool(torch.isfinite(out['pred'].float()).all())
  for x, k0, mask, y in calls:
    assert (y - dc_kernel.dc_plain(x, k0, mask)).abs().max().item() <= 2e-4


def test_recnet_train_step_at_1031_on_card(cuda):
  """A RecNet train step of configs/synthetic-recnet.json's model and Adam
  on 1031² slices, B = 2: the DC runs K1 forward and K1-bwd backward
  through ``_DCFunction`` on the chirp route in one block (m = 2112; 3
  launches each), the loss is finite and the parameters move."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  assert dc_kernel.dc_route(1031, 1031) == ('chirp', 'chirp')
  conf = Configuration.from_json(os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      'configs', 'synthetic-recnet.json'))
  runner = Runner(conf, 'train', cuda)
  gen = torch.Generator().manual_seed(1031)
  gt = torch.rand(2, 1031, 1031, generator=gen)
  mask = masks.cartesian_mask(gen, (2, 1031, 1031), 8)
  before = {k: v.clone() for k, v in runner.model.state_dict().items()}
  counts = (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches)
  loss = runner.train_batch(us.undersample_batch(
      None, gt.to(cuda), fixed_mask=mask.to(cuda)))[0]['loss']
  torch.cuda.synchronize()
  assert (dc_kernel.dc_cuda.launches - counts[0],
          dc_kernel.dc_bwd_cuda.launches - counts[1]) == (3, 3)
  assert torch.isfinite(loss).item()
  assert any(not torch.equal(v, before[k])
             for k, v in runner.model.state_dict().items())


@pytest.mark.parametrize('shape', [(640, 368), (768, 768)],
                         ids=['640x368', '768'])
def test_data_consistency_large_shapes_on_card(cuda, shape):
  """RecNet's DC at fastMRI's 640×368 knee k-space and 768², forward and
  backward through the kernels (one launch each), against the plain
  versions (2e-4, and 2e-3 for the gradient)."""
  _data_consistency_case(cuda, shape)


UNET_WIDTHS = {   # tests/test_torch_port_models.py UNET_CASES, and 4 filters
    'flagship_layout_8': dict(encode_filters=[8, 16, 32],
                              decode_filters=[16, 8], kernel_size=4,
                              padding='reflection',
                              upsampling_mode='nn-resize-conv',
                              decoder_act_upsampling_only=True),
    'nn_merge_bn_zero_k3_8': dict(encode_filters=[8, 16, 32],
                                  decode_filters=[16, 8], kernel_size=3,
                                  padding='zero', upsampling_mode='nn'),
    'replicate_extra_decoder_8': dict(encode_filters=[8, 16, 32],
                                      decode_filters=[16, 8, 8],
                                      kernel_size=4, padding='replication',
                                      upsampling_mode='nn-resize-conv',
                                      decoder_act_upsampling_only=True),
    'four_filters': dict(encode_filters=[4, 8], decode_filters=[4],
                         kernel_size=4, padding='reflection',
                         upsampling_mode='nn-resize-conv',
                         decoder_act_upsampling_only=True),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(UNET_WIDTHS))
def test_unet_of_any_width_on_card(cuda, case, dtype):
  """U-Nets whose widths are not multiples of 16 (Cout 4 and 8 in their
  eval chains) run every chain layer through K2 on the card and agree with
  the CPU: f32 within the U-Net bar 5e-4, bf16 within 2e-2 of max |ref|."""
  from csmri_refinement_tpu_torch.models.unet import UNET
  kw = dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
            output_activation='none', **UNET_WIDTHS[case])
  model = UNET(**kw)
  model.init_weights(torch.Generator().manual_seed(0))
  model.eval()
  x = torch.randn(2, 32, 32, 2, generator=torch.Generator().manual_seed(1))
  with torch.no_grad():
    want = model(x.to(dtype)).float()
    before = cc.conv_layer_cuda.launches
    got = model.to(cuda)(x.to(cuda, dtype)).float().cpu()
  torch.cuda.synchronize()
  chains = len(kw['encode_filters']) + len(kw['decode_filters'])
  assert cc.conv_layer_cuda.launches - before == 2 * chains
  tol = 5e-4 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
  assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('cout', [1, 2, 4, 8, 24, 40])
def test_conv_layer_any_cout(cuda, cout, dtype):
  _conv_case(cuda, 4, 32, cout, 'reflection', dtype, (2, 19, 70))
  _conv_case(cuda, 3, 2, cout, 'zero', dtype, (1, 9, 9))


def test_kernel_wrappers_raise_on_unsupported_inputs(cuda):
  x = torch.zeros(1, 16, 16, 2, device=cuda)
  m = torch.zeros(1, 16, 16, 1, device=cuda)
  with pytest.raises(ValueError):
    dc_kernel.dc_cuda(x[:, :, :1].contiguous(), x[:, :, :1].contiguous(),
                      m[:, :, :1].contiguous())            # a side of 1
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


def _int8_layer(cuda, gen, k, cin, cout, leak=0.1):
  w = torch.randn(k, k, cin, cout, device=cuda, generator=gen)
  bias = torch.randn(cout, device=cuda, generator=gen) * 0.1
  return quantize.quantize_chain([cc.ChainLayer(w, bias, leak)])[0]


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('pad', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('k,cin,cout', [(3, 32, 16), (4, 32, 64),
                                        (4, 64, 32), (4, 128, 128)])
def test_conv_int8_kernel_matches_plain(cuda, k, cin, cout, pad, out_dtype):
  """K3 vs its plain version: exact int32 sums and the same FMA epilogue,
  so equal up to float noise (1e-6 relative); odd sizes exercise the tile
  overhang at every border."""
  gen = torch.Generator(device=cuda).manual_seed(k * cin + cout)
  x = torch.randint(-127, 128, (2, 19, 37, cin), device=cuda, generator=gen,
                    dtype=torch.int8)
  a_scale = torch.rand(2, device=cuda, generator=gen) * 0.1 + 0.01
  layer = _int8_layer(cuda, gen, k, cin, cout)
  want_amax = out_dtype == torch.float32
  got, amax = cc.conv_layer_int8_cuda(x, a_scale, layer, pad, out_dtype,
                                      want_amax)
  torch.cuda.synchronize()
  want, ref_amax = cc.conv_layer_int8_plain(x, a_scale, layer, pad,
                                            out_dtype, want_amax)
  scale = want.float().abs().max().item()
  assert got.dtype == out_dtype and got.shape == want.shape
  assert (got.float() - want.float()).abs().max().item() <= 1e-6 * scale
  if want_amax:
    torch.testing.assert_close(amax, ref_amax, rtol=1e-6, atol=0)


def test_requant_kernel_matches_plain(cuda):
  """Exact: the same IEEE division and half-to-even rounding, on .5 ties
  and on an all-zero image (the 1e-8 floor)."""
  gen = torch.Generator(device=cuda).manual_seed(0)
  y = torch.randn(3, 16, 16, 32, device=cuda, generator=gen)
  y[0, 0, 0, 0] = 127 * 0.25       # s = 4: y · s exact
  y[0, 1, 0, :4] = torch.tensor([0.5, 1.5, 2.5, -3.5], device=cuda) * 0.25
  y[0].clamp_(-127 * 0.25, 127 * 0.25)
  y[2] = 0
  amax = y.abs().amax(dim=(1, 2, 3))
  xi, scale = cc.requant_cuda(y, amax)
  torch.cuda.synchronize()
  want_x, want_s = cc.requant_plain(y, amax)
  assert torch.equal(xi, want_x) and torch.equal(scale, want_s)
  assert xi[0, 1, 0, :4].tolist() == [0, 2, 2, -4]


# The flagship U-Net's quantized layers at 256^2 (k4, reflect): (H, Cin,
# Cout), cut to B = 2.
K3_FLAGSHIP_LAYERS = [(256, 32, 32), (128, 32, 64), (128, 64, 64),
                      (64, 64, 128), (64, 128, 128)]


def _int8_case(cuda, k, cin, cout, pad, out_dtype, shape):
  """K3 against its plain version: equal up to float noise (1e-6
  relative), and the amax of an intermediate (f32) output too."""
  gen = torch.Generator(device=cuda).manual_seed(k * cin + cout)
  layer = _int8_layer(cuda, gen, k, cin, cout)
  want_amax = out_dtype == torch.float32
  x = torch.randint(-127, 128, (*shape, cin), device=cuda, generator=gen,
                    dtype=torch.int8)
  scale = torch.rand(shape[0], device=cuda, generator=gen) * 0.1 + 0.01
  got, amax = cc.conv_layer_int8_cuda(x, scale, layer, pad, out_dtype,
                                      want_amax)
  torch.cuda.synchronize()
  want, ref_amax = cc.conv_layer_int8_plain(x, scale, layer, pad, out_dtype,
                                            want_amax)
  ref = want.float().abs().max().item()
  assert got.dtype == out_dtype and got.shape == want.shape
  assert (got.float() - want.float()).abs().max().item() <= 1e-6 * ref
  if want_amax:
    torch.testing.assert_close(amax, ref_amax, rtol=1e-6, atol=0)


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('size,cin,cout', K3_FLAGSHIP_LAYERS)
def test_conv_int8_flagship_layer_shapes(cuda, size, cin, cout, out_dtype):
  _int8_case(cuda, 4, cin, cout, 'reflection', out_dtype, (2, size, size))


@pytest.mark.parametrize('pad', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('cin,cout', [(32, 32), (64, 16), (96, 64),
                                      (128, 128), (160, 32)])
def test_conv_int8_k3_chunks(cuda, cin, cout, pad):
  """k3: one chunk of Cin rounded up to 32, 64 or 128 (the last stage
  partial), or chunks of 128; on 21 x 70 (a partial row tile, two column
  tiles)."""
  _int8_case(cuda, 3, cin, cout, pad, torch.float32, (2, 21, 70))
  _int8_case(cuda, 3, cin, cout, pad, torch.bfloat16, (2, 21, 70))


@pytest.mark.parametrize('k', [3, 4])
def test_conv_int8_single_image(cuda, k):
  """B = 1, and the smallest image reflect padding takes (2 x 2 for k3;
  3 x 3 for k4, whose bottom and right pads are 2)."""
  _int8_case(cuda, k, 64, 64, 'reflection', torch.float32, (1, 33, 65))
  _int8_case(cuda, k, 32, 16, 'reflection', torch.bfloat16,
             (1, k - 1, k - 1))


def test_int8_chain_matches_plain_chain(cuda):
  """A three-layer k4 chain (two intermediates, each requantized by the
  requant kernel) against the plain chain: bit-identical by design."""
  gen = torch.Generator(device=cuda).manual_seed(9)
  layers = [_int8_layer(cuda, gen, 4, a, b)
            for a, b in ((32, 64), (64, 64), (64, 32))]
  x = torch.randint(-127, 128, (2, 40, 72, 32), device=cuda, generator=gen,
                    dtype=torch.int8)
  scale = torch.rand(2, device=cuda, generator=gen) * 0.1 + 0.01
  before = (cc.conv_layer_int8_cuda.launches, cc.requant_cuda.launches)
  got = cc.fused_conv_chain_int8(x, scale, layers)
  torch.cuda.synchronize()
  assert (cc.conv_layer_int8_cuda.launches, cc.requant_cuda.launches) == \
      (before[0] + 3, before[1] + 2)
  want = x, scale
  for i, layer in enumerate(layers):
    last = i + 1 == len(layers)
    y, amax = cc.conv_layer_int8_plain(
        *want, layer, out_dtype=torch.bfloat16 if last else torch.float32,
        want_amax=not last)
    want = y if last else cc.requant_plain(y, amax)
  assert torch.equal(got, want)


def test_int8_wrappers_raise_on_unsupported_inputs(cuda):
  gen = torch.Generator(device=cuda).manual_seed(0)
  layer = _int8_layer(cuda, gen, 3, 32, 32)
  x = torch.zeros(1, 8, 8, 32, device=cuda, dtype=torch.int8)
  one = torch.ones(1, device=cuda)
  with pytest.raises(ValueError):
    cc.conv_layer_int8_cuda(x.float(), one, layer)            # not int8
  with pytest.raises(ValueError):
    cc.conv_layer_int8_cuda(x[..., :16].contiguous(), one,
                            _int8_layer(cuda, gen, 3, 16, 32))  # Cin 16
  with pytest.raises(ValueError):
    cc.conv_layer_int8_cuda(x, one, layer._replace(w_scale=None))
  with pytest.raises(ValueError):
    cc.conv_layer_int8_cuda(x, one, layer, out_dtype=torch.float16)
  with pytest.raises(ValueError):
    cc.requant_cuda(torch.zeros(1, 3, 3, 3, device=cuda), one)  # 27 values
  with pytest.raises(ValueError):
    cc.requant_cuda(x.double(), one)


def test_flagship_int8_forward_launches_kernels(cuda):
  """At 64² each U-Net chain quantizes its second layer: 3 K1, 5 K2 (the
  float prefix layers), 5 K3 convs, no requant."""
  model, undersample_batch = build_flagship(64, torch.bfloat16, 'cuda', 0,
                                            quantize_inference=True)
  gen = torch.Generator(device=cuda).manual_seed(0)
  batch = undersample_batch(gen, torch.rand(2, 64, 64, device=cuda,
                                            generator=gen), 'varden', 8)
  counters = (dc_kernel.dc_cuda, cc.conv_layer_cuda, cc.conv_layer_int8_cuda,
              cc.requant_cuda)
  for c in counters:
    c.launches = 0
  quantize.reset_trace_log()
  with torch.inference_mode():
    out = model(batch['inp'], batch['kspace'], batch['mask'])
  torch.cuda.synchronize()
  assert tuple(c.launches for c in counters) == (3, 5, 5, 0)
  assert not quantize.fell_back_to_bf16()
  assert out['pred'].shape == (2, 64, 64, 2)
  assert bool(torch.isfinite(out['pred'].float()).all())


@pytest.mark.parametrize('module', [mosaic_prims, int8_prims],
                         ids=['mosaic', 'int8'])
def test_probes_pass_on_card(cuda, module):
  before = module.probe_cuda.launches
  results = module.run_all('cuda')
  assert [r.status for r in results] == ['OK'] * len(module.PROBES), results
  assert module.probe_cuda.launches == before + len(module.PROBES)


def _int8_draw(cuda, seed):
  gen = torch.Generator(device=cuda).manual_seed(seed)
  a = torch.randint(-127, 128, (256, 128), device=cuda, generator=gen,
                    dtype=torch.int8)
  b = torch.randint(-127, 128, (128, 128), device=cuda, generator=gen,
                    dtype=torch.int8)
  return a, b


def _probe_exact(module, name, *inputs):
  """The probe's kernel, once (one launch), equal bit for bit to its plain
  version on the card."""
  before = module.probe_cuda.launches
  got = module.probe_cuda(name, *inputs)
  torch.cuda.synchronize()
  assert module.probe_cuda.launches == before + 1
  want = module.plain(name, *inputs)
  assert got.dtype == want.dtype and got.shape == want.shape
  assert torch.equal(got, want), (got.double() - want.double()).abs().max()
  return got


@pytest.mark.parametrize('seed', [1, 2, 3])
@pytest.mark.parametrize('name', ['s8 x s8 -> s32 mma',
                                  's8 mma + f32 dequant'])
def test_s8_wgmma_probe_seeded_draws(cuda, name, seed):
  """The s8 wgmma product (b transposed in the kernel) and its f32 dequant
  on three more draws, bit-exact."""
  _probe_exact(int8_prims, name, *_int8_draw(cuda, seed))


@pytest.mark.parametrize('name', ['s8 x s8 -> s32 mma',
                                  's8 mma + f32 dequant'])
def test_s8_wgmma_probe_extremes(cuda, name):
  """All -127 times all 127: every sum is -128 * 127^2 = -2,064,512, the
  largest |sum| the probe's inputs allow, exact in s32 and in f32."""
  a = torch.full((256, 128), -127, dtype=torch.int8, device=cuda)
  b = torch.full((128, 128), 127, dtype=torch.int8, device=cuda)
  got = _probe_exact(int8_prims, name, a, b)
  if got.dtype == torch.int32:
    assert (got == -2064512).all()


def _requant_case(cuda, case):
  gen = torch.Generator(device=cuda).manual_seed(7)
  f = torch.randn(256, 128, device=cuda, generator=gen) * 3
  if case == 'zero':
    f.zero_()
  elif case == 'ties':             # amax 127 / 4: f * 4 is exact
    f.clamp_(-127 * 0.25, 127 * 0.25)
    f[3, 5] = 127 * 0.25
    f[100, :4] = torch.tensor([0.5, 1.5, 2.5, -3.5], device=cuda) * 0.25
  elif case == 'max_in_last_block':   # rows 224-255: the cluster's rank 7
    f[250, 7] = -50.0
  return f


@pytest.mark.parametrize('case', ['zero', 'ties', 'max_in_last_block'])
def test_requant_cluster_probe_cases(cuda, case):
  """The cluster requant, bit-exact: an all-zero tile (the 1e-8 floor),
  exact .5 ties (half to even), and the tile's max in the last block, which
  every other block must read through distributed shared memory."""
  name = 'f32 -> int8 dynamic requant'
  y = _probe_exact(int8_prims, name, _requant_case(cuda, case))
  if case == 'zero':
    assert not bool(y.any())
  elif case == 'ties':
    assert y[100, :4].tolist() == [0, 2, 2, -4] and y[3, 5].item() == 127
  else:
    assert y[250, 7].item() == -127 and y[:224].abs().max().item() < 127


@pytest.mark.parametrize('name', sorted(mosaic_prims.PROBES))
def test_bf16_probes_on_random_tiles(cuda, name):
  """Every K4 probe on a random bf16 tile of its input shape (the
  250-row pair roll included), bit-exact, one launch each."""
  shape = mosaic_prims.PROBES[name][1]
  gen = torch.Generator(device=cuda).manual_seed(len(name))
  x = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
  _probe_exact(mosaic_prims, name, x)


@pytest.mark.parametrize('name', ['int8 lane roll via 32-bit words',
                                  'int8 where(iota) select'])
def test_int8_moves_on_random_tiles(cuda, name):
  _probe_exact(int8_prims, name, _int8_draw(cuda, 4)[0])


def test_probe_wrappers_raise_on_unsupported_inputs(cuda):
  x = mosaic_prims.probe_input((256, 128), cuda)
  with pytest.raises(ValueError):
    mosaic_prims.probe_cuda('lane roll bf16 by 32', x[:128])   # shape
  with pytest.raises(ValueError):
    mosaic_prims.probe_cuda('lane roll bf16 by 32', x.float())
  a, b = _int8_draw(cuda, 5)
  with pytest.raises(ValueError):
    int8_prims.probe_cuda('s8 x s8 -> s32 mma', a, b.t())       # layout
  with pytest.raises(ValueError):
    int8_prims.probe_cuda('s8 x s8 -> s32 mma', a.cpu(), b.cpu())


def test_probe_kernels_refuse_other_descriptor_layouts(cuda):
  """The MMA probes launch only with the layout fields compiled into the
  kernel (mma_descriptors, odd_pixel_descriptors): any other returns
  cudaErrorInvalidValue (1) and launches nothing."""
  from csmri_refinement_tpu_torch import probes
  from csmri_refinement_tpu_torch.ops import native
  a, b = _int8_draw(cuda, 6)
  y = torch.empty(256, 128, dtype=torch.int32, device=cuda)
  a_desc, _ = int8_prims.mma_descriptors()
  assert probes.lib().probe_int8(
      0, native.ptr(a), native.ptr(b), native.ptr(y), 256, a_desc,
      probes.descriptor(16, 512, 128), native.stream_of(a)) == 1
  x = mosaic_prims.probe_input((256, 128), cuda)
  out = torch.empty(2032, 16, device=cuda)
  _, b_desc = mosaic_prims.odd_pixel_descriptors()
  assert probes.lib().probe_bf16(
      9, native.ptr(x), native.ptr(out), 256,
      probes.descriptor(mosaic_prims.odd_pixel_plane() + 16, 128), b_desc,
      native.stream_of(x)) == 1


# -- the GAN refinement slice -------------------------------------------------


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('pad', ['zero', 'replication', 'reflection'])
@pytest.mark.parametrize('hw', [(16, 16), (15, 21)])
def test_subpixel_up_conv_on_card(cuda, dtype, pad, hw):
  """The subpixel up-conv (cuDNN) on the card against the CPU: f32 within
  the conv bar 2e-4, bf16 within 2e-2 of max |ref| (bf16 rounding of the
  phase kernels and the output)."""
  from csmri_refinement_tpu_torch.models.unet import SubpixelNNResizeConv
  gen = torch.Generator().manual_seed(hw[1])
  conv = SubpixelNNResizeConv(32, 16, True, pad)
  with torch.no_grad():
    conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.1)
    conv.bias.copy_(torch.randn(16, generator=gen))
  x = torch.randn(2, 32, hw[0], hw[1], generator=gen)
  dt = torch.float32 if dtype == 'f32' else torch.bfloat16
  with torch.no_grad():
    want = conv(x.to(dt).float())
    got = conv.to(cuda)(x.to(cuda, dt).contiguous(
        memory_format=torch.channels_last)).float().cpu()
  err = (got - want).abs().max().item()
  assert tuple(got.shape) == (2, 2 * hw[0], 2 * hw[1], 16)
  assert err <= (2e-4 if dtype == 'f32' else 2e-2 * want.abs().max().item())


def test_gan_steps_on_card_match_cpu(cuda):
  """Two GAN updates of a narrow configs/2-refinement.json at 32² on the
  card and on the CPU from the same weights and batches (dropout off, the
  pool filling): losses within 1e-3 relative (chip_smoke.py's bar), the
  frozen RecNet unchanged, no K1-bwd launch."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.training.adversarial_runner import (
      AdversarialRunner)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict(synthetic_refinement_conf(
      32, 8, 4, 4, dropout=False, narrow=True))
  cpu = AdversarialRunner(conf, 'train', 'cpu')
  gpu = AdversarialRunner(conf, 'train', cuda)
  gpu.gen.load_state_dict(cpu.gen.state_dict())
  gpu.disc.load_state_dict(cpu.disc.state_dict())
  frozen = {k: v.clone() for k, v in
            cpu.gen.pretrained_model.state_dict().items()}
  gen = torch.Generator().manual_seed(0)
  dc_kernel.dc_bwd_cuda.launches = 0
  for _ in range(2):
    gt = torch.rand(4, 32, 32, generator=gen)
    mask = masks.cartesian_mask(gen, (4, 32, 32), 4)
    want = cpu.train_batch(us.undersample_batch(None, gt, fixed_mask=mask))[0]
    got = gpu.train_batch(us.undersample_batch(
        None, gt.to(cuda), fixed_mask=mask.to(cuda)))[0]
    for name in ('gen_loss', 'disc_loss'):
      w, g = want[name].item(), got[name].item()
      assert abs(g - w) <= 1e-3 * abs(w), (name, g, w)
  assert dc_kernel.dc_bwd_cuda.launches == 0
  for name, value in gpu.gen.pretrained_model.state_dict().items():
    assert torch.equal(value.cpu(), frozen[name]), name


def test_gan_step_above_512_on_card(cuda):
  """One update of configs/2-refinement.json at full width on 640²
  Synthetic phantoms, B = 2: the frozen RecNet's DC runs on K1 (3 launches
  a generator forward, no K1-bwd) and the losses are finite."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.training.adversarial_runner import (
      AdversarialRunner)
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict(synthetic_refinement_conf(640, 2, 2, 2))
  runner = AdversarialRunner(conf, 'train', cuda)
  gen = torch.Generator().manual_seed(640)
  gt = torch.rand(2, 640, 640, generator=gen)
  mask = masks.cartesian_mask(gen, (2, 640, 640), 8)
  before = (dc_kernel.dc_cuda.launches, dc_kernel.dc_bwd_cuda.launches)
  losses = runner.train_batch(us.undersample_batch(
      None, gt.to(cuda), fixed_mask=mask.to(cuda)))[0]
  torch.cuda.synchronize()
  k1 = dc_kernel.dc_cuda.launches - before[0]
  assert k1 > 0 and k1 % 3 == 0
  assert dc_kernel.dc_bwd_cuda.launches == before[1]
  for name in ('gen_loss', 'disc_loss'):
    assert torch.isfinite(losses[name]).item(), name

@pytest.mark.parametrize('b', [1, 8])
@pytest.mark.parametrize('side', [8, 16, 32])
@pytest.mark.parametrize('pad', ['reflection', 'zero'])
@pytest.mark.parametrize('cin,cout', [(256, 256), (256, 512), (512, 256),
                                      (512, 512)])
def test_conv_layer_f32_segmentation_widths(cuda, cin, cout, pad, side, b):
  """K2's f32 route at the segmentation U-Net's deep widths: one 16×16
  tile per image at 16², a partial tile (and an 8-pixel reflection) at 8²,
  a single image."""
  _conv_case(cuda, 3, cin, cout, pad, torch.float32, (b, side, side))


# The 18 eval-chain layers of configs/3-train-segmentation-unet.json at a
# 256² input: (side, Cin, Cout), k3, reflection.
SEG_LAYERS = [(256, 2, 32), (256, 32, 32), (128, 32, 64), (128, 64, 64),
              (64, 64, 128), (64, 128, 128), (32, 128, 256), (32, 256, 256),
              (16, 256, 512), (16, 512, 512), (32, 512, 256), (32, 256, 256),
              (64, 256, 128), (64, 128, 128), (128, 128, 64), (128, 64, 64),
              (256, 64, 32), (256, 32, 32)]


@pytest.mark.parametrize('layer', range(len(SEG_LAYERS)))
def test_conv_layer_f32_segmentation_layers(cuda, layer):
  """Each segmentation layer at its shape, B = 2: the stem on the direct
  route, the others on 3xTF32 (conv_f32.cu), within the f32 bar."""
  side, cin, cout = SEG_LAYERS[layer]
  _conv_case(cuda, 3, cin, cout, 'reflection', torch.float32,
             (2, side, side))


@pytest.mark.parametrize('pad', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('cin,cout', [(32, 32), (32, 64), (64, 128),
                                      (128, 128), (128, 64)])
def test_conv_layer_f32_k4_gan_widths(cuda, cin, cout, pad):
  """The GAN generator's k4 chain widths (32-128) with every pad mode."""
  _conv_case(cuda, 4, cin, cout, pad, torch.float32, (2, 40, 72))


@pytest.mark.parametrize('pad', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('k', [3, 4])
@pytest.mark.parametrize('cin', [1, 2, 3, 5, 8, 9, 12])
def test_conv_layer_f32_small_cin(cuda, cin, k, pad):
  """The direct route (Cin < 8) and the smallest 3xTF32 ones: Cin 8, 9
  (4-byte staging) and 12 (a zero-padded 16-channel chunk)."""
  _conv_case(cuda, k, cin, 32, pad, torch.float32, (3, 21, 13))


@pytest.mark.parametrize('shape', [(2, 8, 8), (3, 16, 16), (2, 32, 32),
                                   (1, 3, 130), (2, 70, 5), (1, 2, 2),
                                   (4, 24, 40), (1, 65, 64)])
@pytest.mark.parametrize('k', [3, 4])
def test_conv_layer_f32_image_shapes(cuda, shape, k):
  """Narrow images (M tiles across rows), two segments with a partial one,
  tall and tiny images; replicate padding so a side of 2 takes k4."""
  _conv_case(cuda, k, 64, 64, 'replication', torch.float32, shape)


@pytest.mark.parametrize('cout', [8, 24, 40, 100])
def test_conv_layer_f32_cout_not_a_multiple_of_16(cuda, cout):
  _conv_case(cuda, 3, 64, cout, 'reflection', torch.float32, (2, 16, 16))
  _conv_case(cuda, 3, 2, cout, 'zero', torch.float32, (2, 16, 16))


@pytest.mark.parametrize('side,cin,cout', [(16, 512, 512), (256, 2, 32),
                                           (64, 128, 128)])
def test_conv_layer_f32_launches_are_bit_identical(cuda, side, cin, cout):
  """No atomics and one fixed K order per output: two launches of a layer
  give the same bits, and each counts one f32 launch."""
  gen = torch.Generator(device=cuda).manual_seed(side + cin)
  x = torch.randn(2, side, side, cin, device=cuda, generator=gen)
  layer = cc.ChainLayer(torch.randn(3, 3, cin, cout, device=cuda,
                                    generator=gen) * 0.05,
                        torch.randn(cout, device=cuda, generator=gen), 0.2)
  before = cc.conv_layer_f32_cuda.launches
  first = cc.conv_layer_cuda(x, layer, 'reflection')
  second = cc.conv_layer_cuda(x, layer, 'reflection')
  torch.cuda.synchronize()
  assert cc.conv_layer_f32_cuda.launches - before == 2
  assert torch.equal(first, second)


def test_conv_layer_f32_raises_outside_its_routes(cuda):
  x = torch.zeros(1, 8, 8, 16, device=cuda)
  with pytest.raises(ValueError):
    cc.conv_layer_f32_cuda(x.to(torch.bfloat16),
                           cc.ChainLayer(torch.zeros(3, 3, 16, 16)))
  with pytest.raises(ValueError):                       # k5
    cc.conv_layer_f32_cuda(x, cc.ChainLayer(torch.zeros(5, 5, 16, 16)))
  with pytest.raises(ValueError):                       # 65536 images
    cc.conv_layer_f32_cuda(torch.zeros(65536, 2, 2, 16, device=cuda),
                           cc.ChainLayer(torch.zeros(3, 3, 16, 16)))
  with pytest.raises(ValueError):                       # reflect a side of 1
    cc.conv_layer_f32_cuda(torch.zeros(1, 1, 8, 16, device=cuda),
                           cc.ChainLayer(torch.zeros(3, 3, 16, 16)))


def test_reconstruction_runner_with_vgg19_loss_on_card(cuda):
  """A reconstruction Runner with losses MSE and VGG19 builds its VGG19 on
  its own device and takes a train step on the card."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict({
      'seed': 0, 'run_name': 'vgg', 'train_dataset': 'Synthetic',
      'validation_dataset': 'Synthetic',
      'synthetic': {'image_size': 32, 'num_train': 4, 'num_val': 2},
      'undersampling': {'sampling_scheme': 'varden',
                        'acceleration_factor': 4},
      'runner_type': 'standard', 'application': 'reconstruction',
      'model': {'name': 'RecNet', 'num_blocks': 1, 'num_convs': 2,
                'num_filters': 8},
      'losses': ['MSE', 'VGG19'], 'loss_weights': {'VGG19': 0.1},
      'vgg_random_init': True, 'vgg_loss': {'criterion': 'MSE'},
      'optimizer': {'name': 'Adam', 'learning_rate': 0.0002},
      'num_epochs': 1, 'batch_size': 2, 'num_data_workers': 0})
  runner = Runner(conf, 'train', cuda)
  vgg = runner.criteria['VGG19'].criterion.vgg
  assert next(vgg.parameters()).device.type == 'cuda'
  gen = torch.Generator().manual_seed(0)
  gt = torch.rand(2, 32, 32, generator=gen)
  mask = masks.cartesian_mask(gen, (2, 32, 32), 4)
  losses, _ = runner.train_batch(us.undersample_batch(
      None, gt.to(cuda), fixed_mask=mask.to(cuda)))
  assert runner.step == 1
  assert all(bool(torch.isfinite(v).all()) for v in losses.values())
  assert set(losses) >= {'MSE', 'VGG19', 'loss'}


def _segmentation_unet(mode):
  import json
  import os
  from csmri_refinement_tpu_torch.models import construct_model
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  with open(os.path.join(repo, 'configs',
                         '3-train-segmentation-unet.json')) as f:
    section = json.load(f)['model']
  model = construct_model(dict(section, upsampling_mode=mode))
  model.init_weights(torch.Generator().manual_seed(0))
  return model, section


@pytest.mark.parametrize('mode', ['pixelshuffle', 'transposed'])
def test_segmentation_unet_eval_on_card_matches_cpu(cuda, mode):
  """The full-width segmentation U-Net (configs/3-train-segmentation-
  unet.json) in eval mode at 64², B = 2: its 18 chain layers launch K2's f32
  route, and the logits agree with the CPU's within 5e-4 of max |ref|."""
  model, _ = _segmentation_unet(mode)
  model.eval()
  x = torch.rand(2, 64, 64, 2, generator=torch.Generator().manual_seed(1))
  with torch.no_grad():
    want = model(x)
    before = cc.conv_layer_cuda.launches
    got = model.to(cuda)(x.to(cuda)).cpu()
  torch.cuda.synchronize()
  assert cc.conv_layer_cuda.launches - before == 18
  assert got.shape == want.shape == (2, 64, 64, 2)
  assert (got - want).abs().max().item() <= 5e-4 * want.abs().max().item()


def test_segmentation_score_on_card_matches_cpu(cuda, tmp_path):
  """The segmentation score of the full-width network from a port
  checkpoint, on the card and on the CPU, on phantoms with a little noise:
  the same per-example scores within 1e-3."""
  from csmri_refinement_tpu_torch.metrics.segmentation_score import (
      SegmentationScore)
  from csmri_refinement_tpu_torch.profile_seg import (
      synthetic_segmentation_conf)
  from csmri_refinement_tpu_torch.data import load_dataset
  from csmri_refinement_tpu_torch.utils.config import Configuration
  model, section = _segmentation_unet('pixelshuffle')
  path = str(tmp_path / 'seg.ckpt')
  torch.save({'runner': {'model': model.state_dict()}}, path)
  conf = Configuration.from_dict(synthetic_segmentation_conf(64, 2, 3))
  data = load_dataset(conf, None, 'Synthetic', 'val')
  gen = torch.Generator().manual_seed(2)
  pred = torch.stack([torch.from_numpy(data[i]['inp']) for i in range(3)])
  pred = pred + 0.05 * torch.randn(pred.shape, generator=gen)
  label = torch.stack([torch.from_numpy(data[i]['target']) for i in range(3)])
  scores = []
  for device in ('cpu', cuda):
    score = SegmentationScore(dict(section, pretrained_weights=[path,
                                                                'model']),
                              None, class_idx=[0, 1])
    scores.append(score(pred.to(device), label.to(device)))
  for want, got in zip(*scores):
    assert abs(got - want) <= 1e-3


@pytest.mark.parametrize('b', [1, 5])
@pytest.mark.parametrize('k,cin,cout', [(4, 2, 32), (4, 32, 32), (3, 2, 32),
                                        (3, 32, 32)],
                         ids=['k4-stem', 'k4', 'k3-stem', 'k3'])
def test_conv_layer_f32_at_512(cuda, k, cin, cout, b):
  """K2's f32 route at the paper's 512² (the GAN's k4 layers at B = 5 in
  validation, B = 1 in ``validate -b 1``; the segmentation U-Net's k3),
  reflection padding, the stem on the direct route: one launch each,
  within the f32 bar."""
  before = cc.conv_layer_f32_cuda.launches
  _conv_case(cuda, k, cin, cout, 'reflection', torch.float32, (b, 512, 512))
  assert cc.conv_layer_f32_cuda.launches == before + 1


@pytest.mark.parametrize('kernel', ['dc', 'dc_bwd'])
def test_dc_kernels_at_the_1_recnet_shape(cuda, kernel):
  """K1 and K1-bwd at (20, 512, 512, 2), configs/1-recnet.json's training
  batch, against their plain versions (2e-4 and 2e-3,
  tests/test_dc_pallas.py:26,46)."""
  b, n = 20, 512
  gen = torch.Generator(device=cuda).manual_seed(20)
  x = torch.randn(b, n, n, 2, device=cuda, generator=gen)
  m = masks.cartesian_mask(gen, (b, n, n), 8, device=cuda)[..., None]
  m = m.contiguous()
  if kernel == 'dc':
    k0 = torch.randn(b, n, n, 2, device=cuda, generator=gen) * m
    got = dc_kernel.dc_cuda(x, k0, m)
    torch.cuda.synchronize()
    err, tol = (got - dc_kernel.dc_plain(x, k0, m)).abs().max().item(), 2e-4
  else:
    got = dc_kernel.dc_bwd_cuda(x, m)
    torch.cuda.synchronize()
    err = (got - dc_kernel.dc_plain_vjp(x, m, False)[0]).abs().max().item()
    tol = 2e-3
  assert err <= tol


def test_validation_masks_do_not_depend_on_the_device(cuda):
  """A slice's validation mask is drawn on the host, so the card and the
  CPU validate the same undersampled inputs."""
  from csmri_refinement_tpu_torch.training import prep
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict({'undersampling': {
      'sampling_scheme': 'varden', 'acceleration_factor': 8}})
  masks_by_device = [prep.RecBatchPreparer(conf, device)._val_mask(i, 512,
                                                                   512)
                     for device in ('cpu', cuda) for i in (0, 7)]
  assert masks_by_device[2].device.type == 'cuda'
  for want, got in zip(masks_by_device[:2], masks_by_device[2:]):
    assert torch.equal(got.cpu(), want)
  assert not torch.equal(masks_by_device[0], masks_by_device[1])


def test_validation_inputs_with_noise_do_not_depend_on_the_device(cuda):
  """With ``undersampling.noise`` > 0 validation adds no noise (as the JAX
  package's ``_val_cartesian``), so the card and the CPU validate the same
  inputs: the image-domain tensors within 1e-6 of max |target|, one ortho
  FFT pair apart; ``kspace`` within 1e-6 of its own max (its DC term is
  ~26 × max |target| at 256², where cuFFT and pocketfft round apart by
  1.9e-6, 7e-8 of it; a noise of 0.05 would move it by ~1)."""
  import numpy as np
  from csmri_refinement_tpu_torch.data import datasets
  from csmri_refinement_tpu_torch.training import prep
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict({'undersampling': {
      'sampling_scheme': 'varden', 'acceleration_factor': 8,
      'noise': 0.05}})
  host = {'gt': datasets._make_phantoms(4, 256, 3)[0],
          'index': np.arange(4, dtype=np.int32)}
  want = prep.RecBatchPreparer(conf, 'cpu').prepare_val(host)
  got = prep.RecBatchPreparer(conf, cuda).prepare_val(host)
  for key in ('mask', 'target', 'inp', 'kspace'):
    scale = want['kspace' if key == 'kspace' else 'target'].abs().max()
    assert got[key].device.type == 'cuda'
    err = (got[key].cpu() - want[key]).abs().max().item()
    assert err <= 1e-6 * scale.item(), (key, err)


def _twin_wrapper(widths_seed=0):
  """The flagship RefinementWrapper as a reference-layout twin
  (``tests/torch_twins.py``) at the widths of configs/2-refinement.json,
  seeded weights and BN statistics, eval mode, and its converted port
  module."""
  import torch_twins
  from csmri_refinement_tpu_torch.flagship import flagship_model
  from csmri_refinement_tpu_torch.utils import torch_import
  from csmri_refinement_tpu_torch.utils.jax_weights import (
      load_flax_variables)
  unet = dict(num_inputs=2, num_outputs=1, num_layers_per_scale=2,
              encode_filters=[32, 64, 128], decode_filters=[64, 32],
              kernel_size=4, upsampling_mode='nn-resize-conv',
              output_activation='none', padding='reflection',
              decoder_act_upsampling_only=True)
  twin = torch_twins.TorchRefinementWrapper(
      torch_twins.TorchRecNet(num_blocks=3, num_convs=3, num_filters=32),
      torch_twins.TorchUNET(**unet))
  gen = torch.Generator().manual_seed(widths_seed)
  with torch.no_grad():
    for name, t in list(twin.named_parameters()) + list(
        twin.named_buffers()):
      if not t.is_floating_point():
        continue
      if t.ndim > 1:
        t.copy_(torch.randn(t.shape, generator=gen) / t[0].numel() ** 0.5)
      elif name.endswith('running_var') or name.endswith('weight'):
        t.copy_(0.5 + torch.rand(t.shape, generator=gen))
      else:
        t.copy_(0.2 * torch.randn(t.shape, generator=gen))
    twin.scale.fill_(0.3)
  twin.eval()
  tree = torch_import.convert_refinement_wrapper(
      twin.state_dict(), {'num_blocks': 3, 'num_convs': 3},
      torch_import._unet_convert_kwargs(unet))
  port = flagship_model()
  load_flax_variables(port, tree)
  return twin, port.eval()


def test_imported_reference_wrapper_on_card_matches_its_twin(cuda):
  """A reference-layout flagship wrapper through ``torch_import`` runs on
  the card (K1 and K2's f32 route) at 256², B = 2, TF32 off, within 5e-4
  of the twin's forward on the CPU."""
  from csmri_refinement_tpu_torch.ops import undersample
  twin, port = _twin_wrapper()
  gen = torch.Generator().manual_seed(1)
  gt = torch.rand(2, 256, 256, generator=gen)
  batch = undersample.undersample_batch(gen, gt, 'varden', 8)
  with torch.no_grad():
    want = twin(*[batch[k].permute(0, 3, 1, 2)
                  for k in ('inp', 'kspace', 'mask')])['pred']
    port.to(cuda)
    got = port(*[batch[k].to(cuda) for k in ('inp', 'kspace', 'mask')])
  torch.cuda.synchronize()
  err = (got['pred'].cpu() - want.permute(0, 2, 3, 1)).abs().max().item()
  assert err <= 5e-4, err


def _flax_tree(module, moments=None):
  """``module``'s tensors as a flax variable tree (numpy, the JAX
  layouts); with ``moments`` (a seeded RandomState) params-shaped random
  values in their place."""
  import numpy as np
  from csmri_refinement_tpu_torch.utils.jax_weights import (flax_shape,
                                                            flax_tensors)
  tree = {}
  for tensor, collection, path, move in flax_tensors(module):
    if moments is not None and collection != 'params':
      continue
    flip, perm = move
    value = tensor.detach().cpu().numpy()
    if perm:
      value = np.transpose(value, np.argsort(perm))
    if flip:
      value = np.flip(value, flip).copy()
    if moments is not None:
      value = moments.rand(*flax_shape(tensor, move)).astype(np.float32)
    node = tree.setdefault(collection, {})
    for key in path[:-1]:
      node = node.setdefault(key, {})
    node[path[-1]] = value
  return tree if moments is None else tree['params']


def test_optax_state_restores_onto_the_card(cuda):
  """A JAX checkpoint's runner state (a flax tree and an Adam optax state
  in the layout ``flax.serialization.to_state_dict`` writes) restored
  into a runner on the card: the moments sit on the card beside their
  parameters, hold the moved values, and a step runs."""
  import numpy as np
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict({
      'seed': 0, 'runner_type': 'standard',
      'model': {'name': 'RecNet', 'num_blocks': 2, 'num_convs': 2,
                'num_filters': 8},
      'loss_name': 'MSE',
      'optimizer': {'name': 'Adam', 'learning_rate': 0.0002}})
  runner = Runner(conf, 'train', cuda)
  rng = np.random.RandomState(0)
  mu, nu = _flax_tree(runner.model, rng), _flax_tree(runner.model, rng)
  state = {'model': _flax_tree(runner.model), 'step': 7, 'optimizer': {
      'count': np.int32(7),
      'hyperparams': {'learning_rate': np.float32(1e-4),
                      'b1': np.float32(0.9), 'b2': np.float32(0.999),
                      'eps': np.float32(1e-8), 'eps_root': np.float32(0)},
      'hyperparams_states': {},
      'inner_state': {'0': {'count': np.int32(7), 'mu': mu, 'nu': nu},
                      '1': {}}}}
  runner.load_state_dict(state)
  kernel = mu['block_0']['conv_0']['kernel']
  p = runner.model.block_0.conv_0.weight
  entry = runner.optimizer.state[p]
  assert p.device.type == entry['exp_avg'].device.type == 'cuda'
  assert entry['exp_avg_sq'].device == p.device
  assert torch.equal(entry['exp_avg'].cpu(), torch.from_numpy(
      np.transpose(kernel, (3, 2, 0, 1)).copy()))
  assert entry['step'].item() == 7 and runner.step == 7
  assert runner.optimizer.param_groups[0]['lr'] == pytest.approx(1e-4)
  gen = torch.Generator().manual_seed(2)
  from csmri_refinement_tpu_torch.ops import undersample
  batch = undersample.undersample_batch(
      gen, torch.rand(2, 64, 64, generator=gen), 'varden', 4)
  losses, _ = runner.train_batch({k: v.to(cuda) for k, v in batch.items()})
  assert torch.isfinite(losses['loss']).item()
  assert entry['step'].item() == 8


def test_validate_on_card_matches_cpu(cuda, tmp_path):
  """The validate CLI on a 128² ScarSeg-format tree (downscale 4: 16 mask
  lines, 6 of them drawn), the same seeded RecNet checkpoint on the card
  and on the CPU: --raw predictions within 5e-4 of max |target|
  (chip_smoke.py phase 6's f32 bar), the averaged PSNR within 0.01 dB and
  SSIM within 1e-4."""
  import glob
  import json
  import numpy as np
  from scipy.io import loadmat
  from csmri_refinement_tpu_torch import validate
  from csmri_refinement_tpu_torch.data import datasets
  from csmri_refinement_tpu_torch.training.runner import Runner
  from csmri_refinement_tpu_torch.utils import checkpoints
  from csmri_refinement_tpu_torch.utils.config import Configuration
  data_dir = str(tmp_path / 'data')
  datasets.write_scarseg_phantoms(data_dir, 128, 3, seed=1)
  with open(os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), 'configs', '1-recnet.json')) as f:
    conf_d = json.load(f)
  conf_d.update(downscale=4, model={'name': 'RecNet', 'num_blocks': 2,
                                    'num_convs': 2, 'num_filters': 16})
  conf_path = str(tmp_path / 'recnet.json')
  with open(conf_path, 'w') as f:
    json.dump(conf_d, f)
  conf = Configuration.from_json(conf_path)
  ckpt = str(tmp_path / 'recnet.ckpt')
  checkpoints.save_checkpoint(ckpt, conf, Runner(conf, 'test', 'cpu'), 1, {})
  results, records = {}, {}
  for device in ('cpu', 'cuda'):
    common = [conf_path, ckpt, '--data-dir', data_dir, '--device', device,
              '--out-dir', str(tmp_path / device)]
    results[device] = validate.main(common + ['-b', '6'])['ScarSeg'][
        'metrics']
    out = validate.main(common + ['--raw'])['ScarSeg']['output_dir']
    records[device] = {os.path.basename(p): loadmat(p)
                       for p in glob.glob(os.path.join(out, '*.mat'))}
  assert len(records['cuda']) == 18 and records['cuda'].keys() == \
      records['cpu'].keys()
  for name, want in records['cpu'].items():
    got = records['cuda'][name]
    bar = 5e-4 * np.abs(want['target']).max()
    assert np.abs(got['pred'] - want['pred']).max() <= bar, name
  assert abs(results['cuda']['psnr'] - results['cpu']['psnr']) <= 0.01
  assert abs(results['cuda']['ssim'] - results['cpu']['ssim']) <= 1e-4


# -- mixed-precision and memory-mode training ---------------------------------


@pytest.mark.parametrize('layer', range(len(SEG_LAYERS)))
def test_conv_layer_bf16_segmentation_layers_at_512(cuda, layer):
  """K2's bf16 route on each of the 18 eval-chain layers of a bf16
  segmentation U-Net (``train_dtype``) at a 512² input, B = 2: the stem
  (Cin 2, padded to 16) and the widths up to 512 from 512² down to 32²,
  within the bf16 bar (phase 4's of chip_smoke.py)."""
  side, cin, cout = SEG_LAYERS[layer]
  before = cc.conv_layer_f32_cuda.launches
  _conv_case(cuda, 3, cin, cout, 'reflection', torch.bfloat16,
             (2, 2 * side, 2 * side))
  assert cc.conv_layer_f32_cuda.launches == before


def _max_rel(got, want):
  """The largest max |Δ| / max |ref| over the float tensors of two state
  dicts."""
  return max((v - want[k]).abs().max().item() /
             max(want[k].abs().max().item(), 1e-30)
             for k, v in got.items() if v.is_floating_point())


@pytest.mark.parametrize('runner_type', ['standard', 'adversarial'])
def test_bf16_remat_updates_match_plain_on_card(cuda, runner_type):
  """Two bf16 updates with ``train_remat`` on the card against the same
  updates storing the forward, from the same weights, seeds and batches
  (the GAN narrow, its discriminator dropping out), under deterministic
  algorithms (cuDNN's convolutions; the model's reflect pads have a
  deterministic backward): every parameter and statistic within 1e-5 of
  its max |ref| (chip_smoke.py phase 20 (b))."""
  from csmri_refinement_tpu_torch.ops import undersample as us
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils.config import Configuration
  from csmri_refinement_tpu_torch.utils.diagnostics import runner_networks
  if runner_type == 'standard':
    conf_d = {'seed': 0, 'runner_type': 'standard',
              'application': 'reconstruction',
              'undersampling': {'sampling_scheme': 'varden',
                                'acceleration_factor': 8},
              'model': {'name': 'RecNet', 'num_blocks': 3, 'num_convs': 3,
                        'num_filters': 32},
              'loss_name': 'MSE',
              'optimizer': {'name': 'Adam', 'learning_rate': 2e-4}}
  else:
    conf_d = synthetic_refinement_conf(64, 8, 4, 4, narrow=True)
  gen = torch.Generator().manual_seed(2)
  batches = [us.undersample_batch(None, torch.rand(4, 64, 64, generator=gen)
                                  .to(cuda), fixed_mask=masks.cartesian_mask(
                                      gen, (4, 64, 64), 4).to(cuda))
             for _ in range(2)]
  states = []
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True
  try:
    for remat in (False, True):
      conf = Configuration.from_dict(dict(conf_d, train_dtype='bfloat16',
                                          train_remat=remat))
      runner = build_runner(conf, runner_type, 'train', cuda)
      for batch in batches:
        runner.train_batch(batch)
      states.append({name: {k: v.clone() for k, v in
                            net.state_dict().items()}
                     for name, net in runner_networks(runner).items()})
  finally:
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
  for name, want in states[0].items():
    assert _max_rel(states[1][name], want) <= 1e-5, name


# -- the data, sampling and metric options ------------------------------------


def _radial_recnet_conf(**overrides):
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf_d = {'seed': 0, 'runner_type': 'standard',
            'application': 'reconstruction',
            'undersampling': {'sampling_scheme': 'radial',
                              'acceleration_factor': 8},
            'model': {'name': 'RecNet', 'num_blocks': 3, 'num_convs': 3,
                      'num_filters': 32},
            'loss_name': 'MSE',
            'optimizer': {'name': 'Adam', 'learning_rate': 0.0002}}
  conf_d.update(overrides)
  return Configuration.from_dict(conf_d)


def test_radial_dc_launches_match_plain_on_card(cuda, monkeypatch):
  """Every K1 and K1-bwd launch of a radial 1-recnet step at 512², B = 4,
  against its plain version (2e-4 and 2e-3, tests/test_dc_pallas.py:26,46):
  radial masks are not line-structured, and the dense K1 takes them."""
  from csmri_refinement_tpu_torch.training.runner import Runner
  calls = {'K1': [], 'K1-bwd': []}
  dc, dc_bwd = dc_kernel.dc_cuda, dc_kernel.dc_bwd_cuda

  def k1(x, k0, mask):
    y = dc(x, k0, mask)
    calls['K1'].append((x, k0, mask, y))
    return y

  def k1_bwd(g, mask):
    y = dc_bwd(g, mask)
    calls['K1-bwd'].append((g, mask, y))
    return y
  # each wrapper counts through its module-level name
  k1.launches = k1_bwd.launches = 0
  monkeypatch.setattr(dc_kernel, 'dc_cuda', k1)
  monkeypatch.setattr(dc_kernel, 'dc_bwd_cuda', k1_bwd)
  runner = Runner(_radial_recnet_conf(), 'train', cuda)
  gt = torch.rand(4, 512, 512, generator=torch.Generator().manual_seed(1))
  batch = runner.preparer.prepare_train(
      torch.Generator(device=cuda).manual_seed(2), {'gt': gt.numpy()})
  mask = batch['mask'][..., 0]
  assert not bool((mask == mask[:, :, :1]).all())
  runner.train_batch(batch)
  torch.cuda.synchronize()
  assert len(calls['K1']) == len(calls['K1-bwd']) == 3
  for x, k0, m, y in calls['K1']:
    assert (y - dc_kernel.dc_plain(x, k0, m)).abs().max().item() <= 2e-4
  for g, m, y in calls['K1-bwd']:
    want = dc_kernel.dc_plain_vjp(g, m, False)[0]
    assert (y - want).abs().max().item() <= 2e-3


def test_native_loader_feeds_a_512_step_on_card(cuda, tmp_path):
  """native_pipeline on a 512² ScarSeg-format tree: the host library is
  built from the port's source, every training batch comes from it, and a
  radial 1-recnet step on the card takes it."""
  import numpy as np
  from csmri_refinement_tpu_torch.data import DataLoader, datasets, native
  from csmri_refinement_tpu_torch.data import load_dataset
  from csmri_refinement_tpu_torch.training.runner import Runner
  data_dir = str(tmp_path / 'data')
  datasets.write_scarseg_phantoms(data_dir, 512, 1, seed=3)
  conf = _radial_recnet_conf(
      native_pipeline=True, augmentation={'shift': 20, 'rotate': 10,
                                          'scale': [0.9, 1.1]})
  train_set = load_dataset(conf, data_dir, 'ScarSeg', 'train')
  assert os.path.exists(native.lib_path())
  batches = list(DataLoader(train_set, 8, shuffle=True, seed=0,
                            num_workers=2, prefetch=2))
  assert len(batches) == 3 and train_set._native_counter == 3
  for batch in batches:
    assert batch['gt'].shape == (8, 512, 512)
    np.testing.assert_allclose(np.abs(batch['gt']).max(axis=(1, 2)), 1.0,
                               rtol=1e-6)
  runner = Runner(conf, 'train', cuda)
  losses, out = runner.train_batch(runner.preparer.prepare_train(
      torch.Generator(device=cuda).manual_seed(0), batches[0]))
  assert out.is_cuda and bool(torch.isfinite(losses['loss']))


# -- the serving artifact's custom ops and data parallelism ------------------

def _same(got, want):
  return got.dtype == want.dtype and bool(torch.equal(got, want))


def test_custom_ops_equal_their_wrappers_on_card(cuda):
  """Each ``csmri::*`` op on a CUDA tensor runs its wrapper: the same
  kernel launch (bit-identical output) and one count on the wrapper."""
  gen = torch.Generator(device=cuda).manual_seed(21)
  x = torch.randn(2, 64, 64, 2, device=cuda, generator=gen)
  k0 = torch.randn(2, 64, 64, 2, device=cuda, generator=gen)
  m = (torch.rand(2, 64, 64, 1, device=cuda, generator=gen) > 0.5).float()
  before = dc_kernel.dc_cuda.launches
  assert _same(torch.ops.csmri.dc(x, k0, m), dc_kernel.dc_cuda(x, k0, m))
  assert dc_kernel.dc_cuda.launches == before + 2

  w = torch.randn(3, 3, 32, 48, device=cuda, generator=gen) * 0.1
  b = torch.randn(48, device=cuda, generator=gen)
  layer = cc.ChainLayer(w, b, 0.1)
  for dtype, op in ((torch.float32, torch.ops.csmri.conv_f32),
                    (torch.bfloat16, torch.ops.csmri.conv_bf16)):
    xi = torch.randn(2, 32, 32, 32, device=cuda, generator=gen).to(dtype)
    before = cc.conv_layer_cuda.launches
    assert _same(op(xi, w, b, 0.1, 'reflection'),
                 cc.conv_layer_cuda(xi, layer, 'reflection'))
    assert cc.conv_layer_cuda.launches == before + 2
  with pytest.raises(ValueError, match='takes torch.bfloat16'):
    torch.ops.csmri.conv_bf16(xi.float(), w, b, 0.1, 'reflection')

  qlayer = quantize.quantize_chain([layer])[0]
  xq, scale = quantize.quantize_act(
      torch.randn(2, 32, 32, 32, device=cuda, generator=gen))
  for want_amax in (True, False):
    before = cc.conv_layer_int8_cuda.launches
    got = torch.ops.csmri.conv_int8(xq, scale, qlayer.kernel, qlayer.w_scale,
                                    qlayer.bias, 0.1, 'zero', torch.float32,
                                    want_amax)
    want = cc.conv_layer_int8_cuda(xq, scale, qlayer, 'zero', torch.float32,
                                   want_amax)
    assert _same(got[0], want[0])
    assert _same(got[1], want[1]) if want_amax else got[1].numel() == 0
    assert cc.conv_layer_int8_cuda.launches == before + 2
  y, amax = want[0], got[0].abs().amax(dim=(1, 2, 3))
  before = cc.requant_cuda.launches
  for g, w_ in zip(torch.ops.csmri.requant(y, amax), cc.requant_cuda(y, amax)):
    assert _same(g, w_)
  assert cc.requant_cuda.launches == before + 2


def test_replayed_artifact_launches_k1_and_k2_f32_on_card(cuda, tmp_path):
  """The narrow 2-refinement generator exported on the card and replayed
  there: 3 K1 and 10 K2 f32 launches per replay, within 1e-6 of max |ref|
  of ``predict`` (the same kernels on the same weights)."""
  from csmri_refinement_tpu_torch.data import DataLoader, load_dataset
  from csmri_refinement_tpu_torch.profile_gan import (
      synthetic_refinement_conf)
  from csmri_refinement_tpu_torch.training import build_runner
  from csmri_refinement_tpu_torch.utils import export
  from csmri_refinement_tpu_torch.utils.config import Configuration
  conf = Configuration.from_dict(synthetic_refinement_conf(
      64, 2, 2, 2, narrow=True))
  runner = build_runner(conf, 'adversarial', 'test', cuda)
  host = next(iter(DataLoader(load_dataset(conf, None, 'Synthetic', 'val'),
                              2)))
  exported, header = export.export_predict(runner, host)
  path = str(tmp_path / 'gen.pt2')
  export.save_artifact(path, exported, header)
  call, _ = export.load_callable(path, 'cuda')
  batch = runner.preparer.prepare_val(host)
  want = runner.predict(batch)['pred']
  torch.cuda.synchronize()
  dc_kernel.dc_cuda.launches = 0
  cc.conv_layer_f32_cuda.launches = 0
  got = call(batch)['pred']
  torch.cuda.synchronize()
  assert dc_kernel.dc_cuda.launches == 3
  assert cc.conv_layer_f32_cuda.launches == 10
  assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6


def test_nccl_group_of_one_runs_a_synced_batchnorm_step(cuda):
  """A one-rank NCCL group from a ``distributed`` section: init, the
  synced BatchNorm path (forced, as a world of one keeps the local path)
  against the local one, the mesh it gives a runner, teardown."""
  import copy
  import socket
  import torch.distributed as dist
  from csmri_refinement_tpu_torch.models.unet import BatchNorm2d
  from csmri_refinement_tpu_torch.parallel import distributed
  from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
  from csmri_refinement_tpu_torch.utils.config import Configuration
  s = socket.socket()
  s.bind(('127.0.0.1', 0))
  port = s.getsockname()[1]
  s.close()
  conf = Configuration.from_dict({'distributed': {
      'coordinator_address': 'localhost:{}'.format(port),
      'num_processes': 1, 'process_id': 0}})
  try:
    device = distributed.initialize(conf, 'cuda')
    assert device.type == 'cuda' and dist.get_backend() == 'nccl'
    mesh = mesh_lib.mesh_from_conf(conf, device)
    assert (mesh.world, mesh.rank) == (1, 0) and mesh.group is not None
    local = BatchNorm2d(8).to(device)
    synced = copy.deepcopy(local)
    synced.process_group = mesh.group
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(4, 8, 16, 16, device=device, generator=gen) * 2 + 1
    c = torch.randn(4, 8, 16, 16, device=device, generator=gen)
    outs = []
    for bn in (local, synced):
      xi = x.clone().requires_grad_()
      y = bn(xi)
      (y * c).sum().backward()
      outs.append((y.detach(), xi.grad, bn.weight.grad, bn.running_var))
    torch.cuda.synchronize()
    for got, want in zip(outs[1], outs[0]):
      assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
  finally:
    distributed.shutdown()
  assert not dist.is_initialized()
