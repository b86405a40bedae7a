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
* K5's s8 product and K4's odd-pixel probe (``csrc/probes.cu``): the
  ``wgmma`` descriptors' layout fields (``probes/int8_prims.py::
  mma_descriptors``, ``probes/mosaic_prims.py::odd_pixel_descriptors``).
  The operands are staged as the kernel stores them (b transposed by the
  kernel's byte permutes) and read back at each element's shared-memory
  address as the descriptor maps it; the product must equal the plain
  version.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from csmri_refinement_tpu_torch.models import layers
from csmri_refinement_tpu_torch.ops import conv_chain as cc
from csmri_refinement_tpu_torch.ops import dc_kernel
from csmri_refinement_tpu_torch import probes
from csmri_refinement_tpu_torch.probes import int8_prims
from csmri_refinement_tpu_torch.probes import mosaic_prims

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


# --- K5 and K4: the probes' wgmma operand layouts --------------------------

PROBES_CU = os.path.join(os.path.dirname(probes.__file__), os.pardir, 'csrc',
                         'probes.cu')
MMA_N = 64     # csrc/probes.cu kMmaN: columns of y per block


def _descriptor_fields(desc):
  """(LBO, SBO, swizzle bytes) of a descriptor's layout fields."""
  modes = {v: k for k, v in probes.SWIZZLE_MODES.items()}
  return ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4, \
      modes[desc >> 62]


def _kmajor_address(start, desc, row, kbyte):
  """Shared-memory byte address of byte ``kbyte`` of K in row ``row`` (of M
  or N) of a K-major ``wgmma`` operand whose descriptor starts at byte
  ``start`` (on a 1024-aligned base for the swizzle): 8-row core matrices
  of 16 bytes a row. No swizzle: rows 16 bytes apart, the next 8 rows SBO
  on, the next 16 bytes of K LBO on. 128-byte swizzle: rows 128 bytes
  apart (a row holds 128 bytes of K), 8-row groups SBO apart, and the
  16-byte chunk bits (4-6) of the address XORed with its row bits (7-9)."""
  lbo, sbo, swizzle = _descriptor_fields(desc)
  if swizzle == 0:
    return (start + kbyte // 16 * lbo + row // 8 * sbo + row % 8 * 16 +
            kbyte % 16)
  addr = start + row // 8 * sbo + row % 8 * 128 + kbyte
  return addr ^ (((addr >> 7) & 7) << 4)


def _sw128(row, byte):
  """The s8 product's store rule: 16-byte chunk c of row r at chunk
  c ^ r % 8 of a 128-byte row (csrc/probes.cu::sw128)."""
  return row * 128 + (byte ^ ((row & 7) << 4))


def _byte_perm(x, y, sel):
  """CUDA's __byte_perm: result byte i is byte (sel >> 4 i) & 7 of the
  eight bytes of y:x."""
  both = x | y << 32
  return sum(((both >> (8 * ((sel >> (4 * i)) & 7))) & 255) << (8 * i)
             for i in range(4))


def _stage_b_block(b, n0):
  """b's columns n0 .. n0 + 63 as the kernel stores them: each thread
  (k4, nq) loads rows 4 k4 .. + 3, columns n0 + 16 nq .. + 15, transposes
  each 4 x 4 byte block with byte permutes and stores column n's 4 bytes
  of K as one word of K-major row n."""
  buf = np.zeros(MMA_N * 128, np.uint8)
  words = b.view(np.uint8).reshape(128, 32, 4).astype(np.int64)
  words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | \
      words[..., 3] << 24                              # (k, n / 4) words
  for tid in range(128):
    k4, nq = tid >> 2, tid & 3
    for j in range(4):
      x0, x1, x2, x3 = (int(words[4 * k4 + r, (n0 + 16 * nq) // 4 + j])
                        for r in range(4))
      t0, t1 = _byte_perm(x0, x1, 0x5140), _byte_perm(x0, x1, 0x7362)
      t2, t3 = _byte_perm(x2, x3, 0x5140), _byte_perm(x2, x3, 0x7362)
      cols = (_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
              _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632))
      for e, word in enumerate(cols):
        at = _sw128(16 * nq + 4 * j + e, 4 * k4)
        buf[at:at + 4] = np.frombuffer(word.to_bytes(4, 'little'), np.uint8)
  return buf


def _read_kmajor(buf, start, desc, rows):
  """A (rows, 128) s8 operand read from ``buf`` through a descriptor: the
  k32 step q starts 32 bytes on, as the kernel issues it."""
  r = np.arange(rows)[:, None]
  out = np.empty((rows, 128), np.int8)
  for q in range(4):
    kk = np.arange(32)[None]
    out[:, 32 * q:32 * q + 32] = buf[
        _kmajor_address(start + 32 * q, desc, r, kk)].view(np.int8)
  return out


@pytest.mark.parametrize('draw', ['probe', 'seed1', 'extremes'])
def test_s8_mma_layout_replay_matches_plain(draw):
  """Every 64 x 64 block of y: A's rows staged with the swizzle, b's
  columns transposed by byte permutes, both read through
  ``mma_descriptors``; the product equals ``_mm``."""
  data = int8_prims.probe_inputs('cpu')
  a, b = data['a'].numpy(), data['b'].numpy()
  if draw == 'seed1':
    rng = np.random.RandomState(1)
    a = rng.randint(-127, 128, a.shape).astype(np.int8)
    b = rng.randint(-127, 128, b.shape).astype(np.int8)
  elif draw == 'extremes':
    a, b = np.full_like(a, -127), np.full_like(b, 127)
  a_desc, b_desc = int8_prims.mma_descriptors()
  assert _descriptor_fields(a_desc) == (16, 1024, 128)
  want = int8_prims.plain('s8 x s8 -> s32 mma', torch.from_numpy(a),
                          torch.from_numpy(b)).numpy()
  got = np.empty_like(want)
  for m0 in range(0, a.shape[0], 64):
    sa = np.zeros(64 * 128, np.uint8)
    for i in range(512):          # 16-byte chunk i: row i / 8, chunk i % 8
      r, c = i >> 3, i & 7
      at = _sw128(r, 16 * c)
      sa[at:at + 16] = a[m0 + r, 16 * c:16 * c + 16].view(np.uint8)
    for n0 in range(0, 128, MMA_N):
      smem = np.concatenate([sa, _stage_b_block(b, n0)])
      a_tile = _read_kmajor(smem, 0, a_desc, 64)
      bt_tile = _read_kmajor(smem, 64 * 128, b_desc, MMA_N)
      got[m0:m0 + 64, n0:n0 + MMA_N] = \
          a_tile.astype(np.int64) @ bt_tile.astype(np.int64).T
  np.testing.assert_array_equal(got, want)
  if draw == 'extremes':
    assert (got == -128 * 127 * 127).all()


def _odd_pixel_replay(x):
  """Each block stages its tiles' pixels as two planes of 16-byte rows;
  tile t is read through the A descriptor at pixel 1 + 64 t, the identity
  through the B descriptor; D = A B in f32."""
  tiles = mosaic_prims.ODD_TILES
  plane = mosaic_prims.odd_pixel_plane()
  a_desc, b_desc = mosaic_prims.odd_pixel_descriptors()
  pix = x.reshape(-1, 16).float().numpy()
  bits = x.reshape(-1, 16).view(torch.int16).numpy().view(np.uint8)
  n_pix = pix.shape[0]
  eye = np.zeros(512, np.uint8)
  for n in range(16):
    for k in range(16):
      at = (k >> 3) * 256 + n * 16 + (k & 7) * 2
      eye[at:at + 2] = np.frombuffer(
          torch.tensor([float(k == n)], dtype=torch.bfloat16).view(
              torch.int16).numpy().tobytes(), np.uint8)
  out = np.zeros((n_pix - 16, 16), np.float32)
  m, k = np.arange(64)[:, None], np.arange(16)[None]
  bf16 = lambda b: torch.from_numpy(np.ascontiguousarray(b)).view(
      torch.bfloat16).float()[..., 0]
  for p0 in range(0, n_pix - 16, 64 * tiles):
    smem = np.zeros(2 * plane + 512, np.uint8)
    for p in range(plane // 16):
      if p0 + p < n_pix:
        for g in range(2):
          smem[g * plane + 16 * p:g * plane + 16 * p + 16] = \
              bits[p0 + p, 16 * g:16 * g + 16]
    smem[2 * plane:] = eye
    b_at = _kmajor_address(2 * plane, b_desc, np.arange(16)[:, None],
                                 2 * k)   # (n, k)
    b_mat = bf16(np.stack([smem[b_at], smem[b_at + 1]], -1)).numpy().T
    for t in range(tiles):
      at = _kmajor_address((1 + 64 * t) * 16, a_desc, m, 2 * k)
      a_mat = bf16(np.stack([smem[at], smem[at + 1]], -1)).numpy()
      o = p0 + 64 * t
      rows = min(64, n_pix - 16 - o)
      if rows > 0:
        out[o:o + rows] = (a_mat @ b_mat)[:rows]
  return out


@pytest.mark.parametrize('tile', ['probe', 'randn'])
def test_odd_pixel_layout_replay_matches_plain(tile):
  """K2's halo read at odd pixels: the planar staging read through
  ``odd_pixel_descriptors`` gives ``_odd_pixels`` exactly, the last tile's
  read one pixel past the tile coming from the zero fill."""
  name = 'wgmma bf16 A descriptor at odd pixel'
  shape = mosaic_prims.PROBES[name][1]
  x = mosaic_prims.probe_input(shape, 'cpu')
  if tile == 'randn':
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5)).to(
        torch.bfloat16)
  a_desc, b_desc = mosaic_prims.odd_pixel_descriptors()
  assert _descriptor_fields(a_desc) == (
      mosaic_prims.odd_pixel_plane(), 128, 0)
  assert _descriptor_fields(b_desc) == (256, 128, 0)
  want = mosaic_prims.plain(name, x).numpy()
  np.testing.assert_array_equal(_odd_pixel_replay(x), want)


def test_probe_descriptors_match_the_kernel_constants():
  """The host's layout constants are the ones compiled into probes.cu, and
  the s8 descriptor's fields are K2's swizzled B descriptor's."""
  with open(PROBES_CU) as f:
    src = f.read()
  const = lambda name: int(re.search(r'constexpr int {} = (\d+);'.format(
      name), src).group(1))
  assert const('kOddTiles') == mosaic_prims.ODD_TILES
  assert const('kMmaN') == MMA_N
  # csrc/conv_chain.cu::b_desc: LBO field 1, SBO 1024 >> 4, swizzle mode 1
  assert int8_prims.mma_descriptors()[0] == 1 << 16 | 64 << 32 | 1 << 62
  for d in (*int8_prims.mma_descriptors(),
            *mosaic_prims.odd_pixel_descriptors()):
    assert probes.descriptor(*_descriptor_fields(d)) == d
