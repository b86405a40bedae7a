"""Host-side layouts of the port's Hopper kernels, checked on the CPU.

The CUDA kernels run only on the card, but what they are built on is
decided on the host and can be replayed here:

* K1 (``csrc/dc.cu``): the mixed-radix plan of each line FFT and its
  inter-stage twiddle tables (``ops/dc_kernel.py::FFT_PLANS``,
  ``fft_tables``). The replay runs the kernel's Stockham stages in
  complex64, with the in-register radix-2 networks and their f32 roots,
  and must match ``torch.fft.fft`` for every side from 2 to 512 (1024 in
  ``tests/test_torch_port_dc_large.py``).
* K2 (``csrc/conv_chain.cu``): the bf16 route's K order and packed weights
  (``ops/conv_chain.py::gemm_layout``, ``pack_weights``). An implicit GEMM
  over the packed weights, in the kernel's K order, must equal
  ``conv_layer_plain``.
* K2's Cout padding (``pad_cout``): any Cout runs as a multiple of 16 with
  zero output channels, and the first Cout equal ``conv_layer_plain``.
* K3 (``csrc/conv_int8.cu``): the int8 K order and packed weights
  (``gemm_layout_int8``, ``pack_weights_int8``); the kernel's halo planes,
  swizzled weight stages and ``wgmma`` descriptors replayed address by
  address through its stage and chunk cursors, which must give the exact
  int32 sums of ``conv_layer_int8_plain`` (and must not with a mutated
  LBO, SBO or plane).
* K2's f32 route (``csrc/conv_f32.cu``): the TF32 split (``tf32_split``),
  the 3xTF32 sum's accuracy against a single TF32 pass, and the packed
  big and small weights (``pack_weights_f32``) with the kernel's halo
  positions and A-fragment rule replayed tile by tile, which must give
  ``conv_layer_plain`` (and must not with a mutated channel order or
  stage layout).
* K1's routes by shape, one per axis (``dc_route``), and the dense-DFT
  route's root table (the mixed-radix route's plans are replayed in
  ``tests/test_torch_port_dc_mixed.py``, the chirp and split routes in
  ``tests/test_torch_port_dc_any_side.py``).
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
  the rest 16. f32: Cin < 8 takes the direct route, the rest 3xTF32 (Cin
  not a multiple of 4 staged 4 bytes at a time)."""
  assert cc.conv_route(2, 32, torch.bfloat16) == 'wgmma, 4-byte staging'
  for cin in (32, 64, 128):
    assert cc.conv_route(cin, 32, torch.bfloat16) == 'wgmma'
  assert cc.conv_route(3, 16, torch.bfloat16) == 'wgmma, gathered halo'
  assert cc.conv_route(64, 64, torch.float32) == '3xtf32'
  for cin in (1, 2, 3, 5, 7):
    assert cc.conv_route(cin, 32, torch.float32) == 'direct'
  for cin in (9, 10, 30):
    assert cc.conv_route(cin, 16, torch.float32) == '3xtf32, 4-byte staging'


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
  # csrc/sm90.cuh::b_desc: LBO field 1, SBO 1024 >> 4, swizzle mode 1
  assert int8_prims.mma_descriptors()[0] == 1 << 16 | 64 << 32 | 1 << 62
  for d in (*int8_prims.mma_descriptors(),
            *mosaic_prims.odd_pixel_descriptors()):
    assert probes.descriptor(*_descriptor_fields(d)) == d


# --- K2: any Cout ---------------------------------------------------------


@pytest.mark.parametrize('k,cin,cout', [(4, 32, 8), (3, 16, 4), (4, 2, 1),
                                        (3, 48, 24), (4, 8, 2)])
def test_padded_cout_packing_matches_conv_layer_plain(k, cin, cout):
  """Cout padded to 16 by zero output channels: the packed operand has
  16-row granules, the padding rows are zero, and the implicit GEMM's first
  Cout channels equal the plain conv (the kernel writes all 16-granule
  channels, the padding ones zero, and the wrapper keeps the first Cout)."""
  gen = torch.Generator().manual_seed(cout)
  x = torch.randn(2, 7, 9, cin, generator=gen)
  kernel = torch.randn(k, k, cin, cout, generator=gen) / (k * cin) ** 0.5
  bias = torch.randn(cout, generator=gen)
  kpad, bpad = cc.pad_cout(kernel, bias)
  cout_pad = -(-cout // 16) * 16
  assert kpad.shape == (k, k, cin, cout_pad) and bpad.shape == (cout_pad,)
  assert not kpad[..., cout:].any() and not bpad[cout:].any()
  packed = cc.pack_weights(kpad, torch.float32)
  assert packed.shape[0] == cout_pad and not packed[cout:].any()
  full = layers.leaky_relu(_implicit_gemm(x, packed, k, cin, 'zero') + bpad,
                           0.1)
  assert not full[..., cout:].any()
  got = full[..., :cout]
  want = cc.conv_layer_plain(x, cc.ChainLayer(kernel, bias, 0.1), 'zero')
  assert (got - want).abs().max().item() <= 1e-4


# --- K3: the int8 kernel's operands ----------------------------------------

CSRC = os.path.join(os.path.dirname(cc.__file__), os.pardir, 'csrc')
K3_TILE_W = 64       # csrc/conv_int8.cu kTileW: output pixels per tile row
K3_K_STAGE = 128     # kKStage: K per weight stage, one 128-byte row
K3_INT8_CASES = [(4, 32, 32), (4, 32, 64), (4, 64, 128), (4, 128, 64),
                 (3, 32, 16), (3, 64, 32), (3, 96, 16), (3, 160, 16)]


def _k3_tile(k, cout):
  """(rows per warpgroup MT, N, halo plane bytes): N = Cout up to 128, MT 2
  for N = 128 and 4 below (``launch_n``); a plane holds the tile's (2 MT +
  k - 1) x (64 + k - 1) halo pixels, 16 bytes each, 128-byte aligned."""
  n = next(v for v in (128, 64, 32, 16) if cout % v == 0)
  mt = 2 if n == 128 else 4
  pix = (2 * mt + k - 1) * (K3_TILE_W + k - 1)
  return mt, n, -(-pix * 16 // 128) * 128


def _k3_descriptors(plane):
  """K3's (A, B) descriptor layout fields: A from the halo, K-major without
  swizzle, 8-pixel core matrices 128 bytes apart (SBO), the second 16
  channels of a k32 step one plane on (LBO); B K5's swizzled stage."""
  return probes.descriptor(plane, 128, 0), int8_prims.mma_descriptors()[1]


def _int8_layer(gen, k, cin, cout, leak=0.1):
  from csmri_refinement_tpu_torch.ops import quantize
  w = torch.randn(k, k, cin, cout, generator=gen)
  bias = torch.randn(cout, generator=gen) * 0.1
  return quantize.quantize_chain([cc.ChainLayer(w, bias, leak)])[0]


def _exact_sums(xi, layer, pad_mode):
  k = layer.kernel.shape[0]
  acc = F.conv2d(layers.same_pad(xi.double().permute(0, 3, 1, 2), k,
                                 pad_mode),
                 layer.kernel.double().permute(3, 2, 0, 1))
  return acc.permute(0, 2, 3, 1).numpy().astype(np.int64)


def _k3_replay(xi, layer, pad_mode, mutate=None):
  """K3's int32 sums, replayed through its shared-memory operands: per
  tile and halo chunk the planes as ``load_halo`` stages them, per stage
  the weight rows with the 128-byte swizzle as TMA stores them, and per
  k32 step the A and B tiles read at each element's address as the
  descriptors map it, the cursors (stage, chunk, K offset) advancing as the
  kernel's K loop does. ``mutate`` ('lbo', 'sbo' or 'plane') perturbs one
  layout field."""
  b, h, w, cin = xi.shape
  k, _, _, cout = layer.kernel.shape
  cin_pad, chunk, kp = cc.gemm_layout_int8(cin, k)
  mt, n_blk, plane = _k3_tile(k, cout)
  a_fields, b_fields = _k3_descriptors(plane)
  if mutate == 'lbo':
    a_fields = probes.descriptor(plane + 16, 128, 0)
  elif mutate == 'sbo':
    a_fields = probes.descriptor(plane, 256, 0)
  stride = plane + 128 if mutate == 'plane' else plane
  packed = cc.pack_weights_int8(layer.kernel).numpy().view(np.uint8)
  assert packed.shape == (cout, kp)
  planes, hw, hh = chunk // 16, K3_TILE_W + k - 1, 2 * mt + k - 1
  rows = 2 * mt
  tiles_h, tiles_w = -(-h // rows), -(-w // K3_TILE_W)
  # the SAME-padded input with zero channels past Cin; positions beyond
  # it feed only outputs outside the image (zeros here)
  xp = layers.same_pad(xi.double().permute(0, 3, 1, 2), k, pad_mode)
  xp = xp.permute(0, 2, 3, 1).numpy().astype(np.int8)
  ext = np.zeros((b, tiles_h * rows + k, tiles_w * K3_TILE_W + k, cin_pad),
                 np.int8)
  ext[:, :h + k - 1, :w + k - 1, :cin] = xp
  ktot, span, stages = k * k * cin_pad, k * k * chunk, kp // K3_K_STAGE
  out = np.zeros((b, tiles_h * rows, tiles_w * K3_TILE_W, cout), np.int64)
  m, kk = np.arange(64)[:, None], np.arange(32)[None]
  nn = np.arange(n_blk)[:, None]
  for img in range(b):
    for ty in range(tiles_h):
      for tx in range(tiles_w):
        for n0 in range(0, cout, n_blk):
          oy0, ox0 = ty * rows, tx * K3_TILE_W
          acc = np.zeros((2, mt, 64, n_blk), np.int64)
          rem = c = 0
          for s in range(stages):
            if rem == 0:       # load_halo(c): plane j, pixel p at j P + 16 p
              halo = np.zeros(planes * stride, np.uint8)
              src = ext[img, oy0:oy0 + hh, ox0:ox0 + hw,
                        c * chunk:(c + 1) * chunk].view(np.uint8)
              src = src.reshape(hh * hw, planes, 16)
              for j in range(planes):
                halo[j * stride:j * stride + hh * hw * 16] = \
                    src[:, j].reshape(-1)
            stage = np.zeros(n_blk * 128, np.uint8)   # TMA, 128-byte swizzle
            rows_w = packed[n0:n0 + n_blk, s * 128:(s + 1) * 128]
            for r in range(n_blk):
              for ch in range(8):
                at = r * 128 + 16 * (ch ^ (r % 8))
                stage[at:at + 16] = rows_w[r, 16 * ch:16 * ch + 16]
            for q in range(min(4, (ktot - s * K3_K_STAGE) // 32)):
              rq = rem + 32 * q
              tap, j = rq // chunk, (rq % chunk) // 16
              dy, dx = divmod(tap, k)
              bt = stage[_kmajor_address(32 * q, b_fields, nn, kk)]
              for wg in range(2):
                for r in range(mt):
                  start = j * stride + 16 * ((wg * mt + r + dy) * hw + dx)
                  at = _kmajor_address(start, a_fields, m, kk)
                  at = np.where(at < halo.size, at, 0)
                  a_t = halo[at].view(np.int8).astype(np.int64)
                  acc[wg, r] += a_t @ bt.view(np.int8).astype(np.int64).T
            rem += K3_K_STAGE
            if rem >= span:
              rem, c = 0, c + 1
          out[img, oy0:oy0 + rows, ox0:ox0 + 64, n0:n0 + n_blk] = \
              acc.reshape(rows, 64, n_blk)
  return out[:, :h, :w]


@pytest.mark.parametrize('pad_mode', ['reflection', 'zero'])
@pytest.mark.parametrize('k,cin,cout', K3_INT8_CASES)
def test_k3_operand_replay_matches_conv_layer_int8_plain(k, cin, cout,
                                                         pad_mode):
  """The packed int8 weights and the halo read through the kernel's
  descriptors give the exact sums; through the kernel's epilogue they are
  ``conv_layer_int8_plain`` bit for bit. Two column tiles and a partial
  row tile (5 x 70)."""
  gen = torch.Generator().manual_seed(k * cin + cout)
  xi = torch.randint(-127, 128, (1, 5, 70, cin), generator=gen,
                     dtype=torch.int8)
  layer = _int8_layer(gen, k, cin, cout)
  cin_pad, chunk, kp = cc.gemm_layout_int8(cin, k)
  assert kp % 128 == 0 and cin_pad % chunk == 0
  assert (k * k * chunk) % 128 == 0 or cin_pad == chunk
  sums = _k3_replay(xi, layer, pad_mode)
  np.testing.assert_array_equal(sums, _exact_sums(xi, layer, pad_mode))
  scale = torch.tensor([0.0123])
  got = cc._epilogue(torch.from_numpy(sums).double(), scale, layer)
  want, _ = cc.conv_layer_int8_plain(xi, scale, layer, pad_mode)
  assert torch.equal(got, want)


@pytest.mark.parametrize('mutate', ['lbo', 'sbo', 'plane'])
def test_k3_operand_replay_fails_with_a_mutated_layout(mutate):
  gen = torch.Generator().manual_seed(3)
  xi = torch.randint(-127, 128, (1, 5, 70, 64), generator=gen,
                     dtype=torch.int8)
  layer = _int8_layer(gen, 4, 64, 32)
  sums = _k3_replay(xi, layer, 'reflection', mutate)
  assert not np.array_equal(sums, _exact_sums(xi, layer, 'reflection'))


def test_k3_layout_constants_match_the_kernel():
  """The replay's constants are the ones compiled into conv_int8.cu and
  the descriptors it takes from sm90.cuh (shared with K2): A without
  swizzle, SBO 128; B K5's, 128-byte swizzle, SBO 1024."""
  src = ''
  for name in ('conv_int8.cu', 'sm90.cuh'):
    with open(os.path.join(CSRC, name)) as f:
      src += f.read()
  const = lambda name: int(re.search(r'constexpr int {} = (\d+);'.format(
      name), src).group(1))
  assert const('kTileW') == K3_TILE_W and const('kKStage') == K3_K_STAGE
  assert 'static constexpr int kPlane = (kPix * 16 + 127) / 128 * 128;' in src
  assert 'launch<K, 128, 2>' in src and 'launch<K, 64, 4>' in src
  assert '((uint64_t)(128 >> 4) << 32)' in src      # a_desc SBO
  assert '((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62)' in src
  _, _, plane = _k3_tile(4, 32)
  a_fields, b_fields = _k3_descriptors(plane)
  assert _descriptor_fields(a_fields) == (plane, 128, 0)
  assert _descriptor_fields(b_fields) == (16, 1024, 128)


def test_pack_weights_int8_layout():
  """K-major (Cout, kp) int8 rows in the order (chunk, tap, channel in
  chunk), zeros past Cin and past k*k*Cin_pad."""
  gen = torch.Generator().manual_seed(0)
  layer = _int8_layer(gen, 3, 96, 16)
  packed = cc.pack_weights_int8(layer.kernel)
  cin_pad, chunk, kp = cc.gemm_layout_int8(96, 3)
  assert (cin_pad, chunk, kp) == (128, 128, 1152)
  assert packed.dtype == torch.int8 and packed.shape == (16, 1152)
  w = layer.kernel
  for tap in range(9):
    dy, dx = divmod(tap, 3)
    assert torch.equal(packed[:, tap * 128:tap * 128 + 96],
                       w[dy, dx].t())
    assert not packed[:, tap * 128 + 96:(tap + 1) * 128].any()
  assert cc.gemm_layout_int8(32, 3) == (32, 32, 384)
  assert cc.gemm_layout_int8(64, 4) == (64, 32, 1024)
  assert cc.gemm_layout_int8(160, 3) == (256, 128, 2304)


# --- K2's f32 route: 3xTF32 ----------------------------------------------

F32_K_STAGE = 32     # csrc/conv_f32.cu kKStage: K per stage, 128 bytes
F32_SEG_W = 64       # kSegW: widest column segment
F32_POS_BYTES = 64   # kPosBytes: 16 f32 channels of a halo position


def test_tf32_split_bits():
  """big has its low 13 bits clear and is v rounded to nearest (ties away
  from zero); big + small is within 2^-22 of |v|, big alone within
  2^-11."""
  gen = torch.Generator().manual_seed(0)
  v = torch.cat([torch.randn(4096, generator=gen) * 10 ** torch.randint(
      -6, 6, (4096,), generator=gen).float(),
                 torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12,
                               0.0, -0.0, 3.0e38])])
  big, small = cc.tf32_split(v)
  for part in (big, small):
    assert not (part.view(torch.int32) & 0x1FFF).any()
  err = (big.double() + small.double() - v.double()).abs()
  assert (err <= 2.0 ** -22 * v.double().abs()).all()
  assert ((big.double() - v.double()).abs() <=
          2.0 ** -11 * v.double().abs()).all()
  # ties round away from zero, others to nearest
  assert big[-6].item() == 1 + 2 ** -10 and big[-5].item() == -(1 + 2 ** -10)
  assert big[-4].item() == 1 + 2 ** -10


def _f32_deep_layer(gen, cin, cout):
  x = layers.leaky_relu(torch.randn(1, 8, 8, cin, generator=gen), 0.2)
  w = torch.randn(3, 3, cin, cout, generator=gen) * (2.0 / (9 * cin)) ** 0.5
  return x, cc.ChainLayer(w, torch.randn(cout, generator=gen) * 0.1, 0.2)


def _split_conv(x, layer, terms):
  """The layer with its products split as ``terms`` lists ((A part, B
  part), ...), each product summed in float64."""
  xs, ws = cc.tf32_split(x), cc.tf32_split(layer.kernel)
  xp = lambda i: layers.same_pad(xs[i].double().permute(0, 3, 1, 2), 3,
                                 'reflection')
  y = sum(F.conv2d(xp(i), ws[j].double().permute(3, 2, 0, 1))
          for i, j in terms)
  y = layers.leaky_relu(y + layer.bias.double()[:, None, None],
                        layer.leakiness)
  return y.permute(0, 2, 3, 1)


def test_3xtf32_keeps_f32_accuracy_at_cin_512():
  """A k3 layer at Cin 512 (the deepest segmentation layers): the three
  split products agree with the f32 ``conv_layer_plain`` within 1e-5 of
  max(1, max |ref|); one TF32 product does not."""
  x, layer = _f32_deep_layer(torch.Generator().manual_seed(1), 512, 64)
  want = cc.conv_layer_plain(x, layer).double()
  bar = 1e-5 * max(1.0, want.abs().max().item())
  three = _split_conv(x, layer, ((1, 0), (0, 1), (0, 0)))
  one = _split_conv(x, layer, ((0, 0),))
  assert (three - want).abs().max().item() <= bar
  assert (one - want).abs().max().item() > 10 * bar


def _pad_index(i, n, mode):
  """csrc/sm90.cuh::pad_index on arrays: the source index of padded
  position i, or -1 for a zero."""
  i = np.asarray(i)
  if mode == 'zero':
    return np.where((i >= 0) & (i < n), i, -1)
  if mode == 'reflection':
    i = np.where(i < 0, -i, np.where(i >= n, 2 * (n - 1) - i, i))
  return np.clip(i, 0, n - 1)


def _stage_rows(rows):
  """A (R, 32) f32 block of packed rows as TMA stores it: 128-byte rows,
  16-byte chunk c of row r at chunk c ^ r % 8."""
  raw = np.ascontiguousarray(rows, np.float32).view(np.uint8)
  out = np.zeros(raw.size, np.uint8)
  for r in range(rows.shape[0]):
    for ch in range(8):
      at = r * 128 + 16 * (ch ^ (r % 8))
      out[at:at + 16] = raw[r, 16 * ch:16 * ch + 16]
  return out


def _f32_replay(x, layer, pad_mode, mt, n_blk, mutate=None):
  """K2's f32 route replayed tile by tile as csrc/conv_f32.cu walks it:
  column segments of TW = min(W, 64) columns at pitch HW = TW + k - 1;
  tiles of 128 MT flattened positions; per chunk the halo positions q0 + p
  staged through ``pad_index``; per stage the big and small weight rows of
  ``pack_weights_f32`` stored as TMA does and read through the B
  descriptor at each k8 step; A gathered by the kernel's fragment rule
  (channel 4 t + 2 s + h at column t + 4 h of k8 step s); the three
  products summed in float64, then the epilogue. ``mutate``: 'perm' (the
  rule with s and h swapped) or 'sbo' (a B descriptor with SBO 512)."""
  b, h, w, cin = x.shape
  k, _, _, cout = layer.kernel.shape
  pad_t = (k - 1) // 2
  cin_pad, chunk, kp = cc.gemm_layout_f32(cin, k)
  packed = cc.pack_weights_f32(layer.kernel).numpy()
  assert packed.shape == (2 * cout, kp)
  big_w, small_w = packed[:cout], packed[cout:]
  b_fields = probes.descriptor(16, 512 if mutate == 'sbo' else 1024, 128)
  tw = min(w, F32_SEG_W)
  hw, segs = tw + k - 1, -(-w // tw)
  m_pos = 128 * mt
  npos = m_pos + (k - 1) * hw + (k - 1)
  tiles = -(-(h * hw) // m_pos)
  span, stages, ktot = k * k * chunk, kp // F32_K_STAGE, k * k * cin_pad
  xs = [np.asarray(p.numpy(), np.float64) for p in cc.tf32_split(x)]
  col = np.arange(8)
  t4, hh = col % 4, col // 4
  nn, kk = np.arange(n_blk)[:, None], 4 * np.arange(8)[None]
  out = np.zeros((b, h, w, cout))
  for img in range(b):
    for seg in range(segs):
      x0 = seg * tw
      for tile in range(tiles):
        gq = tile * m_pos + np.arange(npos)
        sy = _pad_index(gq // hw - pad_t, h, pad_mode)
        sx = _pad_index(x0 + gq % hw - pad_t, w, pad_mode)
        inside = (sy >= 0) & (sx >= 0)
        for n0 in range(0, cout, n_blk):
          acc = np.zeros((m_pos, n_blk))
          rem = c = 0
          for s in range(stages):
            if rem == 0:        # load_halo: zeros outside and past Cin
              halo = []
              for part in xs:
                hv = np.zeros((npos, chunk))
                lo, hi = c * chunk, min(cin, (c + 1) * chunk)
                hv[inside, :hi - lo] = part[img, sy[inside], sx[inside],
                                            lo:hi]
                halo.append(hv)
            sl = slice(s * F32_K_STAGE, (s + 1) * F32_K_STAGE)
            stage = [_stage_rows(big_w[n0:n0 + n_blk, sl]),
                     _stage_rows(small_w[n0:n0 + n_blk, sl])]
            for q in range(min(4, (ktot - s * F32_K_STAGE) // 8)):
              rq = rem + 8 * q
              tap, j = rq // chunk, (rq % chunk) // 16
              st = (rq % 16) // 8
              dy, dx = divmod(tap, k)
              ch = 16 * j + (4 * t4 + st + 2 * hh if mutate == 'perm' else
                             4 * t4 + 2 * st + hh)
              pos = np.arange(m_pos)[:, None] + dy * hw + dx
              a_big, a_small = (hv[pos, ch[None]] for hv in halo)
              at = _kmajor_address(32 * (q % 4), b_fields, nn, kk)
              at = at[..., None] + np.arange(4)
              b_big, b_small = (
                  np.asarray(sg[at].view(np.float32)[..., 0], np.float64)
                  for sg in stage)
              acc += a_small @ b_big.T + a_big @ b_small.T + a_big @ b_big.T
            rem += F32_K_STAGE
            if rem >= span:
              rem, c = 0, c + 1
          q = tile * m_pos + np.arange(m_pos)
          oy, ox = q // hw, q % hw
          ok = (oy < h) & (ox < tw) & (x0 + ox < w)
          out[img, oy[ok], x0 + ox[ok], n0:n0 + n_blk] = acc[ok]
  y = torch.from_numpy(out) + layer.bias.double()
  return y if layer.leakiness is None else layers.leaky_relu(y,
                                                             layer.leakiness)


F32_CASES = [(3, 40, 16, 5, 70), (4, 20, 32, 5, 19), (3, 8, 16, 9, 7),
             (3, 12, 32, 3, 16), (4, 64, 16, 3, 9)]


@pytest.mark.parametrize('mt', [1, 2])
@pytest.mark.parametrize('pad_mode', ['reflection', 'replication', 'zero'])
@pytest.mark.parametrize('k,cin,cout,h,w', F32_CASES)
def test_f32_operand_replay_matches_conv_layer_plain(k, cin, cout, h, w,
                                                     pad_mode, mt):
  """Two 32-channel chunks, two column segments (one partial) and positions
  across rows (5 x 70, k3); two 16-channel k4 chunks at a 19-wide image;
  a single chunk with a partial last stage (Cin 8, k3: 144 of K); Cin 12
  with zero channels; a tile taller than the image. Within 1e-5 of
  max(1, max |ref|) of the f32 plain version."""
  gen = torch.Generator().manual_seed(k * cin + cout)
  x = torch.randn(1, h, w, cin, generator=gen)
  w_ = torch.randn(k, k, cin, cout, generator=gen) * (2.0 / (k * k * cin)) ** .5
  layer = cc.ChainLayer(w_, torch.randn(cout, generator=gen), 0.1)
  want = cc.conv_layer_plain(x, layer, pad_mode).double()
  got = _f32_replay(x, layer, pad_mode, mt, 16)
  assert (got - want).abs().max().item() <= 1e-5 * max(
      1.0, want.abs().max().item())


@pytest.mark.parametrize('mutate', ['perm', 'sbo'])
def test_f32_operand_replay_fails_with_a_mutated_layout(mutate):
  gen = torch.Generator().manual_seed(5)
  x = torch.randn(1, 4, 12, 32, generator=gen)
  layer = cc.ChainLayer(torch.randn(3, 3, 32, 16, generator=gen) * 0.1,
                        torch.zeros(16), None)
  want = cc.conv_layer_plain(x, layer, 'zero').double()
  got = _f32_replay(x, layer, 'zero', 1, 16, mutate)
  assert (got - want).abs().max().item() > 1e-3


def test_pack_weights_f32_layout():
  """(2 Cout, kp) f32 rows: the big parts, then the small parts (low 13
  bits clear), in the order (chunk, tap, 16 channels in F32_PERM order);
  big + small = the weights within 2^-22, zeros past Cin and past
  k·k·Cin_pad."""
  assert sorted(cc.F32_PERM) == list(range(16))
  assert cc.F32_PERM[:8] == (0, 4, 8, 12, 1, 5, 9, 13)
  gen = torch.Generator().manual_seed(0)
  kernel = torch.randn(3, 3, 40, 16, generator=gen)
  packed = cc.pack_weights_f32(kernel)
  cin_pad, chunk, kp = cc.gemm_layout_f32(40, 3)
  assert (cin_pad, chunk, kp) == (64, 32, 576)
  assert packed.dtype == torch.float32 and packed.shape == (32, 576)
  assert not (packed.view(torch.int32) & 0x1FFF).any()
  big, small = packed[:16].double(), packed[16:].double()
  perm = torch.tensor(cc.F32_PERM)
  padded = F.pad(kernel, (0, 0, 0, 24)).double()
  for c in range(2):
    for tap in range(9):
      dy, dx = divmod(tap, 3)
      for j in range(2):
        at = c * 288 + tap * 32 + 16 * j
        want = padded[dy, dx][c * 32 + 16 * j + perm].t()
        got = big[:, at:at + 16] + small[:, at:at + 16]
        assert ((got - want).abs() <= 2.0 ** -22 * want.abs()).all()
  assert cc.gemm_layout_f32(8, 3) == (16, 16, 160)
  assert not cc.pack_weights_f32(kernel[:, :, :8])[:, 144:].any()
  assert cc.gemm_layout_f32(32, 4) == (32, 16, 512)
  assert cc.gemm_layout_f32(512, 3) == (512, 32, 4608)


def test_f32_layout_constants_match_the_kernel():
  """The replay's constants are the ones compiled into conv_f32.cu; its B
  descriptor is sm90.cuh's (128-byte swizzle, SBO 1024)."""
  src = ''
  for name in ('conv_f32.cu', 'sm90.cuh'):
    with open(os.path.join(CSRC, name)) as f:
      src += f.read()
  const = lambda name: int(re.search(r'constexpr int {} = (\d+);'.format(
      name), src).group(1))
  assert const('kKStage') == F32_K_STAGE and const('kSegW') == F32_SEG_W
  assert const('kPosBytes') == F32_POS_BYTES
  assert 'return 128 * mt + (k - 1) * hw + (k - 1);' in src
  assert 'split4(lo.x, hi.x, lo.y, hi.y, big[mt][0], small[mt][0]);' in src
  assert 'split4(lo.z, hi.z, lo.w, hi.w, big[mt][1], small[mt][1]);' in src
  assert 'constexpr int kPromote = 4;' in src
  assert '((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62)' in src
  assert 'const int cc = (cin <= 16 || k == 4) ? 16 : 32;' in src


# --- K1: the route by shape and the dense-DFT roots ------------------------


def test_dc_route_by_shape():
  """One route per axis, ``(route of H, route of W)``: powers of two on
  the radix plans, other sides whose prime factors are at most 13 on the
  mixed-radix plans (``tests/test_torch_port_dc_mixed.py``), sides with a
  larger prime factor on dense DFT lines up to ``DENSE_MAX`` and on the
  chirp route above; a power-of-two H keeps the radix route only beside a
  power-of-two W, and takes the mixed-radix route beside any other. Every
  side from 2 has a route (``tests/test_torch_port_dc_any_side.py``), a
  side of 1 none."""
  assert dc_kernel.dc_route(256, 256) == ('fft', 'fft')
  assert all(dc_kernel.dc_route(n, n) == ('fft', 'fft') for n in SIDES)
  for n in (3, 5, 100, 192, 240, 320, 384):
    assert dc_kernel.dc_route(n, n) == ('mixed', 'mixed')
  for n in (17, 31, 61, 79):
    assert dc_kernel.dc_route(n, n) == ('dft', 'dft')
  for n in (89, 127, 237, 244, 509, 511):
    assert dc_kernel.dc_route(n, n) == ('chirp', 'chirp')
  for h, w, want in ((256, 192, ('mixed', 'mixed')),
                     (256, 240, ('mixed', 'mixed')),
                     (512, 240, ('mixed', 'mixed')),
                     (256, 244, ('mixed', 'chirp')),
                     (192, 256, ('mixed', 'fft')),
                     (256, 128, ('fft', 'fft')), (2, 512, ('fft', 'fft')),
                     (240, 237, ('mixed', 'chirp')),
                     (16, 15, ('mixed', 'mixed')),
                     (128, 24, ('mixed', 'mixed')),
                     (512, 320, ('mixed', 'mixed')),
                     (1024, 1024, ('fft', 'fft')),
                     (256, 513, ('mixed', 'chirp')),
                     (64, 17, ('mixed', 'dft')),
                     (1025, 1025, ('chirp', 'chirp')),
                     (256, 1025, ('mixed', 'chirp')),
                     (16, 2048, ('fft', 'split'))):
    assert dc_kernel.dc_route(h, w) == want
  for h, w in ((1, 1), (1, 256), (256, 1)):
    assert dc_kernel.dc_route(h, w) is None


@pytest.mark.parametrize('n', [3, 192, 320, 384, 17, 237, 509])
def test_dft_table_lines_match_torch_fft(n):
  """A line through the dense-DFT route: out(k) = sum_j x(j) w[(j k) mod
  n] with the f32 roots, forward and inverse, against ``torch.fft``."""
  rng = np.random.default_rng(n)
  x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
      np.complex64)
  table = dc_kernel.dft_table(n)
  w = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
  idx = np.outer(np.arange(n), np.arange(n)) % n
  t = torch.from_numpy(x.astype(np.complex128))
  for inverse in (False, True):
    mat = np.conj(w[idx]) if inverse else w[idx]
    got = (mat @ x) / np.sqrt(n)
    want = (torch.fft.ifft if inverse else torch.fft.fft)(t, norm='ortho')
    assert np.abs(got - want.numpy()).max() <= 2e-5


@pytest.mark.parametrize('h,w', [(6, 10), (24, 20)])
def test_dense_dft_dc_replay_matches_plain(h, w):
  """The dense-DFT route's DC on a non-square image, replayed with its two
  root tables (rows by the w roots, columns by the h roots, each scaled by
  1/sqrt(n)), against ``dc_plain``."""
  rng = np.random.default_rng(h * w)
  x = rng.standard_normal((2, h, w, 2)).astype(np.float32)
  k0 = rng.standard_normal((2, h, w, 2)).astype(np.float32)
  m = (rng.random((2, h, w, 1)) > 0.5).astype(np.float32)

  def mat(n, inverse):
    t = dc_kernel.dft_table(n).astype(np.float64)
    r = (t[:, 0] + 1j * t[:, 1])[np.outer(np.arange(n), np.arange(n)) % n]
    return (np.conj(r) if inverse else r) / np.sqrt(n)

  xc = x[..., 0] + 1j * x[..., 1]
  k = mat(h, False) @ xc @ mat(w, False).T
  k = (1 - m[..., 0]) * k + (k0[..., 0] + 1j * k0[..., 1])
  y = mat(h, True) @ k @ mat(w, True).T
  want = dc_kernel.dc_plain(*(torch.from_numpy(a) for a in (x, k0, m)))
  got = np.stack([y.real, y.imag], axis=-1)
  assert np.abs(got - want.numpy()).max() <= 2e-5


def test_dc_fused_takes_torch_fft_for_non_square_images():
  """On the CPU, non-square images run the plain ``torch.fft`` composition
  (no kernel, no count) and stay differentiable."""
  gen = torch.Generator().manual_seed(0)
  x = torch.randn(2, 8, 6, 2, generator=gen, requires_grad=True)
  k0 = torch.randn(2, 8, 6, 2, generator=gen)
  m = (torch.rand(2, 8, 6, 1, generator=gen) > 0.5).float()
  before = dc_kernel.dc_cuda.launches
  y = dc_kernel.dc_fused(x, k0, m)
  assert torch.allclose(y, dc_kernel.dc_plain(x, k0, m))
  y.sum().backward()
  assert x.grad is not None and dc_kernel.dc_cuda.launches == before
