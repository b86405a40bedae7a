"""Fused k-space data consistency: the CUDA kernel and its plain version.

Port of the TPU kernel ``csmri_refinement_tpu/ops/dc_pallas.py``
(``_dc_kernel``, wrapper ``dc_pallas``):

    y = F⁻¹((1 − m)·F x + k0)        F = ortho, unshifted 2D DFT

on packed ``(B, H, W, 2)`` float32 images, ``(B, H, W, 1)`` float32 masks.

* ``dc_plain`` — the plain PyTorch version: ``torch.fft`` fft2 → merge →
  ifft2 in f32. The CPU path and the oracle the kernel is held against.
* ``dc_cuda`` — the wrapper of ``csrc/dc.cu``: checks its inputs, allocates
  the output and the k-space scratch, launches on the current stream and
  counts its calls in ``dc_cuda.launches`` (one per DC, whatever the number
  of CUDA launches inside).
* ``dc_plain_vjp`` / ``dc_bwd_cuda`` — the backward (K1-bwd), the Hermitian
  VJP of the JAX package's ``ops/dc.py:99-111`` ``_dc_fused_bwd``:
  ``grad_x = DC(g, 0, m)``, ``grad_k0 = fft2(g)``. ``dc_bwd_cuda`` runs
  ``grad_x`` on the same kernel in its no-k0 mode (a null k0 is zero) and
  counts in ``dc_bwd_cuda.launches``.
* ``_DCFunction`` — the ``torch.autograd.Function``: forward K1, backward
  K1-bwd; ``grad_k0`` only when k0 needs it, by ``torch.fft.fft2`` (the JAX
  package computes it outside Pallas too); the mask gets none.
* ``dc_op`` — K1 as the custom op ``csmri::dc`` (``torch.library``): its
  CPU implementation is ``dc_plain``, its CUDA one ``dc_cuda`` (looked up
  by its module-level name at each call, so the launch count and a
  recording replacement see every launch); a fake implementation gives
  ``torch.export`` its shape, so that a serving artifact's graph holds the
  kernel (``utils/export.py``).
* ``dc_fused`` — the device dispatch: where a gradient is needed, a CPU
  tensor takes ``dc_plain`` (autodiffed ``torch.fft``) and a CUDA tensor
  ``_DCFunction``; elsewhere (evaluation, a frozen network) the custom op.
* ``dc_rows_fft_cuda``, ``dc_cols_cuda``, ``dc_rows_ifft_cuda`` — K1's
  three passes one at a time (``csrc/dc.cu``'s ``dc_rows_pass`` and
  ``dc_cols_pass``, the launches ``dc_forward`` makes): the forward FFT
  along W of a block of rows, the column pass (FFT along H, merge, inverse
  FFT along H) on a block of whole columns, and the inverse FFT along W.
  Each runs the kernel, plan, twiddles and scale of that pass inside
  ``dc_cuda``, so a line's result is the same bits.
  ``dc_bwd_rows_fft_cuda``, ``dc_bwd_cols_cuda`` (no k0) and
  ``dc_bwd_rows_ifft_cuda`` are the same launches for K1-bwd. Each counts its own launches. Their plain versions
  (``dc_rows_fft_plain``, ``dc_cols_plain``, ``dc_rows_ifft_plain``) are
  per-axis ``torch.fft`` with ``norm='ortho'``; ``dc_plain`` and
  ``dc_plain_vjp`` are their composition. The forward passes are the custom
  ops ``csmri::dc_rows_fft``, ``csmri::dc_cols`` and ``csmri::dc_rows_ifft``,
  as K1 is ``csmri::dc``.
* ``dc_distributed`` — the DC of a spatial mesh's rank (``parallel/halo.py``):
  x holds the rank's H/S image rows, k0 and mask all H rows of its column
  block (``parallel/mesh.py::col_bounds``: W/S columns, one more on the
  first W mod S ranks, so S need not divide W). Pass 1 on the rank's rows,
  ``halo.rows_to_cols`` (one all-to-all over the spatial group), pass 2 on
  the rank's columns with its k0 and mask columns, ``halo.cols_to_rows``,
  pass 3: every line is transformed once in the group, and each rank's
  output is its rows of the whole image's DC, bit for bit. Each rank sends
  2(S − 1)/S² of an image per DC (its blocks' share, where they differ). The backward (``_DistributedDCFunction``)
  is the same pipeline on the gradient with a null k0 (K1-bwd's
  ``DC(g, 0, m)``), so no autograd runs through the collectives;
  ``grad_k0``, where k0 needs one, is the FFT along H of the exchanged
  gradient: the rank's columns of ``fft2`` of the whole image's gradient.
  The noisy DC (``ops/dc.py``) runs the same pipeline on the plain passes,
  autodiffed through the exchanges.

The kernel takes images of any side from 2 up, square or not, with one
route per axis (``dc_route``; passes 1 and 3 take W's, pass 2 H's): powers
of two to 1024 by the radix plans compiled per side (``FFT_PLANS``), the
other sides to 1024 whose prime factors are at most 13 (240, 320, 384, 192,
...) by mixed-radix plans passed at run time (``mixed_plan``), longer such
sides (1280, 2048, 4096, 16384, ...) by the split route (``'split'``), the
sides with a larger prime factor by dense DFT lines up to ``DENSE_MAX`` (17,
31, 61, 79) and by Bluestein's chirp (``'chirp'``) above (89, 127, 244,
368, 509, 1031, ...): a cyclic convolution of a 13-smooth length
``chirp_length(n)``. The chirp and split routes run a pass in one launch
while a line fits one block (``'block'``) or a thread-block cluster of up
to ``CLUSTER_MAX`` blocks (``'cluster'``), and on device stages above
(``'stages'``; ``axis_plan``). Nothing falls back to ``torch.fft``; a CUDA
tensor is refused only at an index range the kernels count in int32
(``_check_ranges``).
"""

import bisect
import ctypes
import functools

import numpy as np
import torch

from csmri_refinement_tpu_torch.ops import fft
from csmri_refinement_tpu_torch.ops import native
from csmri_refinement_tpu_torch.parallel import halo
from csmri_refinement_tpu_torch.parallel import mesh as mesh_lib
from csmri_refinement_tpu_torch.utils import profiling

# The longest line of the radix, mixed-radix and dense routes' tiles
# (``csrc/dc.cu``'s ``kTileLine``).
TILE_LINE = 1024
# The chirp and split routes' lines in one launch a pass (``csrc/dc.cu``'s
# ``block_lines`` and ``cluster_lines``): a tile of lines of at most
# BLOCK_LINE points a block (the line, or a cluster block's share of it),
# held in place in one buffer beside the staging of the next tile's raw
# points, in BLOCK_SMEM bytes of shared memory (``tile_bytes``; the H100's
# 227 KiB less 1 KiB for the kernel's static arrays). A column tile holds
# COL_TILE adjacent columns, 32 bytes of a row: one sector. BLOCK_LINE is
# the longest chirp length m whose column tile and staging (m / 2 raw
# points a line) fit: 4628 (231,400 bytes); a split line, whose staging is
# as long as its line, fits one block up to 3506 points. A longer line is
# spread over a cluster of up to CLUSTER_MAX blocks (the portable cluster
# size), each holding BLOCK_LINE points at most; in-block plans take up to
# BLOCK_MAX_STAGES radices, a cluster's one more.
BLOCK_LINE = 4628
BLOCK_SMEM = 231424
COL_TILE = 4
CLUSTER_MAX = 8
BLOCK_MAX_STAGES = 5
# The radices of the device stages (``stage_lines``, lines longer than a
# cluster holds): each a line one block transforms on a mixed-radix plan.
STAGE_LINE = 4096
# The longest side with a prime factor above 13 that takes dense DFT lines:
# up to it the dense route's n² a line is faster on the card than the
# chirp's four FFTs of m ≥ 2n points (``chip_smoke.py`` phase 11).
DENSE_MAX = 80


def kspace_merge_reference(k, k0, mask, noise_lvl=None):
  """Merge predicted k-space with the sampled lines: noiseless, or with a
  ``noise_lvl`` weighing the prediction against the noisy samples (JAX
  ``ops/dc.py:448-452``; a ``noise_lvl`` of 0 merges as noiseless)."""
  if noise_lvl:
    return (1 - mask) * k + mask * (k + noise_lvl * k0) / (1 + noise_lvl)
  return (1 - mask) * k + k0


def _line_fft(xc, dim, inverse=False):
  """Ortho 1D (inverse) FFT of complex (B, H, W) lines along ``dim`` (1:
  H, 2: W), taken over a contiguous last axis: a line's result then does
  not depend on the other lines in the call (a CPU FFT along a strided
  axis rounds one image differently from a batch of them)."""
  f = torch.fft.ifft if inverse else torch.fft.fft
  if dim == 2:
    return f(xc, dim=-1, norm='ortho')
  return f(xc.transpose(1, 2).contiguous(), dim=-1,
           norm='ortho').transpose(1, 2)


def _fft_along(x, dim, inverse=False):
  """``_line_fft`` of a packed (B, H, W, 2) tensor."""
  return fft.pack_complex(_line_fft(fft.unpack_complex(x.float()), dim,
                                    inverse))


def dc_rows_fft_plain(x):
  """Pass 1 (plain): the FFT along W of (B, h, W, 2) rows."""
  return _fft_along(x, 2)


def dc_cols_plain(t, k0, mask, noise_lvl=None):
  """Pass 2 (plain): on (B, H, w, 2) columns, the FFT along H, the merge
  with k0 (None: zero) and the (B, H, w, 1) mask, the inverse FFT along
  H."""
  k = _line_fft(fft.unpack_complex(t.float()), 1)
  m = mask[..., 0].float()
  k = (1 - m) * k if k0 is None else kspace_merge_reference(
      k, fft.unpack_complex(k0.float()), m, noise_lvl)
  return fft.pack_complex(_line_fft(k, 1, inverse=True))


def dc_rows_ifft_plain(t):
  """Pass 3 (plain): the inverse FFT along W of (B, h, W, 2) rows."""
  return _fft_along(t, 2, inverse=True)


def dc_plain(x, k0, mask):
  """Plain PyTorch DC on packed tensors, in float32: the three passes."""
  return dc_rows_ifft_plain(dc_cols_plain(dc_rows_fft_plain(x), k0, mask))


@functools.lru_cache(maxsize=None)
def _lib():
  lib = native.library('dc')
  # a route, its plan code and its device stages (a host array or null)
  plan = [ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p]
  lib.dc_forward.argtypes = [ctypes.c_void_p] * 8 + plan * 2 + [
      ctypes.c_int] * 3 + [ctypes.c_void_p]
  lib.dc_rows_pass.argtypes = [ctypes.c_void_p] * 4 + plan + [
      ctypes.c_int] * 3 + [ctypes.c_void_p]
  lib.dc_cols_pass.argtypes = [ctypes.c_void_p] * 6 + plan + [
      ctypes.c_int] * 3 + [ctypes.c_void_p]
  for fn in (lib.dc_forward, lib.dc_rows_pass, lib.dc_cols_pass):
    fn.restype = ctypes.c_int
  return lib


# The radix route's line FFT plan, per power-of-two n: the radices of its
# stages, each an in-register DFT of 2 to 16 points (``csrc/dc.cu``
# compiles the same plans and refuses any other). A thread holds the
# largest radix's points.
FFT_PLANS = {2: (2,), 4: (4,), 8: (8,), 16: (16,), 32: (8, 4), 64: (8, 8),
             128: (16, 8), 256: (16, 16), 512: (8, 8, 8),
             1024: (16, 8, 8)}
# The power-of-two part of a mixed-radix plan above TILE_LINE (a block's
# line on the chirp and split routes).
_BLOCK_POW2 = {2048: (16, 16, 8), 4096: (16, 16, 16)}

# The mixed-radix route's radices (``csrc/dc.cu``'s ``mix_stage``): the
# radix-2 networks of 2 to 16 points and the odd DFTs with constant roots.
MIXED_RADICES = (2, 3, 4, 5, 7, 8, 9, 11, 13, 15, 16)
MIXED_MAX_STAGES = 4


def _prime_counts(n):
  """{p: exponent} of n's prime factors up to 13, and the rest of n."""
  count = {}
  for p in (2, 3, 5, 7, 11, 13):
    count[p] = 0
    while n % p == 0:
      n //= p
      count[p] += 1
  return count, n


@functools.lru_cache(maxsize=None)
def mixed_plan(n, stages=MIXED_MAX_STAGES):
  """The mixed-radix plan of a line of 2 to BLOCK_LINE points whose prime
  factors are at most 13, in at most ``stages`` stages, or None: the power
  of two as ``FFT_PLANS`` splits it, then 15 for each pair of 3 and 5, 9
  for each pair of 3s, and the remaining 3, 5, 7, 11 and 13. The
  mixed-radix route takes the sides to TILE_LINE in ``MIXED_MAX_STAGES``;
  the chirp and split routes run a block's line on the same radices in up
  to ``BLOCK_MAX_STAGES`` (``block_plan``), the device stages in
  ``MIXED_MAX_STAGES``."""
  if not 2 <= n <= BLOCK_LINE:
    return None
  count, rest = _prime_counts(n)
  if rest != 1:
    return None
  fifteens = min(count[3], count[5])
  threes, fives = count[3] - fifteens, count[5] - fifteens
  pow2 = 1 << count[2]
  plan = (FFT_PLANS.get(pow2) or _BLOCK_POW2.get(pow2, ())) + \
      (15,) * fifteens + (9,) * (threes // 2) + (3,) * (threes % 2) + \
      (5,) * fives + (7,) * count[7] + (11,) * count[11] + (13,) * count[13]
  return plan if len(plan) <= stages else None


def block_plan(n):
  """The radices of a block's in-place transform of n points: those of
  ``mixed_plan`` in up to ``BLOCK_MAX_STAGES``, smallest first, or None.
  The first stage (which reads the staged raw points) and the inverse's
  last (which writes device memory) then hold the fewest points; on the
  card that was as fast or faster at 11 of 13 sides timed (1280² 0.1224 →
  0.1052 ms, 1021² 0.4011 → 0.3529)."""
  plan = mixed_plan(n, BLOCK_MAX_STAGES)
  return tuple(sorted(plan)) if plan else None


# The relative time a point of a stage of each radix takes in one launch
# (``csrc/dc.cu``'s ``line_stage``, ascending plans), fitted to K1's times
# on the card at 107 chirp lengths of 9 sides in one block (phase 11's
# ``chirp_length_table`` in ``chip_smoke.py`` prints them): the odd DFTs'
# work grows as R², and 15 and 16 points spill registers. On a cluster the
# first stage, which reads and writes across its blocks, costs more a
# point (``cluster_first_cost``, fitted to 28 lengths of 2311).
RADIX_COST = {2: 0.7, 3: 0.7, 4: 0.9, 5: 0.9, 7: 1.0, 8: 1.0, 9: 1.25,
              11: 1.3, 13: 1.5, 15: 2.1, 16: 1.7}


def plan_cost(length, plan, clusters=1):
  """The modelled time of a line transform of ``length`` points on
  ``plan`` (on ``clusters`` blocks): ``length`` times the sum of its
  radices' ``RADIX_COST`` and, on a cluster, the first radix's
  ``cluster_first_cost``."""
  extra = cluster_first_cost(plan[0]) if clusters > 1 else 0.0
  return length * (sum(RADIX_COST[r] for r in plan) + extra)


def cluster_first_cost(r):
  """The cost a point of a cluster's first stage of radix r adds."""
  return 0.0 if r == 2 else 0.5 if r <= 7 else 1.0


def _code(plan):
  """A plan as the kernel checks it: one byte per stage's radix."""
  return sum(r << (8 * s) for s, r in enumerate(plan))


def plan_code(n):
  """The radix route's plan of n as the kernel checks it."""
  return _code(FFT_PLANS[n])


def mixed_plan_code(n):
  """The mixed-radix route's plan of n as the kernel checks it."""
  return _code(mixed_plan(n))


def stage_twiddles(plan):
  """The inter-stage twiddles of a plan, in f64 rounded once to f32.

  Stage s ≥ 1 (span Ns = product of the earlier radices, radix r) has a
  table of Ns·r entries, ``[q·Ns + m] = exp(−2πi·m·q/(Ns·r))``; the tables
  are concatenated in stage order. Returns an (entries, 2) float32 array
  (one zero entry when the plan has a single stage).
  """
  parts = []
  span = 1
  for s, r in enumerate(plan):
    if s:
      q, m = np.meshgrid(np.arange(r), np.arange(span), indexing='ij')
      parts.append(np.exp(-2j * np.pi * m * q / (span * r)).reshape(-1))
    span *= r
  w = np.concatenate(parts) if parts else np.zeros(1, np.complex128)
  return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


def fft_tables(n):
  """The radix route's twiddles of n (``stage_twiddles``)."""
  return stage_twiddles(FFT_PLANS[n])


def mixed_tables(n):
  """The mixed-radix route's twiddles of n (``stage_twiddles``)."""
  return stage_twiddles(mixed_plan(n))


def odd_roots(r):
  """The constant roots of the kernel's odd r-point DFT: (cos, sin) of
  2π·m/r for 0 < m ≤ (r − 1)/2, in f64 rounded once to f32, an
  ((r − 1)/2, 2) float32 array (``csrc/dc.cu``'s ``odd_root`` literals)."""
  t = 2 * np.pi * np.arange(1, (r - 1) // 2 + 1) / r
  return np.stack([np.cos(t), np.sin(t)], axis=-1).astype(np.float32)


def dft_table(n):
  """The n roots ``exp(−2πi·m/n)``, m < n, of the dense-DFT route, in f64
  rounded once to f32: an (n, 2) float32 array."""
  w = np.exp(-2j * np.pi * np.arange(n) / n)
  return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


def _smooth(n):
  return _prime_counts(n)[1] == 1


def tile_bytes(points, staged, lines=COL_TILE):
  """Shared memory of a tile of ``lines`` lines of ``points`` points (one
  buffer, a padding entry per 16) and the staging of ``staged`` raw points
  a line: what ``csrc/dc.cu``'s ``line_smem`` gives a column tile."""
  u = points * lines
  return 8 * (u + (u >> 4)) + 8 * staged * lines


def line_plan(length, n):
  """How one launch a pass holds a transform of ``length`` points of lines
  of n raw points: ``(1, plan)`` where a column tile fits one block
  (``block_plan``, ``tile_bytes`` within BLOCK_SMEM); else ``(C, plan)``
  over a cluster of C ≤ CLUSTER_MAX blocks, each holding ``length / C``
  positions and ``ceil(n / C)`` raw points, whose first radix is a
  multiple of C (that stage's butterflies read and write across the
  cluster, the others stay in a block); else None. The smallest C, then
  the first radix whose plan costs least (``plan_cost``)."""
  plan = block_plan(length)
  if plan and tile_bytes(length, n) <= BLOCK_SMEM:
    return 1, plan
  for c in range(2, CLUSTER_MAX + 1):
    if length % c or length // c > BLOCK_LINE or \
        tile_bytes(length // c, -(-n // c)) > BLOCK_SMEM:
      continue
    plans = [(r0,) + block_plan(length // r0) for r0 in MIXED_RADICES
             if r0 % c == 0 and length % r0 == 0 and block_plan(length // r0)]
    if plans:
      return c, min(plans, key=lambda q: plan_cost(length, q, c))
  return None


@functools.lru_cache(maxsize=None)
def _smooth_lengths():
  """The lengths up to CLUSTER_MAX·BLOCK_LINE whose prime factors are at
  most 13, ascending."""
  limit = CLUSTER_MAX * BLOCK_LINE
  lengths = {1}
  for p in (2, 3, 5, 7, 11, 13):
    grown = set()
    for v in lengths:
      while v <= limit:
        grown.add(v)
        v *= p
    lengths = grown
  return sorted(lengths)


@functools.lru_cache(maxsize=None)
def chirp_length(n):
  """The chirp route's convolution length for a side n: of the m from 2n −
  1 to twice that whose prime factors are at most 13 and that
  one launch a pass holds (``line_plan``: up to CLUSTER_MAX·BLOCK_LINE)
  as the least such m does, in one block or on a cluster, the one whose
  plan costs least (``plan_cost``: 512 = 8·8·8 for 244, not 490 =
  2·5·7·7); else the least such m with device stages
  (``split_radices``)."""
  lo = 2 * n - 1
  hi = min(2 * lo, CLUSTER_MAX * BLOCK_LINE)
  best = kind = None
  smooth = _smooth_lengths()
  for m in smooth[bisect.bisect_left(smooth, lo):
                  bisect.bisect_right(smooth, hi)]:
    held = line_plan(m, n)
    if not held or kind not in (None, held[0] == 1):
      continue
    kind = held[0] == 1
    if best is None or plan_cost(m, held[1], held[0]) < plan_cost(*best):
      best = m, held[1], held[0]
  if best:
    return best[0]
  m = 2 * n - 1
  while not (_smooth(m) and split_radices(m)):
    m += 1
  return m


def _divisors(n):
  small = [d for d in range(1, int(n ** 0.5) + 1) if n % d == 0]
  return sorted(set(small + [n // d for d in small]))


@functools.lru_cache(maxsize=None)
def _even_split(n, k):
  """n as k radices of at most STAGE_LINE with mixed-radix plans, the
  largest as small as it can be (ascending), or None."""
  if k == 1:
    return (n,) if n <= STAGE_LINE and mixed_plan(n) else None
  best = None
  for d in _divisors(n):
    if d > STAGE_LINE or not mixed_plan(d):
      continue
    rest = _even_split(n // d, k - 1)
    if rest is None or rest[0] < d:
      continue
    cand = (d,) + rest
    if best is None or max(cand) < max(best):
      best = cand
  return best


@functools.lru_cache(maxsize=None)
def split_radices(n):
  """Device stages of a line of n points whose prime factors are at most
  13: as few radices as possible (at least two), each at most STAGE_LINE
  with a mixed-radix plan, their product n, as even as possible (16384 =
  128·128, 32768 = 128·256); None if n has a larger prime factor."""
  if n < 4 or not _smooth(n):
    return None
  k = 2
  while True:
    radices = _even_split(n, k)
    if radices:
      return radices
    k += 1


def axis_route(n):
  """How the kernel transforms lines of n points: ``'fft'`` (the radix
  plans of ``FFT_PLANS``, powers of two to TILE_LINE), ``'mixed'`` (the
  mixed-radix plans of ``mixed_plan``, the other sides to TILE_LINE whose
  prime factors are at most 13), ``'split'`` (longer such sides,
  ``axis_plan``), ``'dft'`` (dense DFT lines, sides with a larger prime
  factor up to DENSE_MAX), ``'chirp'`` (the longer ones, ``chirp_length``)
  or None (a side below 2)."""
  if n < 2:
    return None
  if n <= TILE_LINE:
    if n in FFT_PLANS:
      return 'fft'
    if mixed_plan(n):
      return 'mixed'
    if n <= DENSE_MAX:
      return 'dft'
  elif split_radices(n):
    return 'split'
  return 'chirp'


def axis_length(route, n):
  """The length of the transform a chirp or split axis of n points runs:
  the chirp's m, or n."""
  return chirp_length(n) if route == 'chirp' else n


def axis_plan(route, n, staged=False):
  """How a chirp or split axis of n points runs a pass: ``('block', 1,
  plan)`` or ``('cluster', C, plan)`` in one launch (``line_plan``), or
  ``('stages', None, radices)`` on device stages (``split_radices``), one
  launch a radix and direction: where no cluster holds the line, or with
  ``staged`` (``axis_staged``) where a cluster would."""
  length = axis_length(route, n)
  held = line_plan(length, n)
  if held and not (staged and held[0] > 1 and split_radices(length)):
    return ('block' if held[0] == 1 else 'cluster',) + held
  return 'stages', None, split_radices(length)


def cluster_lines(route, c, cols):
  """The fewest lines of an axis an image needs (its other side) to take
  a cluster of c blocks, fewer running on device stages: 512·c on the
  split route, on the chirp route 128·c columns (pass 2) or 32·c rows
  (passes 1 and 3). Timed on the card (``chip_smoke.py``'s
  ``cluster_lines_table``): the device stages were faster for 4099 beside
  16 rows or 128 columns (c = 2) and for 16384 beside 16 to 2048 rows (c =
  8; 16 × 16384: 0.0366 against 0.0518 ms), the cluster for 4099 beside 64
  rows or 256 columns and for 3510 beside 1024 or 2048 columns (c =
  2)."""
  return (512 if route == 'split' else 128 if cols else 32) * c


def axis_staged(route, n, lines, cols):
  """Whether an axis of n points runs on device stages although a cluster
  holds its line: on the chirp or split route, where the image has fewer
  lines of it than ``cluster_lines`` (``lines``: the image's other side;
  ``cols``: the axis is H, pass 2). An image's lines, not the batch's or
  a spatial rank's, so that every rank and batch takes the same plan and
  gets the same bits."""
  if route not in ('chirp', 'split'):
    return False
  kind, c, _ = axis_plan(route, n)
  return kind == 'cluster' and lines < cluster_lines(route, c, cols)


def axis_stages(route, n, staged=False):
  """The device stages of a chirp or split axis: one (the whole transform,
  ``axis_length``) where a block or a cluster holds it, else the radices
  of ``split_radices``."""
  kind, _, plan = axis_plan(route, n, staged)
  return plan if kind == 'stages' else (axis_length(route, n),)


def line_positions(plan):
  """Where the in-place transform of ``plan`` (decimation in frequency,
  ``csrc/dc.cu``'s ``dif_stage``) leaves each frequency: an int64 array,
  ``pos[k]``. With k = d_0 + R_0·(d_1 + R_1·(d_2 + ...)), pos[k] = Σ d_s·M_s,
  M_s = N / (R_0⋯R_s): the digits of k reversed."""
  n = int(np.prod(plan))
  k = np.arange(n, dtype=np.int64)
  pos = np.zeros(n, np.int64)
  rest = n
  for r in plan:
    rest //= r
    pos += (k % r) * rest
    k //= r
  return pos


def chirp_tables(n):
  """The chirp route's tables of n, in f64 rounded once to f32: the chirp
  ``c_j = exp(iπ·j²/n)`` (n entries, its phase π·(j² mod 2n)/n from exact
  integers) and the transform of the padded filter ``b`` (b_j = c_j and
  b_(m−j) = c_j for j < n, zero between) of length m = ``chirp_length(n)``,
  divided by m: ((n, 2), (m, 2)) float32 arrays."""
  m = chirp_length(n)
  j = np.arange(n, dtype=np.int64)
  c = np.exp(1j * np.pi * ((j * j) % (2 * n)) / n)
  b = np.zeros(m, np.complex128)
  b[:n] = c
  b[m - n + 1:] = c[1:][::-1]
  f = np.fft.fft(b) / m
  return tuple(np.stack([v.real, v.imag], axis=-1).astype(np.float32)
               for v in (c, f))


def _block_twiddles(r):
  """The in-block plan's twiddles of a radix r, without the padding entry
  of a one-stage plan."""
  plan = mixed_plan(r)
  size = sum(int(np.prod(plan[:s])) * plan[s] for s in range(1, len(plan)))
  return stage_twiddles(plan)[:size]


def _int_entries(v):
  """int32 values as (entries, 2) float32 bit patterns, two an entry."""
  v = np.asarray(v, np.int32)
  if len(v) % 2:
    v = np.append(v, np.int32(0))
  return v.view(np.float32).reshape(-1, 2)


def axis_tables(route, n, staged=False):
  """The table of an axis on the chirp or split route, as ``csrc/dc.cu``
  reads it. In one launch a pass (``axis_plan``: block or cluster): on the
  chirp route the chirp (n entries), the filter's transform (m) at the
  positions where the in-place transform leaves each frequency
  (``line_positions``), then the roots of the transform's length
  (``dft_table``); on the split route the roots, then ``line_positions``
  as int32 (two an entry). On device stages: the chirp and the filter in
  natural order (chirp route), each device stage's in-block twiddles
  (``stage_twiddles`` of its radix's ``mixed_plan``) in stage order, then
  the device stages' own twiddles, ``stage_twiddles`` of the radices
  (stage s ≥ 1: ``[q·Ns + k] = exp(−2πi·k·q/(Ns·R_s))``)."""
  kind, _, plan = axis_plan(route, n, staged)
  length = axis_length(route, n)
  if kind != 'stages':
    pos = line_positions(plan)
    if route == 'split':
      return np.concatenate([dft_table(length), _int_entries(pos)])
    c, f = chirp_tables(n)
    fp = np.empty_like(f)
    fp[pos] = f
    return np.concatenate([c, fp, dft_table(length)])
  parts = list(chirp_tables(n)) if route == 'chirp' else []
  parts += [_block_twiddles(r) for r in plan]
  parts.append(stage_twiddles(plan))
  return np.concatenate(parts)


def dc_route(h, w):
  """The kernel's routes for an H×W image, one per axis: ``(route of H,
  route of W)`` by ``axis_route``. Passes 1 and 3 (along W) take W's,
  pass 2 (along H) H's. A power-of-two H keeps the radix route only when
  W is a power of two too: a spatial group of S ranks divides H, so S is a
  power of two and every rank's W / S columns are a block the radix column
  pass takes (``check_cols_block``); beside any other W it takes the
  mixed-radix route with the same radices, which takes any block. None for
  a side below 2."""
  route_h, route_w = axis_route(h), axis_route(w)
  if route_h is None or route_w is None:
    return None
  if route_h == 'fft' and w & (w - 1):
    route_h = 'mixed'
  return route_h, route_w


@functools.lru_cache(maxsize=None)
def span_name(kind, device_type, h, w):
  """The name of a DC's span (``kind`` 'dc') or of its backward's
  ('dc_bwd') on an H×W image: ``csmri.<kind>.<route of H>.<route of W>``
  (``dc_route``) on the card, ``csmri.<kind>.plain`` elsewhere, where the
  plain version runs. Made once a shape."""
  if device_type != 'cuda':
    return 'csmri.{}.plain'.format(kind)
  return '.'.join(('csmri', kind) + (dc_route(h, w) or ('none',)))


def _bwd_span(g):
  return span_name('dc_bwd', g.device.type, g.shape[1], g.shape[2])


_ROUTE_CODES = {'fft': 0, 'mixed': 1, 'dft': 2, 'chirp': 3, 'split': 4}


def _plan_args(route, n, staged=False):
  """(route code, plan code, stages) of ``csrc/dc.cu``'s entries: the plan
  code is the radix or mixed-radix plan (one byte per stage's radix), or on
  the chirp and split routes the transform's length; stages is None, or on
  those routes a host array: in one launch a pass [1, C, S, R_0, ...,
  R_(S−1)], on device stages [S, R_0, plan code of R_0, ..., R_(S−1), ...]
  (``axis_plan``)."""
  if route in ('chirp', 'split'):
    kind, c, plan = axis_plan(route, n, staged)
    if kind == 'stages':
      codes = [len(plan)]
      for r in plan:
        codes += [r, _code(mixed_plan(r))]
    else:
      codes = [1, c, len(plan)] + list(plan)
    return (_ROUTE_CODES[route], axis_length(route, n),
            ctypes.cast((ctypes.c_uint64 * len(codes))(*codes),
                        ctypes.c_void_p))
  code = plan_code(n) if route == 'fft' else \
      mixed_plan_code(n) if route == 'mixed' else 0
  return _ROUTE_CODES[route], code, None


def work_elems(route, n, lines, staged=False):
  """Complex elements of the work buffer a pass of ``lines`` lines of n
  points needs on ``route``: two buffers of ``axis_length`` points a line
  where the transform runs on device stages, else none."""
  if route not in ('chirp', 'split') or \
      axis_plan(route, n, staged)[0] != 'stages':
    return 0
  return 2 * lines * axis_length(route, n)


@functools.lru_cache(maxsize=None)
def _tables(route, n, device, staged=False):
  table = {'fft': fft_tables, 'mixed': mixed_tables, 'dft': dft_table,
           'chirp': lambda n: axis_tables('chirp', n, staged),
           'split': lambda n: axis_tables('split', n, staged)}[route](n)
  return torch.from_numpy(table).to(device)


def _check(name, t, shape, device):
  if t.device != device or t.dtype != torch.float32:
    raise ValueError('dc_cuda: {} must be float32 on {}, got {} on {}'.format(
        name, device, t.dtype, t.device))
  if tuple(t.shape) != shape:
    raise ValueError('dc_cuda: {} must have shape {}, got {}'.format(
        name, shape, tuple(t.shape)))
  if not t.is_contiguous():
    raise ValueError('dc_cuda: {} must be contiguous'.format(name))


# The kernels count images, lines and a line's points in int32.
INT32_LIMIT = 2 ** 31
MAX_IMAGES = 65535          # a grid's y extent, as K2 and K3 take
MAX_SIDE = 2 ** 29          # a chirp's m = 2^30 stays an int32 position


def _check_ranges(name, b, h, w):
  """Raise where an index the kernels count in int32 would overflow: 1 to
  MAX_IMAGES images, B·H rows and B·W columns below 2^31, sides up to
  MAX_SIDE (the chirp's length, positions of a line)."""
  if not (1 <= b <= MAX_IMAGES and b * h < INT32_LIMIT and
          b * w < INT32_LIMIT and max(h, w) <= MAX_SIDE):
    raise ValueError(
        '{}: {} images of {}x{} are over the int32 index range the kernels '
        'count in (1 to {} images, B·H and B·W below 2^31, sides up to '
        '2^29)'.format(name, b, h, w, MAX_IMAGES))


def _work(route, n, lines, staged, device):
  """The work buffer of a pass on ``route`` (``work_elems``), or None."""
  elems = work_elems(route, n, lines, staged)
  return torch.empty((elems, 2), device=device) if elems else None


def _ptr(t):
  return None if t is None else native.ptr(t)


def _launch(name, x, k0, mask):
  """Check the inputs and run ``dc_forward``; ``k0`` None launches the
  no-k0 mode."""
  _require_cuda(name, x)
  b, h, w, _ = x.shape
  routes = _image_routes(name, h, w)
  _check_ranges(name, b, h, w)
  _check('x', x, (b, h, w, 2), x.device)
  if k0 is not None:
    _check('k0', k0, (b, h, w, 2), x.device)
  _check('mask', mask, (b, h, w, 1), x.device)
  # the radix route moves 16 bytes at a time
  x = _aligned(x)
  if k0 is not None:
    k0 = _aligned(k0)
  y = torch.empty_like(x)
  scratch = torch.empty_like(x)
  route_h, route_w = routes
  staged_h = axis_staged(route_h, h, w, True)
  staged_w = axis_staged(route_w, w, h, False)
  elems = max(work_elems(route_w, w, b * h, staged_w),
              work_elems(route_h, h, b * w, staged_h))
  work = torch.empty((elems, 2), device=x.device) if elems else None
  tw_h = _tables(route_h, h, x.device, staged_h)
  tw_w = _tables(route_w, w, x.device, staged_w)
  with torch.cuda.device(x.device):
    status = _lib().dc_forward(
        native.ptr(x), _ptr(k0), native.ptr(mask), native.ptr(y),
        native.ptr(scratch), _ptr(work), native.ptr(tw_h), native.ptr(tw_w),
        *_plan_args(route_h, h, staged_h), *_plan_args(route_w, w, staged_w),
        b, h, w, native.stream_of(x))
  native.check(status, 'dc_forward')
  return y


def dc_cuda(x, k0, mask):
  """Launch the DC kernel (csrc/dc.cu) on CUDA tensors."""
  y = _launch('dc_cuda', x, k0, mask)
  dc_cuda.launches += 1
  return y


dc_cuda.launches = 0


def dc_bwd_cuda(g, mask):
  """K1-bwd: ``grad_x = DC(g, 0, mask)``, the DC kernel without k0."""
  y = _launch('dc_bwd_cuda', g, None, mask)
  dc_bwd_cuda.launches += 1
  return y


dc_bwd_cuda.launches = 0


def dc_plain_vjp(g, mask, need_k0=True):
  """Plain Hermitian VJP of the DC: ``(grad_x, grad_k0)`` for the output
  gradient ``g``; ``grad_k0`` is None unless ``need_k0``."""
  t = dc_rows_fft_plain(g)
  grad_x = dc_rows_ifft_plain(dc_cols_plain(t, None, mask))
  return grad_x, _fft_along(t, 1) if need_k0 else None


class _DCFunction(torch.autograd.Function):
  """DC with its Hermitian backward: K1 forward, K1-bwd backward on CUDA
  tensors; on CPU tensors the same formula through the plain versions."""

  @staticmethod
  def forward(ctx, x, k0, mask):
    ctx.save_for_backward(mask)
    if x.device.type == 'cpu':
      return dc_plain(x, k0, mask)
    return dc_cuda(x, k0, mask)

  @staticmethod
  def backward(ctx, g):
    with profiling.span(_bwd_span, g):
      mask, = ctx.saved_tensors
      need_x, need_k0 = ctx.needs_input_grad[:2]
      g = g.float().contiguous()
      if g.device.type == 'cpu':
        grad_x, grad_k0 = dc_plain_vjp(g, mask, need_k0)
        return grad_x if need_x else None, grad_k0, None
      grad_x = dc_bwd_cuda(g, mask) if need_x else None
      grad_k0 = fft.pack_complex(fft.fft2(fft.unpack_complex(g))) \
          if need_k0 else None
      return grad_x, grad_k0, None


@torch.library.custom_op('csmri::dc', mutates_args=(), device_types='cpu')
def dc_op(x: torch.Tensor, k0: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
  """K1 without a gradient: the plain version on the CPU."""
  return dc_plain(x, k0, mask)


@dc_op.register_kernel('cuda')
def _dc_op_cuda(x, k0, mask):
  return dc_cuda(x, k0, mask)


@dc_op.register_fake
def _dc_op_fake(x, k0, mask):
  return torch.empty(x.shape, dtype=torch.float32, device=x.device)


def _needs_grad(*tensors):
  return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def dc_fused(x, k0, mask):
  """DC on packed tensors: the kernels (forward and backward) on CUDA, the
  autodiffed plain version on CPU; without a gradient, ``csmri::dc``."""
  if not _needs_grad(x, k0):
    return torch.ops.csmri.dc(x, k0, mask)
  if x.device.type == 'cpu':
    return dc_plain(x, k0, mask)
  return _DCFunction.apply(x, k0, mask)


# --- K1's passes: the DC distributed over a spatial group ---

def _require_cuda(name, t):
  if t.device.type != 'cuda':
    raise ValueError('{} takes CUDA tensors, got {}'.format(name, t.device))
  if t.ndim != 4 or t.shape[-1] != 2:
    raise ValueError('{}: expected a (B, rows, cols, 2) tensor, got {}'
                     .format(name, tuple(t.shape)))


def _image_routes(name, h, w):
  routes = dc_route(h, w)
  if routes is None:
    raise ValueError('{} takes images of sides from 2, got {}x{}'.format(
        name, h, w))
  return routes


def _aligned(t):
  return t.clone() if t.data_ptr() % 16 else t


def _rows_launch(name, x, height, inverse):
  """Pass 1 (or 3, ``inverse``) on x (B, h, W, 2): rows of images of
  ``height`` rows."""
  _require_cuda(name, x)
  b, rows, w, _ = x.shape
  route = _image_routes(name, height, w)[1]
  _check_ranges(name, b, max(rows, height), w)
  _check('x', x, (b, rows, w, 2), x.device)
  x = _aligned(x)
  y = torch.empty_like(x)
  staged = axis_staged(route, w, height, False)
  tw = _tables(route, w, x.device, staged)
  work = _work(route, w, b * rows, staged, x.device)
  with torch.cuda.device(x.device):
    status = _lib().dc_rows_pass(native.ptr(x), native.ptr(y), _ptr(work),
                                 native.ptr(tw),
                                 *_plan_args(route, w, staged),
                                 b * rows, w, int(inverse),
                                 native.stream_of(x))
  native.check(status, 'dc_rows_pass')
  return y


def radix_strip(height):
  """Columns per strip of the radix route's column pass on images of
  ``height`` rows (``csrc/dc.cu``'s ``col_strip``): 16, and 8 above 512
  rows, where a strip's two 16-column buffers would not fit a block's
  shared memory."""
  return 16 if height <= 512 else 8


def check_cols_block(name, w, width, route, height):
  """Raise unless a block of ``w`` of an image's ``width`` columns is one
  the column pass takes on ``route`` at ``height`` rows: on the radix route
  a block that divides the width in whole strips of ``radix_strip(height)``
  columns (or one strip of a power of two below that); on every other
  route any block of 1 to ``width`` columns (``csrc/dc.cu``'s ``mix_cols``,
  ``dft_cols``, ``block_lines`` and ``stage_lines`` walk partial strips and
  take the block as their row stride)."""
  full = radix_strip(height)
  strip = min(w, full)
  if not 1 <= w <= width or (route == 'fft' and (
      width % w or w % strip or strip & (strip - 1))):
    raise ValueError(
        '{}: a block of {} of the image\'s {} columns; the column pass '
        'takes, on the radix route at {} rows, a block that divides the '
        'width in whole {}-column strips (or one strip of a power of two '
        'below {}), on the other routes a block of 1 to {} '
        'columns'.format(name, w, width, height, full, full, width))


def _cols_launch(name, t, k0, mask, width):
  """Pass 2 on t (B, H, w, 2): whole columns of images of ``width``
  columns; ``k0`` None launches the no-k0 mode."""
  _require_cuda(name, t)
  b, h, w, _ = t.shape
  route = _image_routes(name, h, width)[0]
  _check_ranges(name, b, h, max(w, width))
  check_cols_block(name, w, width, route, h)
  _check('t', t, (b, h, w, 2), t.device)
  if k0 is not None:
    _check('k0', k0, (b, h, w, 2), t.device)
    k0 = _aligned(k0)
  _check('mask', mask, (b, h, w, 1), t.device)
  t = _aligned(t)
  y = torch.empty_like(t)
  staged = axis_staged(route, h, width, True)
  tw = _tables(route, h, t.device, staged)
  work = _work(route, h, b * w, staged, t.device)
  with torch.cuda.device(t.device):
    status = _lib().dc_cols_pass(native.ptr(t), _ptr(k0), native.ptr(mask),
                                 native.ptr(y), _ptr(work), native.ptr(tw),
                                 *_plan_args(route, h, staged), b, h, w,
                                 native.stream_of(t))
  native.check(status, 'dc_cols_pass')
  return y


def dc_rows_fft_cuda(x, height):
  """K1's pass 1 on CUDA rows x (B, h, W, 2) of images of ``height``
  rows."""
  y = _rows_launch('dc_rows_fft_cuda', x, height, False)
  dc_rows_fft_cuda.launches += 1
  return y


def dc_cols_cuda(t, k0, mask, width):
  """K1's pass 2 on CUDA columns t (B, H, w, 2) of images of ``width``
  columns, with the same columns of k0 and the mask."""
  y = _cols_launch('dc_cols_cuda', t, k0, mask, width)
  dc_cols_cuda.launches += 1
  return y


def dc_rows_ifft_cuda(t, height):
  """K1's pass 3 on CUDA rows t (B, h, W, 2)."""
  y = _rows_launch('dc_rows_ifft_cuda', t, height, True)
  dc_rows_ifft_cuda.launches += 1
  return y


def dc_bwd_rows_fft_cuda(g, height):
  """K1-bwd's pass 1: as ``dc_rows_fft_cuda``."""
  y = _rows_launch('dc_bwd_rows_fft_cuda', g, height, False)
  dc_bwd_rows_fft_cuda.launches += 1
  return y


def dc_bwd_cols_cuda(t, mask, width):
  """K1-bwd's pass 2: ``dc_cols_cuda`` without k0."""
  y = _cols_launch('dc_bwd_cols_cuda', t, None, mask, width)
  dc_bwd_cols_cuda.launches += 1
  return y


def dc_bwd_rows_ifft_cuda(t, height):
  """K1-bwd's pass 3: as ``dc_rows_ifft_cuda``."""
  y = _rows_launch('dc_bwd_rows_ifft_cuda', t, height, True)
  dc_bwd_rows_ifft_cuda.launches += 1
  return y


dc_rows_fft_cuda.launches = dc_cols_cuda.launches = 0
dc_rows_ifft_cuda.launches = dc_bwd_rows_fft_cuda.launches = 0
dc_bwd_cols_cuda.launches = dc_bwd_rows_ifft_cuda.launches = 0


@torch.library.custom_op('csmri::dc_rows_fft', mutates_args=(),
                         device_types='cpu')
def dc_rows_fft_op(x: torch.Tensor, height: int) -> torch.Tensor:
  """K1's pass 1: the plain version on the CPU."""
  return dc_rows_fft_plain(x)


@dc_rows_fft_op.register_kernel('cuda')
def _dc_rows_fft_op_cuda(x, height):
  return dc_rows_fft_cuda(x, height)


@torch.library.custom_op('csmri::dc_cols', mutates_args=(),
                         device_types='cpu')
def dc_cols_op(t: torch.Tensor, k0: torch.Tensor, mask: torch.Tensor,
               width: int) -> torch.Tensor:
  """K1's pass 2: the plain version on the CPU."""
  return dc_cols_plain(t, k0, mask)


@dc_cols_op.register_kernel('cuda')
def _dc_cols_op_cuda(t, k0, mask, width):
  return dc_cols_cuda(t, k0, mask, width)


@torch.library.custom_op('csmri::dc_rows_ifft', mutates_args=(),
                         device_types='cpu')
def dc_rows_ifft_op(t: torch.Tensor, height: int) -> torch.Tensor:
  """K1's pass 3: the plain version on the CPU."""
  return dc_rows_ifft_plain(t)


@dc_rows_ifft_op.register_kernel('cuda')
def _dc_rows_ifft_op_cuda(t, height):
  return dc_rows_ifft_cuda(t, height)


@dc_rows_fft_op.register_fake
@dc_cols_op.register_fake
@dc_rows_ifft_op.register_fake
def _dc_pass_fake(t, *args):
  return torch.empty(t.shape, dtype=torch.float32, device=t.device)


def _pipeline(x, k0, mask, mesh, rows_fft, cols, rows_ifft):
  """Pass 1 on the rows, the exchange to columns, pass 2, the exchange
  back, pass 3."""
  t = halo.rows_to_cols(rows_fft(x), mesh)
  return rows_ifft(halo.cols_to_rows(cols(t, k0, mask), mesh, x.shape[2]))


def _forward_passes(height, width):
  return (lambda x: torch.ops.csmri.dc_rows_fft(x, height),
          lambda t, k0, m: torch.ops.csmri.dc_cols(t, k0, m, width),
          lambda t: torch.ops.csmri.dc_rows_ifft(t, height))


def _backward_passes(device, height, width):
  if device.type == 'cpu':
    return dc_rows_fft_plain, dc_cols_plain, dc_rows_ifft_plain
  return (lambda g: dc_bwd_rows_fft_cuda(g, height),
          lambda t, k0, m: dc_bwd_cols_cuda(t, m, width),
          lambda t: dc_bwd_rows_ifft_cuda(t, height))


class _DistributedDCFunction(torch.autograd.Function):
  """``dc_distributed`` with a gradient: K1's passes forward, K1-bwd's
  backward (plain versions on CPU tensors)."""

  @staticmethod
  def forward(ctx, x, k0, mask, mesh):
    ctx.save_for_backward(mask)
    ctx.mesh = mesh
    ctx.sides = (x.shape[1] * mesh.spatial, x.shape[2])
    return _pipeline(x, k0, mask, mesh, *_forward_passes(*ctx.sides))

  @staticmethod
  def backward(ctx, g):
    mask, = ctx.saved_tensors
    mesh = ctx.mesh
    need_x, need_k0 = ctx.needs_input_grad[:2]
    rows_fft, cols, rows_ifft = _backward_passes(g.device, *ctx.sides)
    t = halo.rows_to_cols(rows_fft(g.float().contiguous()), mesh)
    grad_k0 = _fft_along(t, 1) if need_k0 else None
    grad_x = rows_ifft(halo.cols_to_rows(cols(t, None, mask), mesh,
                                         ctx.sides[1])) if need_x else None
    return grad_x, grad_k0, None, None


def check_distributed(x, k0, mask, mesh):
  """Raise unless x (B, H/S, W, 2) rows and k0 (B, H, w_s, 2), mask
  (B, H, w_s, 1) columns (this rank's column block of ``col_bounds``) are
  one rank's parts of (B, H, W) images."""
  b, h, w = x.shape[:3]
  s = mesh.spatial
  want = (b, h * s, mesh_lib.col_bounds(w, s).count(mesh.s))
  if tuple(k0.shape[:3]) != want or tuple(mask.shape[:3]) != want:
    raise ValueError(
        'the DC on {} ranks: x of {} rows and {} columns needs, on rank {}, '
        'k0 and mask of {} rows and {} columns, got {} and {}'.format(
            s, h, w, mesh.s, want[1], want[2], tuple(k0.shape),
            tuple(mask.shape)))


def dc_distributed(x, k0, mask, mesh):
  """The DC of a spatial mesh's rank: x (B, H/S, W, 2) its rows, k0
  (B, H, W/S, 2) and mask (B, H, W/S, 1) its columns; returns its rows of
  the whole image's DC."""
  check_distributed(x, k0, mask, mesh)
  if not _needs_grad(x, k0):
    return _pipeline(x, k0, mask, mesh, *_forward_passes(
        x.shape[1] * mesh.spatial, x.shape[2]))
  return _DistributedDCFunction.apply(x, k0, mask, mesh)


def dc_distributed_noisy(x, k0, mask, noise_lvl, mesh):
  """The noisy DC on a spatial mesh's rank (layout as ``dc_distributed``):
  the plain passes, the noisy merge in the column pass, autodiffed."""
  check_distributed(x, k0, mask, mesh)
  return _pipeline(x, k0, mask, mesh, dc_rows_fft_plain,
                   lambda t, k, m: dc_cols_plain(t, k, m, noise_lvl),
                   dc_rows_ifft_plain)
