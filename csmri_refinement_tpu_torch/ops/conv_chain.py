"""Chains of SAME stride-1 convs with folded BN: the CUDA kernel and its
plain version.

Port of the float mode of the TPU kernel
``csmri_refinement_tpu/ops/conv_pallas.py`` (``_chain_kernel``, wrapper
``fused_conv_chain``, policy ``chain_forward``). Per layer:

    y = act(conv_same(x, kernel) + bias)

with ``x`` NHWC in the compute dtype (bf16 on the main path, f32 for
parity), ``kernel`` HWIO with eval-mode BN folded in, ``bias`` f32, f32
accumulation and every layer's output rounded to the compute dtype.

* ``conv_layer_plain`` — the plain PyTorch version (``F.pad`` + ``F.conv2d``
  in f32 on the compute-dtype values, + bias, LeakyReLU, cast): the CPU path
  and the oracle the kernel is held against.
* ``conv_layer_cuda`` — the kernel wrapper: one launch per layer, counted
  in ``conv_layer_cuda.launches`` (both dtypes). bf16 runs
  ``csrc/conv_chain.cu``, a ``wgmma`` implicit GEMM on weights packed by
  ``pack_weights`` (layout ``gemm_layout``); f32 goes to
  ``conv_layer_f32_cuda`` (``csrc/conv_f32.cu``, its own count in
  ``conv_layer_f32_cuda.launches``): a 3xTF32 ``wgmma`` implicit GEMM on
  weights split and packed by ``pack_weights_f32`` (layout
  ``gemm_layout_f32``, split ``tf32_split``; the kernel splits its
  activations the same way), or for Cin < 8 a direct conv
  with exact FMAs on the HWIO weights. Any Cout: the weights and bias are
  padded with zero output channels to a multiple of 16 (``pad_cout``), the
  kernel writes the padded output and the wrapper keeps its first Cout
  channels. ``conv_route`` names the route a layer takes, decided by its
  shape.
* ``conv_layer`` — the device dispatch: CPU → plain, CUDA → kernel or raise;
  without a gradient through the custom ops ``csmri::conv_bf16`` and
  ``csmri::conv_f32`` (below).

The JAX kernel's Mosaic layout (pixel groups, block-Toeplitz weights, lane
rolls, guard rows) is TPU-specific and not carried over; neither are its
``layer_fusable``/VMEM gates on the float path, where they change only
speed.

The int8 serving mode (JAX ``_chain_kernel`` with ``quant=True``, reached
through ``ops/quantize.py::chain_forward_int8``) is the kernel of
``csrc/conv_int8.cu``. Per quantized layer:

    acc = conv_same(x_int8, w_int8)                   # exact int32
    y = fma(acc, w_scale[co] · act_scale[b], bias)    # f32, one rounding
    y = LeakyReLU(y)
    not last: x_int8, act_scale = requant(y, max|y| per image)
    last:     y cast to out_dtype

* ``conv_layer_int8_plain`` / ``requant_plain`` — plain PyTorch (the conv
  in float64, exact like the kernel's int32 sums); the CPU path and the
  oracle.
* ``conv_layer_int8_cuda`` / ``requant_cuda`` — the wrappers of the conv and
  requant kernels, each counting its launches in ``.launches``. The conv
  is an s8 ``wgmma`` implicit GEMM on weights packed K-major by
  ``pack_weights_int8`` (layout ``gemm_layout_int8``).
* ``fused_conv_chain_int8`` — a quantized chain, layer by layer, through
  the custom ops ``csmri::conv_int8`` and ``csmri::requant``.

Each serving kernel is a ``torch.library`` custom op: its CPU
implementation is the plain version, its CUDA one the wrapper (looked up
by its module-level name at each call, so that its launch count and a
recording replacement see every launch), and a fake implementation gives
``torch.export`` the output's shape and dtype. Ops take tensors and
scalars, so a ``ChainLayer`` is passed as its fields. The ctypes launch is
opaque to ``torch.export``; the ops are what lets a serving artifact's
graph hold the kernels (``utils/export.py``).
* ``int8_suffix_start`` — which layers of a chain are quantized. The JAX
  package quantizes only the suffix its Pallas kernel packs
  (``layer_fusable``) and fits in VMEM; that choice changes the output, so
  the port keeps it as a rule.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from csmri_refinement_tpu_torch.models import layers
from csmri_refinement_tpu_torch.ops import native
from csmri_refinement_tpu_torch.utils import profiling

PAD_MODES = {'zero': 0, 'reflection': 1, 'replication': 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class ChainLayer(NamedTuple):
  """One conv (+ optional LeakyReLU) of a chain.

  kernel: (k, k, Cin, Cout) HWIO, any float dtype, BN already folded in;
    or int8 in the quantized serving mode, with ``w_scale`` set.
  bias: (Cout,) or None.
  leakiness: LeakyReLU negative slope, or None for a linear layer.
  w_scale: (Cout,) f32 per-output-channel dequantization scales (int8 only).
  """
  kernel: torch.Tensor
  bias: Optional[torch.Tensor] = None
  leakiness: Optional[float] = None
  w_scale: Optional[torch.Tensor] = None


def conv_layer_plain(x, layer, pad_mode='reflection'):
  """One chain layer in plain PyTorch, with the kernel's roundings."""
  dt = x.dtype
  k = layer.kernel.shape[0]
  weight = layer.kernel.to(dt).float().permute(3, 2, 0, 1)
  y = F.conv2d(layers.tile_pad(x.float().permute(0, 3, 1, 2), k, pad_mode),
               weight)
  if layer.bias is not None:
    y = y + layer.bias.float()[:, None, None]
  if layer.leakiness is not None:
    y = layers.leaky_relu(y, layer.leakiness)
  return y.permute(0, 2, 3, 1).to(dt).contiguous()


def pad_cout(kernel, bias):
  """HWIO ``kernel`` and ``bias`` (or None) with Cout padded by zero output
  channels to a multiple of 16, the N granule of the kernels; bias f32.
  Copies nothing when Cout is a multiple of 16 already."""
  cout = kernel.shape[3]
  bias = torch.zeros(cout, device=kernel.device) if bias is None else \
      bias.to(device=kernel.device, dtype=torch.float32)
  if cout % 16:
    kernel, bias = F.pad(kernel, (0, -cout % 16)), F.pad(bias, (0, -cout % 16))
  return kernel, bias.contiguous()


def gemm_layout(cin, k):
  """K layout of the bf16 kernel: ``(cin_pad, chunk, kp)``.

  The halo is staged in chunks of ``chunk`` channels: one chunk of 16 for
  Cin ≤ 16; else chunks of 32, except k3 layers of Cin > 32, whose chunks
  of 64 keep each chunk's k·k·chunk a multiple of the 64-wide K stage. Cin
  pads to a multiple of the chunk. K runs over (chunk, tap, channel in
  chunk), k·k·cin_pad values, padded to ``kp``, a multiple of 64
  (``csrc/conv_chain.cu`` computes the same and checks ``kp``).
  """
  chunk = 16 if cin <= 16 else 32 if (k == 4 or cin <= 32) else 64
  cin_pad = -(-cin // chunk) * chunk
  ktot = k * k * cin_pad
  return cin_pad, chunk, -(-ktot // 64) * 64


def pack_weights(kernel, dtype=torch.bfloat16, layout=gemm_layout):
  """HWIO ``(k, k, Cin, Cout)`` weights → a ``wgmma`` kernel's K-major
  ``(Cout, kp)`` operand: row n holds output channel n's weights in the K
  order of ``layout``, zeros in the padding."""
  k, _, cin, cout = kernel.shape
  cin_pad, chunk, kp = layout(cin, k)
  w = F.pad(kernel.to(dtype), (0, 0, 0, cin_pad - cin))
  w = w.reshape(k * k, cin_pad // chunk, chunk, cout).permute(3, 1, 0, 2)
  w = w.reshape(cout, k * k * cin_pad)
  return F.pad(w, (0, kp - w.shape[1])).contiguous()


# K order within each 16 channels of the f32 route: position kk of a k16
# group holds channel F32_PERM[kk]. A thread of the kernel loads channels
# 4t .. 4t + 3 of a position in one 16-byte read; wgmma's tf32 A fragment
# wants columns t and t + 4 of each k8 step from it, so column t + 4h of
# step s is channel 4t + 2s + h.
F32_PERM = tuple(4 * (kk % 4) + 2 * (kk // 8) + (kk % 8) // 4
                 for kk in range(16))


def gemm_layout_f32(cin, k):
  """K layout of the f32 route's 3xTF32 kernel: ``(cin_pad, chunk, kp)``.

  The halo is staged in chunks of ``chunk`` channels: one chunk of Cin
  rounded up to 16 for Cin ≤ 16; else chunks of 32 for k3 (9·32 = 288 of
  K, nine whole 32-wide stages) and of 16 for k4 (16·16 = 256, eight).
  K runs over (chunk, tap, 16 channels in ``F32_PERM`` order), k·k·cin_pad
  values, padded to ``kp``, a multiple of 32 (``csrc/conv_f32.cu``
  computes the same and checks ``kp``).
  """
  chunk = 16 if (cin <= 16 or k == 4) else 32
  cin_pad = -(-cin // chunk) * chunk
  return cin_pad, chunk, -(-(k * k * cin_pad) // 32) * 32


def tf32_split(v):
  """f32 ``v`` → ``(big, small)``: ``big`` is v rounded to the nearest
  tf32 (ties away from zero, as ``cvt.rna.tf32.f32``) with its low 13 bits
  cleared, ``small`` the same rounding of ``v - big``. ``big + small`` is
  within 2^-22 of v's magnitude, where ``big`` alone is within 2^-11."""
  def rna(t):
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)
  v = v.float()
  big = rna(v)
  return big, rna(v - big)


def pack_weights_f32(kernel):
  """f32 HWIO weights → the 3xTF32 kernel's ``(2·Cout, kp)`` operand:
  rows 0 .. Cout - 1 hold the big parts of ``tf32_split``, rows Cout ..
  2·Cout - 1 the small parts, each K-major in the K order of
  ``gemm_layout_f32``, zeros in the padding."""
  k, _, cin, cout = kernel.shape
  cin_pad, chunk, kp = gemm_layout_f32(cin, k)
  w = F.pad(kernel.float(), (0, 0, 0, cin_pad - cin))
  # channel 4t + 2s + h of a 16-group goes to K position 8s + 4h + t
  # (F32_PERM), a permute of its (t, s, h) axes to (s, h, t)
  w = w.reshape(k * k, cin_pad // chunk, chunk // 16, 4, 2, 2, cout)
  w = w.permute(6, 1, 0, 2, 4, 5, 3)
  w = F.pad(w.reshape(cout, k * k * cin_pad), (0, kp - k * k * cin_pad))
  return torch.cat(tf32_split(w)).contiguous()


def conv_route(cin, cout, dtype):
  """The kernel route of a layer, decided by its shape and dtype alone."""
  if dtype == torch.float32:
    if cin < 8:
      return 'direct'                    # exact FMAs, the stem
    return '3xtf32' if cin % 4 == 0 else '3xtf32, 4-byte staging'
  if cin % 8 == 0:
    return 'wgmma'                       # 16-byte cp.async halo
  return 'wgmma, 4-byte staging' if cin % 2 == 0 else 'wgmma, gathered halo'


@functools.lru_cache(maxsize=None)
def _lib():
  lib = native.library('conv_chain')
  lib.conv_layer.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 +
                             [ctypes.c_float, ctypes.c_void_p])
  lib.conv_layer.restype = ctypes.c_int
  return lib


@functools.lru_cache(maxsize=None)
def _lib_f32():
  lib = native.library('conv_f32')
  lib.conv_layer_f32.argtypes = (
      [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2 +
      [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
  lib.conv_layer_f32.restype = ctypes.c_int
  return lib


def _check_layer(x, layer, pad_mode, who):
  """Raise on what the conv kernels do not take; returns (B, H, W, Cin,
  k, Cout)."""
  if x.device.type != 'cuda':
    raise ValueError('{} takes CUDA tensors, got {}'.format(who, x.device))
  if not x.is_contiguous() or x.ndim != 4:
    raise ValueError('{}: x must be a contiguous NHWC tensor'.format(who))
  if pad_mode not in PAD_MODES:
    raise ValueError('unknown pad mode {!r}'.format(pad_mode))
  b, h, w, cin = x.shape
  kh, kw, kcin, cout = layer.kernel.shape
  if kh != kw or kh not in (3, 4) or kcin != cin:
    raise ValueError('{}: kernel {} does not fit input {} (k must be 3 or '
                     '4)'.format(who, tuple(layer.kernel.shape),
                                 tuple(x.shape)))
  if not 1 <= b <= 65535:
    raise ValueError('{} takes 1 to 65535 images, got {}'.format(who, b))
  if pad_mode == 'reflection' and min(h, w) < 2:
    raise ValueError('reflection padding needs images of at least 2x2')
  return b, h, w, cin, kh, cout


def conv_layer_f32_cuda(x, layer, pad_mode='reflection'):
  """Launch the f32 conv-layer kernel (csrc/conv_f32.cu) on a CUDA f32
  tensor: the 3xTF32 route for Cin ≥ 8, the direct route below."""
  if x.dtype != torch.float32:
    raise ValueError('conv_layer_f32_cuda takes float32, got {}'.format(
        x.dtype))
  b, h, w, cin, k, cout = _check_layer(x, layer, pad_mode,
                                       'conv_layer_f32_cuda')
  if x.data_ptr() % 16:          # the kernel reads 16 bytes at a time
    x = x.clone()
  with profiling.span('csmri.unet.prepare'):
    kernel, bias = pad_cout(layer.kernel.to(x.device), layer.bias)
    kernel = kernel.float().contiguous() if cin < 8 else \
        pack_weights_f32(kernel)
  # The kernel counts tiles, positions and channel offsets within an image
  # in int32 and offsets whole images in size_t.
  if h * w * max(cin, bias.shape[0]) >= 2 ** 31:
    raise ValueError('conv_layer_f32_cuda: a {}x{} image with {} channels '
                     'is over the int32 index range'.format(
                         h, w, max(cin, bias.shape[0])))
  kp = 0 if cin < 8 else kernel.shape[1]
  if kernel.data_ptr() % 16:
    kernel = kernel.clone()
  cout_pad = bias.shape[0]
  y = torch.empty((b, h, w, cout_pad), device=x.device, dtype=x.dtype)
  leak = layer.leakiness
  with torch.cuda.device(x.device):
    status = _lib_f32().conv_layer_f32(
        native.ptr(x), native.ptr(kernel), kp, native.ptr(bias),
        native.ptr(y), b, h, w, cin, cout_pad, k, PAD_MODES[pad_mode],
        int(leak is not None), float(leak or 0.0), native.stream_of(x))
  native.check(status, 'conv_layer_f32')
  conv_layer_f32_cuda.launches += 1
  return y if cout_pad == cout else y[..., :cout].contiguous()


conv_layer_f32_cuda.launches = 0


def conv_layer_cuda(x, layer, pad_mode='reflection'):
  """Launch the conv-layer kernel on a CUDA tensor: csrc/conv_chain.cu for
  bf16, ``conv_layer_f32_cuda`` for f32."""
  if x.dtype not in _DTYPES:
    raise ValueError('conv_layer_cuda takes float32 or bfloat16, got '
                     '{}'.format(x.dtype))
  if x.dtype == torch.float32:
    y = conv_layer_f32_cuda(x, layer, pad_mode)
    conv_layer_cuda.launches += 1
    return y
  b, h, w, cin, kh, cout = _check_layer(x, layer, pad_mode,
                                        'conv_layer_cuda')
  if x.data_ptr() % 16:          # the kernel reads 16 bytes at a time
    x = x.clone()
  with profiling.span('csmri.unet.prepare'):
    kernel, bias = pad_cout(layer.kernel.to(x.device), layer.bias)
    kernel = pack_weights(kernel)
  kp = kernel.shape[1]
  if kernel.data_ptr() % 16:
    kernel = kernel.clone()
  cout_pad = bias.shape[0]
  y = torch.empty((b, h, w, cout_pad), device=x.device, dtype=x.dtype)
  leak = layer.leakiness
  with torch.cuda.device(x.device):
    status = _lib().conv_layer(
        native.ptr(x), native.ptr(kernel), native.ptr(bias), native.ptr(y),
        b, h, w, cin, cout_pad, kh, kp, PAD_MODES[pad_mode],
        int(leak is not None), float(leak or 0.0), native.stream_of(x))
  native.check(status, 'conv_layer')
  conv_layer_cuda.launches += 1
  return y if cout_pad == cout else y[..., :cout].contiguous()


conv_layer_cuda.launches = 0


def _layer_args(layer):
  return (layer.kernel, layer.bias,
          None if layer.leakiness is None else float(layer.leakiness))


def _define_conv_op(name, dtype):
  """``csmri::<name>``: one float layer of ``dtype`` (K2)."""

  @torch.library.custom_op('csmri::' + name, mutates_args=(),
                           device_types='cpu')
  def op(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
         leakiness: Optional[float], pad_mode: str) -> torch.Tensor:
    return conv_layer_plain(x, ChainLayer(kernel, bias, leakiness), pad_mode)

  @op.register_kernel('cuda')
  def _(x, kernel, bias, leakiness, pad_mode):
    if x.dtype != dtype:
      raise ValueError('csmri::{} takes {}, got {}'.format(name, dtype,
                                                          x.dtype))
    return conv_layer_cuda(x, ChainLayer(kernel, bias, leakiness), pad_mode)

  @op.register_fake
  def _(x, kernel, bias, leakiness, pad_mode):
    return x.new_empty(tuple(x.shape[:3]) + (kernel.shape[3],))

  return op


conv_bf16_op = _define_conv_op('conv_bf16', torch.bfloat16)
conv_f32_op = _define_conv_op('conv_f32', torch.float32)
_CONV_OPS = {torch.bfloat16: conv_bf16_op, torch.float32: conv_f32_op}


def _needs_grad(*tensors):
  return torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors)


def conv_layer(x, layer, pad_mode='reflection'):
  """One chain layer: the kernel on CUDA, the plain version on CPU;
  without a gradient, through its custom op."""
  op = _CONV_OPS.get(x.dtype)
  if op is not None and not _needs_grad(x, layer.kernel, layer.bias):
    return op(x, *_layer_args(layer), pad_mode)
  if x.device.type == 'cpu':
    return conv_layer_plain(x, layer, pad_mode)
  return conv_layer_cuda(x, layer, pad_mode)


def fused_conv_chain(x, chain, *, pad_mode='reflection'):
  """Run a chain of SAME stride-1 convs (+LeakyReLU).

  x: (B, H, W, Cin) in the compute dtype. Returns (B, H, W, Cout_last) in
  x.dtype. On CUDA each layer is one kernel launch.
  """
  if pad_mode not in PAD_MODES:
    raise ValueError('unknown pad mode {!r}'.format(pad_mode))
  _check_channels(x, chain)
  for layer in chain:
    x = conv_layer(x, layer, pad_mode)
  return x


def _check_channels(x, chain):
  cin = x.shape[-1]
  for layer in chain:
    if layer.kernel.shape[2] != cin:
      raise ValueError('chain channels do not match: {} into a layer of '
                       'kernel {}'.format(cin, tuple(layer.kernel.shape)))
    cin = layer.kernel.shape[3]


def chain_forward(x, chain, *, pad_mode='reflection'):
  """Run a conv chain with every layer through the conv kernel.

  The JAX package fuses only a suffix of Cin >= 128 layers (its
  ``min_cin``/``need_cin`` policy, measured on a TPU v5e); the math is the
  same either way, and the H100's policy is left to measurements.
  """
  return fused_conv_chain(x, chain, pad_mode=pad_mode)


# --- int8 serving mode -------------------------------------------------------

# Which layers of a chain the int8 mode quantizes: the JAX package's rule
# (``conv_pallas.py:397-431``, applied by ``quantize.py:88-99``), kept here
# because it decides the output, not because the card needs it. It is the
# longest suffix of layers the TPU kernel packs (``layer_fusable``), trimmed
# from the front until the TPU kernel's VMEM estimate fits its budget. The
# numbers below are the TPU kernel's layout (128 lanes, pixel groups of P),
# not the H100's; the chain's prefix runs in the float compute dtype.
_LANES = 128
_VMEM_BUDGET = 64 * 1024 * 1024


def _pick_p(cin, width):
  """Pixels per TPU lane group: the smallest P ≥ ceil(128 / Cin) that
  divides the width."""
  p = max(1, -(-_LANES // cin))
  while width % p:
    p += 1
  return p


def layer_fusable(cin, cout, k, width, height):
  """Whether the TPU kernel would pack this conv (JAX ``layer_fusable``):
  k ∈ {3, 4}, even height, P = ceil(128 / Cin) ≤ 4 dividing the width,
  W / P a multiple of 16, P·Cout a multiple of 128 and an even slab row
  count."""
  if k not in (3, 4) or height % 2:
    return False
  p = max(1, -(-_LANES // cin))
  if p > 4 or width % p:
    return False
  g = width // p
  if g % 16 or (p * cout) % _LANES:
    return False
  return ((height + k - 1) * g) % 2 == 0


def _vmem_estimate(chain, width, height):
  """The TPU kernel's per-image VMEM estimate of an int8 chain (JAX
  ``_vmem_estimate`` with itemsize 1): per layer, six int8 slabs and two
  f32 accumulators. P is made non-increasing along the chain, as the TPU
  kernel's ``_plan`` does."""
  ps = [_pick_p(layer.kernel.shape[2], width) for layer in chain]
  for i in range(len(ps) - 2, -1, -1):
    ps[i] = max(ps[i], ps[i + 1])
  total = 0
  for layer, p in zip(chain, ps):
    k, _, cin, cout = layer.kernel.shape
    gp = (width // p) * p
    total += 6 * (height + k - 1) * gp * cin + 2 * height * gp * cout * 4
  return total


def int8_suffix_start(chain, height, width):
  """Index of the first quantized layer of ``chain`` on an H×W input
  (``len(chain)`` if none is)."""
  n = len(chain)
  start = n
  for i in range(n - 1, -1, -1):
    k, _, cin, cout = chain[i].kernel.shape
    if not layer_fusable(cin, cout, k, width, height):
      break
    start = i
  while start < n and _vmem_estimate(chain[start:], width,
                                     height) > _VMEM_BUDGET:
    start += 1
  return start


# amax → scale factor: f32(1/127). XLA turns the JAX package's
# ``amax / 127.0`` into a multiply by this reciprocal under jit.
INV_127 = 1.0 / 127.0


def _epilogue(acc, act_scale, layer):
  """f32 dequant + bias + LeakyReLU of int32-valued NHWC sums, rounded as
  the kernel rounds: the scale product first (f32), then
  ``fma(f32(acc), scale, bias)`` with one rounding. The JAX package's
  ``acc * scale + bias`` compiles to that fused multiply-add on XLA's CPU
  backend; the float64 product of two f32 values is exact, so rounding the
  float64 sum once to f32 gives the FMA's result.
  """
  scale = layer.w_scale.float()[None, :] * act_scale.float()[:, None]
  y = acc.float().double() * scale.double()[:, None, None, :]
  if layer.bias is not None:
    y = y + layer.bias.double()
  y = y.float()
  if layer.leakiness is not None:
    y = layers.leaky_relu(y, layer.leakiness)
  return y


def conv_layer_int8_plain(x, act_scale, layer, pad_mode='reflection',
                          out_dtype=torch.float32, want_amax=False):
  """One quantized layer in plain PyTorch.

  x: (B, H, W, Cin) int8; act_scale: (B,) f32; ``layer.kernel`` int8 HWIO
  with ``w_scale``. Returns ``(y, amax)``: y (B, H, W, Cout) in
  ``out_dtype``, and the per-image max |y| (B,) f32 if ``want_amax``, else
  None. The conv runs in float64, where the int8 products' sums (at most
  127²·k²·Cin) are exact, as the kernel's int32 sums are.
  """
  k = layer.kernel.shape[0]
  weight = layer.kernel.double().permute(3, 2, 0, 1)
  acc = F.conv2d(layers.tile_pad(x.double().permute(0, 3, 1, 2), k,
                                 pad_mode), weight).permute(0, 2, 3, 1)
  y = _epilogue(acc, act_scale, layer)
  amax = y.abs().amax(dim=(1, 2, 3)) if want_amax else None
  return y.to(out_dtype).contiguous(), amax


def requant_plain(y, amax):
  """Per-image requantization of f32 NHWC ``y`` to int8 for the next
  layer: ``round(y · 127 / max(amax, 1e-8))`` (half to even), clipped to
  ±127. Returns ``(x_int8, act_scale)`` with act_scale = max(amax, 1e-8) ·
  f32(1/127)."""
  amax = amax.float().clamp_min(1e-8)
  # a tensor numerator: ``127.0 / amax`` would be amax.reciprocal() · 127,
  # two roundings, where the kernel and the JAX package divide once
  s = torch.full_like(amax, 127.0) / amax
  xi = torch.clamp(torch.round(y * s[:, None, None, None]), -127, 127)
  return xi.to(torch.int8), amax * INV_127


def gemm_layout_int8(cin, k):
  """K layout of the int8 kernel: ``(cin_pad, chunk, kp)``.

  The halo is staged in chunks of ``chunk`` channels, one 16-byte plane per
  16 of them; K runs over (chunk, tap, channel in chunk), k·k·cin_pad
  values, padded to ``kp``, a multiple of the 128-wide K stage. k4 layers
  take chunks of 32 (16·32 = 4 stages). A k3 chunk of 32 spans 288 of K,
  not whole stages, so k3 layers take one chunk of Cin rounded up to 32,
  64 or 128 (the last stage partial), or chunks of 128 (9 stages each).
  ``csrc/conv_int8.cu`` computes the same and checks ``kp``.
  """
  chunk = 32 if (k == 4 or cin <= 32) else 64 if cin <= 64 else 128
  cin_pad = -(-cin // chunk) * chunk
  return cin_pad, chunk, -(-(k * k * cin_pad) // 128) * 128


def pack_weights_int8(kernel):
  """int8 HWIO weights → the int8 kernel's K-major ``(Cout, kp)`` operand
  in the K order of ``gemm_layout_int8``: s8 ``wgmma`` reads B only
  K-major."""
  return pack_weights(kernel, torch.int8, gemm_layout_int8)


@functools.lru_cache(maxsize=None)
def _lib_int8():
  lib = native.library('conv_int8')
  lib.conv_layer_int8.argtypes = (
      [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4 +
      [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
  lib.conv_layer_int8.restype = ctypes.c_int
  lib.requant_int8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
      ctypes.c_void_p]
  lib.requant_int8.restype = ctypes.c_int
  return lib


def conv_layer_int8_cuda(x, act_scale, layer, pad_mode='reflection',
                         out_dtype=torch.float32, want_amax=False):
  """Launch the int8 conv-layer kernel (csrc/conv_int8.cu) on a CUDA
  tensor; same contract as ``conv_layer_int8_plain``."""
  if x.device.type != 'cuda':
    raise ValueError('conv_layer_int8_cuda takes CUDA tensors, got '
                     '{}'.format(x.device))
  if x.dtype != torch.int8 or x.ndim != 4 or not x.is_contiguous():
    raise ValueError('conv_layer_int8_cuda: x must be a contiguous NHWC '
                     'int8 tensor')
  if pad_mode not in PAD_MODES:
    raise ValueError('unknown pad mode {!r}'.format(pad_mode))
  if out_dtype not in _DTYPES:
    raise ValueError('conv_layer_int8_cuda writes float32 or bfloat16, got '
                     '{}'.format(out_dtype))
  b, h, w, cin = x.shape
  kh, kw, kcin, cout = layer.kernel.shape
  if (layer.kernel.dtype != torch.int8 or layer.w_scale is None or
      kh != kw or kh not in (3, 4) or kcin != cin):
    raise ValueError('conv_layer_int8_cuda: needs an int8 kernel with '
                     'w_scale, k 3 or 4, fitting input {}; got {} {}'.format(
                         tuple(x.shape), layer.kernel.dtype,
                         tuple(layer.kernel.shape)))
  if cin % 32 or cout % 16 or not 1 <= b <= 65535:
    raise ValueError('conv_layer_int8_cuda takes Cin a multiple of 32, Cout '
                     'a multiple of 16 and 1 to 65535 images, got Cin {}, '
                     'Cout {}, {} images'.format(cin, cout, b))
  if act_scale.shape != (b,):
    raise ValueError('conv_layer_int8_cuda: act_scale must be (B,)')
  if pad_mode == 'reflection' and min(h, w) < 2:
    raise ValueError('reflection padding needs images of at least 2x2')
  if x.data_ptr() % 16:           # the kernel stages x 16 bytes at a time
    x = x.clone()
  dev = x.device
  wt = pack_weights_int8(layer.kernel.to(dev))
  f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
  w_scale = f32(layer.w_scale)
  bias = torch.zeros(cout, device=dev) if layer.bias is None else \
      f32(layer.bias)
  y = torch.empty((b, h, w, cout), device=dev, dtype=out_dtype)
  # float bits of max |y| per image; non-negative floats order like them
  amax = torch.zeros(b, device=dev, dtype=torch.int32) if want_amax else None
  leak = layer.leakiness
  with torch.cuda.device(dev):
    status = _lib_int8().conv_layer_int8(
        native.ptr(x), native.ptr(f32(act_scale)), native.ptr(wt),
        wt.shape[1], native.ptr(w_scale), native.ptr(bias), native.ptr(y),
        native.ptr(amax) if want_amax else None, b, h, w, cin, cout, kh,
        PAD_MODES[pad_mode], _DTYPES[out_dtype], int(leak is not None),
        float(leak or 0.0), native.stream_of(x))
  native.check(status, 'conv_layer_int8')
  conv_layer_int8_cuda.launches += 1
  return y, (amax.view(torch.float32) if want_amax else None)


conv_layer_int8_cuda.launches = 0


def requant_cuda(y, amax):
  """Launch the requant kernel (csrc/conv_int8.cu) on a CUDA tensor; same
  contract as ``requant_plain``."""
  if y.device.type != 'cuda' or y.dtype != torch.float32:
    raise ValueError('requant_cuda takes a float32 CUDA tensor, got {} '
                     '{}'.format(y.dtype, y.device))
  if y.ndim != 4 or not y.is_contiguous() or y.numel() % (4 * y.shape[0]):
    raise ValueError('requant_cuda: y must be a contiguous NHWC tensor of '
                     'a multiple of 4 values per image')
  b = y.shape[0]
  if amax.shape != (b,) or amax.dtype != torch.float32:
    raise ValueError('requant_cuda: amax must be (B,) float32')
  amax = amax.to(y.device).contiguous()
  xi = torch.empty(y.shape, device=y.device, dtype=torch.int8)
  scale = torch.empty(b, device=y.device, dtype=torch.float32)
  with torch.cuda.device(y.device):
    status = _lib_int8().requant_int8(
        native.ptr(y), native.ptr(amax), native.ptr(xi), native.ptr(scale),
        b, y.numel() // b, native.stream_of(y))
  native.check(status, 'requant_int8')
  requant_cuda.launches += 1
  return xi, scale


requant_cuda.launches = 0


@torch.library.custom_op('csmri::conv_int8', mutates_args=(),
                         device_types='cpu')
def conv_int8_op(x: torch.Tensor, act_scale: torch.Tensor,
                 kernel: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], leakiness: Optional[float],
                 pad_mode: str, out_dtype: torch.dtype,
                 want_amax: bool) -> Tuple[torch.Tensor, torch.Tensor]:
  """K3: the plain version on the CPU; ``(y, amax)``, amax empty unless
  ``want_amax``."""
  y, amax = conv_layer_int8_plain(
      x, act_scale, ChainLayer(kernel, bias, leakiness, w_scale), pad_mode,
      out_dtype, want_amax)
  return y, amax if want_amax else act_scale.new_empty(0)


@conv_int8_op.register_kernel('cuda')
def _conv_int8_op_cuda(x, act_scale, kernel, w_scale, bias, leakiness,
                       pad_mode, out_dtype, want_amax):
  y, amax = conv_layer_int8_cuda(
      x, act_scale, ChainLayer(kernel, bias, leakiness, w_scale), pad_mode,
      out_dtype, want_amax)
  return y, amax if want_amax else act_scale.new_empty(0)


@conv_int8_op.register_fake
def _conv_int8_op_fake(x, act_scale, kernel, w_scale, bias, leakiness,
                       pad_mode, out_dtype, want_amax):
  y = x.new_empty(tuple(x.shape[:3]) + (kernel.shape[3],), dtype=out_dtype)
  return y, x.new_empty((x.shape[0] if want_amax else 0,),
                        dtype=torch.float32)


@torch.library.custom_op('csmri::requant', mutates_args=(),
                         device_types='cpu')
def requant_op(y: torch.Tensor,
               amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """The requant kernel: the plain version on the CPU."""
  return requant_plain(y, amax)


@requant_op.register_kernel('cuda')
def _requant_op_cuda(y, amax):
  return requant_cuda(y, amax)


@requant_op.register_fake
def _requant_op_fake(y, amax):
  return (y.new_empty(y.shape, dtype=torch.int8),
          amax.new_empty(amax.shape, dtype=torch.float32))


def conv_layer_int8(x, act_scale, layer, pad_mode='reflection',
                    out_dtype=torch.float32, want_amax=False):
  """One quantized layer through ``csmri::conv_int8``: the kernel on CUDA,
  the plain version on CPU."""
  kernel, bias, leakiness = _layer_args(layer)
  y, amax = conv_int8_op(x, act_scale, kernel, layer.w_scale, bias,
                         leakiness, pad_mode, out_dtype, want_amax)
  return y, amax if want_amax else None


def requant(y, amax):
  """Requantize for the next layer through ``csmri::requant``: the kernel
  on CUDA, plain on CPU."""
  return requant_op(y, amax)


def fused_conv_chain_int8(x_int8, act_scale, qlayers, pad_mode='reflection',
                          out_dtype=torch.bfloat16):
  """Run a quantized chain: int8 (B, H, W, Cin) input with per-image
  ``act_scale`` (B,), int8 layers with ``w_scale``. Intermediate layers
  write f32 and their per-image amax, then requantize; the last writes
  ``out_dtype``. On CUDA that is one conv launch per layer and one requant
  launch between layers."""
  if pad_mode not in PAD_MODES:
    raise ValueError('unknown pad mode {!r}'.format(pad_mode))
  _check_channels(x_int8, qlayers)
  if any(layer.w_scale is None for layer in qlayers):
    raise ValueError('fused_conv_chain_int8 needs w_scale on every layer')
  x, scale = x_int8, act_scale
  for i, layer in enumerate(qlayers):
    if i + 1 == len(qlayers):
      return conv_layer_int8(x, scale, layer, pad_mode, out_dtype)[0]
    y, amax = conv_layer_int8(x, scale, layer, pad_mode, torch.float32,
                              want_amax=True)
    x, scale = requant(y, amax)
